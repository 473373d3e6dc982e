"""Environment settings of a node (the reference's ``src/system/env.{h,cc}``).

Counterpart of ``parameter_server_tpu/system/env.py``: one dataclass
resolved from the same ``PS_*`` environment variables, with the same
defaults. Server and worker counts above one take a mesh of ranks, one
process a position (``Postoffice.start``, ``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Env:
    num_servers: int = 1
    num_workers: int = 0  # 0 = all remaining devices
    coordinator_address: str = ""
    process_id: int = 0
    num_processes: int = 1
    verbose: int = 0

    @staticmethod
    def from_env() -> "Env":
        return Env(
            num_servers=int(os.environ.get("PS_NUM_SERVERS", "1")),
            num_workers=int(os.environ.get("PS_NUM_WORKERS", "0")),
            coordinator_address=os.environ.get("PS_COORDINATOR_ADDRESS", ""),
            process_id=int(os.environ.get("PS_PROCESS_ID", "0")),
            num_processes=int(os.environ.get("PS_NUM_PROCESSES", "1")),
            verbose=int(os.environ.get("PS_VERBOSE", "0")),
        )
