"""CLI: python -m parameter_server_tpu_torch.benchmarks [name ...] [--smoke] [--device cpu]

Inside a launcher's world (``PS_COORDINATOR_ADDRESS``, ``PS_NUM_PROCESSES``,
``PS_PROCESS_ID`` on every rank, e.g. ``parallel/launch.run_world(main, N,
args=(argv,))``) every rank runs the same benchmarks: the stores' and the
serving probes' on the world's ``N x 1`` mesh, ``learning`` and
``consistency`` on ``(N/2) x 2`` (``components._start``), and rank 0
prints the lines."""

from __future__ import annotations

import argparse
import sys

from . import REGISTRY
from . import components  # noqa: F401 — populates REGISTRY

def reset_process_state() -> None:
    """What one benchmark may leave behind that the next must not see:
    the postoffice (its customers, registry, span sink, history store,
    learning planes and device inventory) and the armed fault points."""
    from ..system import faults
    from ..system.postoffice import Postoffice

    Postoffice.reset()
    faults.reset()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "names", nargs="*",
        help=f"benchmarks to run (default all): {', '.join(sorted(REGISTRY))}",
    )
    ap.add_argument("--smoke", action="store_true", help="tiny quick run")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    names = args.names or sorted(REGISTRY)
    for name in names:
        if name not in REGISTRY:
            ap.error(f"unknown benchmark {name!r}; have {sorted(REGISTRY)}")
    from ..device import resolve

    try:
        device = resolve(args.device)
    except RuntimeError as e:
        print(f"benchmarks: {e}", file=sys.stderr)
        return 1
    for name in names:
        reset_process_state()
        REGISTRY[name](args.smoke, device=device)
    reset_process_state()
    return 0


if __name__ == "__main__":
    sys.exit(main())
