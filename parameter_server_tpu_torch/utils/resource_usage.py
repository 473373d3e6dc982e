"""Host resource sampling (ref ``src/util/resource_usage.h``).

Reads /proc to report cpu%, rss, and io counters for heartbeat/dashboard —
same data the reference's ResUsage pulls for HeartbeatInfo.
"""

from __future__ import annotations

import dataclasses
import os
import time


@dataclasses.dataclass
class Usage:
    timestamp: float
    rss_mb: float
    vm_mb: float
    cpu_seconds: float
    host_total_cpu_seconds: float
    load1: float


def _read_status() -> tuple[float, float]:
    rss = vm = 0.0
    try:
        with open(f"/proc/{os.getpid()}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = float(line.split()[1]) / 1024.0
                elif line.startswith("VmSize:"):
                    vm = float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return rss, vm


def sample() -> Usage:
    rss, vm = _read_status()
    cpu = time.process_time()
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()[1:8]
        host_cpu = sum(int(x) for x in parts) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError):
        host_cpu = 0.0
    try:
        load1 = os.getloadavg()[0]
    except OSError:
        load1 = 0.0
    return Usage(
        timestamp=time.time(),
        rss_mb=rss,
        vm_mb=vm,
        cpu_seconds=cpu,
        host_total_cpu_seconds=host_cpu,
        load1=load1,
    )
