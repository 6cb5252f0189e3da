"""The process's clock from its start, the card's description, and the
guard on modules that a run of the port may not load."""

from __future__ import annotations

import os
import subprocess
import sys
import time

# top-level module names a run may not hold (compared whole: the port's
# package name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "optax", "pointnet2_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from /proc (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start


class Clock:
    """Wall seconds since the process started (``time.time`` based, so
    that ranks of one host share it)."""

    def __init__(self):
        self.start = time.time() - process_age_s()

    def now(self) -> float:
        return time.time() - self.start


def banned_modules(modules=None) -> list[str]:
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names.intersection(BANNED))


def power_limit() -> str:
    """``name, power.limit`` of the cards as nvidia-smi gives them, or
    "" where it cannot tell."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().replace("\n", "; ")


def describe(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
