"""Profiling + device accounting.

The reference has zero instrumentation (no Profiler markers, no timers —
SURVEY.md §5.1; only gizmo drawing). Here:

* `timed` — block_until_ready-bracketed wall clock;
* `trace` — context manager around ``jax.profiler.trace`` (XProf/
  TensorBoard dumps);
* `device_info` / `card` — what a measurement ran on (JAX's view and
  ``nvidia-smi``'s name and power limit);
* `device_hbm_gbps` — the published HBM peak of the device, for
  roofline context (``None`` for a device without one).
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, Optional

import jax


@dataclass
class Timing:
    wall_s: float
    runs: int

    @property
    def per_run_s(self) -> float:
        return self.wall_s / max(self.runs, 1)


def timed(fn: Callable, *args, repeats: int = 3, warmup: int = 1,
          **kw) -> Timing:
    """Best-of-N wall clock with device sync; warmup runs compile."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kw))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        best = min(best, time.perf_counter() - t0)
    return Timing(wall_s=best, runs=1)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace scope: view with TensorBoard/XProf."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_info() -> dict:
    """The default device as JAX reports it."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card() -> Optional[str]:
    """``name, power.limit`` of the first GPU from nvidia-smi, or None
    where there is no nvidia-smi. A card set below its maximum power
    runs slower under load, so this goes beside every timing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


# Published HBM bandwidth (GB/s) by jax device_kind — NVIDIA H100 SXM
# data sheet. A device not listed has no roofline (null), never a guess.
_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def device_hbm_gbps() -> Optional[float]:
    return _HBM_GBPS.get(jax.devices()[0].device_kind)
