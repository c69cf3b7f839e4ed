"""Multi-host process bootstrap (SURVEY.md §5.8).

The reference has no networking of any kind; the JAX equivalent is
``jax.distributed.initialize``: every host process dials the coordinator,
after which ``jax.devices()`` spans every host's cards and the exact same
``shard_map``/``pjit`` code from parallel/shard.py runs across hosts —
collectives lower to NCCL over NVLink within a host and the network
across hosts.

On single-host environments (including the CPU test suite) the
functions are no-ops, so every entry point can call ``maybe_initialize``
unconditionally.

Env contract (standard JAX multi-process variables, or explicit args):
  JAX_COORDINATOR_ADDRESS   host:port of process 0
  JAX_NUM_PROCESSES         world size
  JAX_PROCESS_ID            this process's rank
"""

from __future__ import annotations

import os
from typing import Optional

_INITIALIZED = False


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join the multi-host runtime if configured; returns True if joined.

    Args override the environment; with neither present this is a no-op
    (single-host). Safe to call more than once.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if not coordinator_address:
        return False
    num_processes = int(num_processes
                        or os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = int(process_id
                     if process_id is not None
                     else os.environ.get("JAX_PROCESS_ID", "0"))
    import jax
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    _INITIALIZED = True
    return True


def world() -> dict:
    """Process/device topology summary for logs."""
    import jax
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
