"""Device-mesh construction.

The reference has zero parallelism of any kind (single C# thread; SURVEY.md
§2 preamble). The scaling model: a `jax.sharding.Mesh` over the
devices, with two meaningful logical axes for a ray tracer —

* ``dp``: the ray/pixel axis (image tiles). Embarrassingly parallel; the
  primary scaling axis (BASELINE config 5). This doubles as the "sequence
  parallel" axis: the wavefront's N_rays dimension is the sequence.
* ``tp``: the scene axis (mesh triangles sharded across devices) for scenes
  too large to replicate; partial nearest-hits combine with a lexicographic
  (t, id) min (collectives.py).

Pipeline (bounce-stage) and expert parallelism have no payoff for this
workload — documented decision, SURVEY.md §2.2.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "dp"
SCENE_AXIS = "tp"


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with axes (dp, tp). Default: all devices on dp, tp=1."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    dp, tp = shape
    if dp * tp != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, (RAY_AXIS, SCENE_AXIS))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Rays [N, ...] sharded over dp (and tp if present, for max split)."""
    return NamedSharding(mesh, P(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
