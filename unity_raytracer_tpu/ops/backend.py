"""The one place that maps the JAX platform to a BVH walk.

``RenderConfig.kernel`` names the walk:

* ``'auto'`` — decided by the platform: ``gpu`` runs the compiled Pallas
  walk kernel (``ops/pallas/walk.py``, Triton route), ``cpu`` runs the XLA
  loop (``ops/bvh._walk_xla``); any other platform is an error.
* ``'xla'`` — the XLA loop on any platform (the reference the kernel is
  compared with).
* ``'interpret'`` — the walk kernel in the Pallas interpreter, for tests
  and the CPU dry run. Never chosen from the platform.
"""

from __future__ import annotations

from typing import Tuple

import jax

KERNELS = ("auto", "xla", "interpret")


class UnsupportedPlatformError(RuntimeError):
    """The default JAX platform has no BVH walk."""


def walk_route(kernel: str = "auto") -> Tuple[str, bool]:
    """``kernel`` -> ``(route, interpret)`` with route ``'xla'`` or
    ``'walk'`` (the Pallas kernel)."""
    if kernel == "xla":
        return "xla", False
    if kernel == "interpret":
        return "walk", True
    if kernel != "auto":
        raise ValueError(f"unknown kernel {kernel!r}; have {KERNELS}")
    platform = jax.default_backend()
    if platform == "gpu":
        return "walk", False
    if platform == "cpu":
        return "xla", False
    raise UnsupportedPlatformError(
        f"no BVH walk for JAX platform {platform!r} (supported: gpu, cpu)")
