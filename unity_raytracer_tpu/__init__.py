"""unity_raytracer_tpu — a differentiable ray-tracing framework on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
``vectorized-runner/unity-raytracer`` (Unity C#, single-threaded, CPU):

* the reference's per-pixel recursive ``Shade()`` loop
  (reference: Demo-RayTracing/RayTracingSetup.cs:304-366) becomes a batched
  wavefront bounce chain (`ops.render`),
* its brute-force nearest-hit query (Data/Objects/Scene.cs:43-122) becomes
  masked SoA intersection kernels (`ops.intersect`) plus a completed BVH
  (`ops.bvh` — the reference's BVH was unfinished, Data/Collision/BVH.cs:79),
* everything is differentiable end-to-end (`ops.softvis`, `fit`),
* and it scales over a device mesh via `parallel` (shard_map + collectives);
  its accelerator is an NVIDIA GPU (`ops/backend.py`).

Import alias convention::

    import unity_raytracer_tpu as urt
"""

from unity_raytracer_tpu.version import __version__

__all__ = ["__version__"]
