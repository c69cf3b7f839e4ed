"""Frozen config dataclasses (static, hashable — safe as jit static args).

The reference's "config system" is serialized Unity scene YAML + inspector
fields (Demo-RayTracing/RayTracing.unity:346-364, RayTracingSetup.cs:21-36).
Here configs are code: frozen dataclasses, overridable from the CLI.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class DiffConfig:
    """Differentiability knobs.

    ``soft_shadow_temp > 0`` relaxes the hard shadow test
    (hitDist^2 < lightDist^2, reference RayTracingSetup.cs:337-345) into a
    sigmoid so silhouette gradients exist. With ``straight_through=True`` the
    forward value stays exactly hard (parity preserved) while the backward
    pass sees the soft function — see ops/shade.py (_soft_or_hard_vis) and
    ops/render.py (_local_radiance).
    """

    soft_shadow_temp: float = 0.0
    soft_hit_temp: float = 0.0
    straight_through: bool = True


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters.

    ``max_bounces`` caps mirror/refraction recursion depth like
    ``MaxReflectionBounces`` (RayTracingSetup.cs:23,358): a ray segment at
    depth == max_bounces shades locally but spawns no children.
    ``background`` is on the display 0-1 scale (Unity Color), multiplied by
    255 onto the radiance scale internally (Rgb.cs:17).
    """

    max_bounces: int = 0
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    mode: str = "auto"          # 'scan' | 'tree' | 'auto'
    ray_chunk: Optional[int] = None  # rays per chunk (None = all at once)
    use_bvh: bool = False
    kernel: str = "auto"             # BVH walk: 'auto' | 'xla' |
    #                                  'interpret' (ops/backend.py)
    block_size: int = 32        # pixel-block lane order (utils/swizzle.py,
    #                             camera.generate_rays_blocks); <=1 keeps
    #                             row-major lane order
    bvh_leaf: int = 4           # BVH leaf capacity (triangles per leaf;
    #                             <= 15, the walk kernel's packed count).
    #                             Bigger leaves shrink the interior tree
    #                             (fewer walk steps) at more tests per
    #                             leaf visit
    bvh_bins: int = 16          # binned-SAH builder bin count (finer
    #                             candidate splits at build-time cost;
    #                             16 is the shipped default)
    bvh_presplit: float = 0.0   # SBVH-style spatial presplitting budget
    #                             as a fraction of the mesh's triangle
    #                             count (0.3 = up to 30% duplicated
    #                             refs with clipped boxes). Routes the
    #                             build through the numpy ref-based
    #                             path (ops/bvh.presplit_refs); 0 =
    #                             plain binned SAH (native builder)
    bvh_pad: float = 0.0        # inflate every BVH node box by this
    #                             margin: the tree stays conservative
    #                             (traversal exact) for mesh vertices
    #                             moved up to the pad from their build
    #                             positions — set to the expected max
    #                             deformation for mesh-vertex fitting
    #                             (fit.PARAM_PATHS 'mesh_verts')
    light_cull: float = 0.0     # per-light attenuation culling: skip a
    #                             light's shadow query AND contribution
    #                             for lanes whose conservative bound
    #                             (max(kd)+max(ks)) * max(I) / d^2 falls
    #                             below this threshold (0-255 radiance
    #                             units; 1.0 = one 8-bit display step).
    #                             Bounded error <= threshold per light
    #                             per segment; 0 = exact. Applied
    #                             identically in the composed path, the
    #                             replay records and the replay.
    tree_cap: int = 4           # tree mode (refraction): max live-lane
    #                             capacity as a multiple of the primary
    #                             ray count. Each level's (reflect,
    #                             refract) fork doubles the lane arrays;
    #                             compaction then drops exactly-dead
    #                             lanes (weight 0 / miss / TIR child)
    #                             so deep scenes stop paying 2^depth.
    #                             If live lanes ever exceed the cap the
    #                             weakest-throughput lanes are dropped
    #                             (bounded, throughput-culling-style
    #                             error). 0 = uncapped exact 2^depth.
    remat: bool = False         # jax.checkpoint the scan bounce body:
    #                             backward recomputes each segment instead
    #                             of storing its residuals — the composed
    #                             differentiable path's memory fix (the
    #                             1080p residuals are 20+ [N,*] temps
    #                             per segment otherwise)
    diff: DiffConfig = field(default_factory=DiffConfig)

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)
