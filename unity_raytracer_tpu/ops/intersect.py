"""Batched ray/primitive intersection (pure jnp, differentiable).

Batched redesign of the reference's scalar kernels (Math/RMath.cs): every
function is an ``[N_rays] x [N_prims]`` broadcasted tensor expression — no
branches, all rejects are masks — which is simultaneously what XLA fuses
into wide elementwise kernels and what makes the tracer differentiable
(branch conditions become multiplicative masks whose *values* carry
gradients through ``t``).

Miss encoding: ``t = +inf`` (the reference uses ``float.MaxValue``,
Data/Objects/Scene.cs:45; inf composes better with min-reductions and the
comparisons agree everywhere the reference compares distances).

Category codes for hit identity (reference Data/Objects/ObjectType.cs):
0 = none, 1 = mesh triangle, 2 = sphere, 3 = loose triangle. The combine
order mesh -> sphere -> loose with strict ``>`` update reproduces
Scene.IntersectRay's tie-breaking (Scene.cs:64-115).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

EPS = 1e-5          # triangle epsilon, RMath.cs:9
INF = jnp.float32(jnp.inf)

KIND_NONE = 0
KIND_MESH = 1
KIND_SPHERE = 2
KIND_TRI = 3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Hit:
    """Per-ray nearest-hit record (SoA over rays).

    The reference's ``IntersectionResult { ObjectId {Type, Index, MeshIndex},
    Distance }`` (Data/Collision/IntersectionResult.cs) as parallel arrays.
    """

    t: jnp.ndarray        # [N] distance; +inf on miss
    kind: jnp.ndarray     # [N] int32 category code
    index: jnp.ndarray    # [N] int32 primitive index within category
    mesh_index: jnp.ndarray  # [N] int32 mesh id for mesh hits, else -1
    # shading normal for mesh hits, re-derived in the BVH traversal
    # epilogue from the winning triangle's (already gathered) verts —
    # None on the brute-force path, where shading gathers from the
    # normal table instead (ops/shade.surface_attributes)
    mesh_n: Optional[jnp.ndarray] = None  # [N,3] or None

    @property
    def is_hit(self) -> jnp.ndarray:
        return self.kind != KIND_NONE


def dot3(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Dot product over a size-3 minor axis, written as two adds.

    A reduce over a size-3 minor axis whose result is broadcast back is
    what XLA:GPU turns into Triton block-level fusions with tiles that grow
    with the ray count: at 1080p eight of them took most of a ~2 minute
    frame compile on an H100 (ptxas on a 22k-line kernel). Elementwise
    arithmetic fuses into ordinary loop fusions instead.
    """
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def ray_aabb(o: jnp.ndarray, d: jnp.ndarray, lo: jnp.ndarray,
             hi: jnp.ndarray) -> jnp.ndarray:
    """Slab test with ``tmin`` seeded 0 (origin inside box => hit) exactly as
    RMath.RayAABBIntersection (RMath.cs:12-26).

    Shapes broadcast: o,d ``[...,3]``; lo,hi ``[...,3]``. Returns bool mask.
    IEEE handles d==0: 1/0 = inf, and the min/max laddering keeps NaNs out of
    the final compare the same way the scalar loop does (min/max in jnp
    propagate like C# math.min/max for these inputs because slab products are
    never NaN unless o==lo==hi on a zero-dir axis, which the seed handles).
    """
    inv = 1.0 / d
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    # sequential per-axis fold, matching the scalar loop's clamping order
    tmin = jnp.float32(0.0)
    tmax = INF
    for i in range(3):
        a, b = t1[..., i], t2[..., i]
        tmin = jnp.minimum(jnp.maximum(a, tmin), jnp.maximum(b, tmin))
        tmax = jnp.maximum(jnp.minimum(a, tmax), jnp.minimum(b, tmax))
    return tmin <= tmax


def ray_spheres(o: jnp.ndarray, d: jnp.ndarray, centers: jnp.ndarray,
                radius_sq: jnp.ndarray,
                valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """All-pairs ray/sphere distances ``t [N,S]`` (+inf = miss).

    Half-b quadratic on the pre-squared radius, smallest non-negative root,
    per RMath.RaySphereIntersection (RMath.cs:81-108): miss when the
    discriminant < 0 or both roots < 0; inside-sphere rays take the far root.
    """
    oc = o[:, None, :] - centers[None, :, :]            # [N,S,3]
    uoc = dot3(d[:, None, :], oc)                       # [N,S]
    oc_sq = dot3(oc, oc)
    disc = uoc * uoc - (oc_sq - radius_sq[None, :])
    sq = _safe_sqrt(disc)
    big = -uoc + sq
    small = -uoc - sq
    t = jnp.where(small < 0, big, small)
    miss = (disc < 0) | (big < 0)
    if valid is not None:
        miss = miss | ~valid[None, :]
    return jnp.where(miss, INF, t)


def _safe_sqrt(disc: jnp.ndarray) -> jnp.ndarray:
    """sqrt(disc) with exact forward values and finite gradients on the
    whole line: negative AND exactly-zero discriminants (tangent rays —
    where sqrt' = inf) route through constants. At disc == 0 the true
    dt/d(params) is unbounded (tangency is a non-differentiable edge);
    the zero subgradient is the bounded choice."""
    pos = disc > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)


def ray_triangles(o: jnp.ndarray, d: jnp.ndarray, verts: jnp.ndarray,
                  valid: jnp.ndarray | None = None) -> jnp.ndarray:
    """All-pairs Moller-Trumbore ``t [N,T]`` (+inf = miss).

    Reject masks mirror RMath.RayTriangleIntersection (RMath.cs:29-73):
    |det| < 1e-5 (parallel), u outside [0,1], v < 0, u+v > 1, t <= 1e-5.
    Degenerate padding triangles (all-zero verts) fall to the parallel reject.
    """
    v0 = verts[:, 0, :]                                  # [T,3]
    e1 = verts[:, 1, :] - v0
    e2 = verts[:, 2, :] - v0
    h = jnp.cross(d[:, None, :], e2[None, :, :])         # [N,T,3]
    a = dot3(e1[None, :, :], h)                          # [N,T]
    parallel = jnp.abs(a) < EPS
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = o[:, None, :] - v0[None, :, :]                   # [N,T,3]
    u = f * dot3(s, h)
    q = jnp.cross(s, e1[None, :, :])                     # [N,T,3]
    v = f * dot3(d[:, None, :], q)
    t = f * dot3(e2[None, :, :], q)
    miss = (parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
            | (t <= EPS))
    if valid is not None:
        miss = miss | ~valid[None, :]
    return jnp.where(miss, INF, t)


def sphere_margins(scene, o: jnp.ndarray, d: jnp.ndarray
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Soft-silhouette support: per-(ray, sphere) hit margin and
    closest-approach distance.

    margin = discriminant / r^2 (dimensionless): > 0 inside the silhouette,
    < 0 outside, crossing 0 exactly at the visual edge — the quantity a
    sigmoid relaxes to give silhouette gradients (absent in the reference,
    and impossible there; required for inverse rendering, SURVEY.md §2.2).
    Spheres behind the ray origin are pushed to margin=-inf.
    Returns (margin [N,S], t_closest [N,S]).
    """
    centers = scene.spheres.centers
    r2 = scene.spheres.radius_sq
    oc = o[:, None, :] - centers[None, :, :]
    uoc = dot3(d[:, None, :], oc)
    oc_sq = dot3(oc, oc)
    disc = uoc * uoc - (oc_sq - r2[None, :])
    margin = disc / jnp.maximum(r2[None, :], 1e-12)
    in_front = (-uoc) > 0.0
    ok = in_front & scene.spheres.valid[None, :]
    margin = jnp.where(ok, margin, -jnp.inf)
    t_close = jnp.maximum(-uoc, 1e-3)
    return margin, t_close


_SMALL_TABLE = 32


def _best(t: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-ray (min t, first argmin) over the [N, K] candidates. The first
    minimum matches the reference's strict-``>`` update keeping the
    earliest of equals (Scene.cs:72-81). Small tables (spheres, loose
    triangles) run as an unrolled elementwise chain, no reduce (see
    ``dot3``)."""
    if t.shape[1] > _SMALL_TABLE:
        return jnp.min(t, axis=1), jnp.argmin(t, axis=1).astype(jnp.int32)
    tmin = t[:, 0]
    idx = jnp.zeros(t.shape[:1], jnp.int32)
    for k in range(1, t.shape[1]):
        better = t[:, k] < tmin
        tmin = jnp.where(better, t[:, k], tmin)
        idx = jnp.where(better, k, idx)
    return tmin, idx


def nearest_hit(scene, o: jnp.ndarray, d: jnp.ndarray, bvh=None,
                kernel: str = "auto",
                t_max: jnp.ndarray | None = None) -> Hit:
    """Nearest hit over all three categories (brute force or BVH).

    Combine order and strict ``>`` tie-breaking replicate
    Scene.IntersectRay (Scene.cs:43-122): mesh triangles, then spheres, then
    loose triangles. The reference's per-mesh AABB gate (Scene.cs:66) is a
    scalar-era culling trick; in the batched regime primary rays hit nearly
    every gate so we intersect all mesh triangles directly — or, when
    ``bvh`` is given, via the threaded-BVH traversal (ops/bvh.py), which
    subsumes the gate entirely.

    The scene-level AABB early-out (Scene.cs:54) is applied as a final mask:
    rays missing the scene box report miss regardless (also semantics-exact:
    inside the box the gate passes for every ray that could hit anything).
    """
    n = o.shape[0]
    mesh_n = None
    if bvh is None:
        t_mesh, i_mesh = _best(ray_triangles(o, d, scene.meshes.verts,
                                             scene.meshes.valid))
    else:
        from unity_raytracer_tpu.ops.bvh import traverse_any
        # t_max < 0 culls dead lanes from the walk (bounce chains pass -1
        # for retired rays); it does not change live-lane results
        t_mesh, i_mesh, nml = traverse_any(
            bvh, o, d, kernel=kernel,
            t_max=jax.lax.stop_gradient(t_max)
            if t_max is not None else None)
        i_mesh = jnp.clip(i_mesh, 0, None)  # downstream masks on kind
        if bvh.canonical:
            mesh_n = nml
    t_sph, i_sph = _best(ray_spheres(o, d, scene.spheres.centers,
                                     scene.spheres.radius_sq,
                                     scene.spheres.valid))
    t_tri, i_tri = _best(ray_triangles(o, d, scene.triangles.verts,
                                       scene.triangles.valid))

    t = t_mesh
    kind = jnp.where(jnp.isfinite(t_mesh), KIND_MESH, KIND_NONE).astype(jnp.int32)
    index = jnp.where(jnp.isfinite(t_mesh), i_mesh, -1)
    upd = t > t_sph                         # strict > (Scene.cs:94)
    t = jnp.where(upd, t_sph, t)
    kind = jnp.where(upd, KIND_SPHERE, kind)
    index = jnp.where(upd, i_sph, index)
    upd = t > t_tri                         # strict > (Scene.cs:107)
    t = jnp.where(upd, t_tri, t)
    kind = jnp.where(upd, KIND_TRI, kind)
    index = jnp.where(upd, i_tri, index)

    in_box = ray_aabb(o, d, scene.aabb_min[None, :], scene.aabb_max[None, :])
    t = jnp.where(in_box, t, INF)
    kind = jnp.where(in_box, kind, KIND_NONE)
    index = jnp.where(in_box, index, -1)

    # clip to the mesh table size: a sphere/loose winner's index can
    # exceed M (value masked below, but unclipped it is still an OOB
    # access — caught by checkify, tests/test_sanitize.py)
    mesh_index = jnp.where(
        kind == KIND_MESH,
        jnp.take(scene.meshes.mesh_id,
                 jnp.clip(index, 0, scene.meshes.count - 1)),
        jnp.int32(-1))
    return Hit(t=t, kind=kind, index=index,
               mesh_index=mesh_index.astype(jnp.int32), mesh_n=mesh_n)
