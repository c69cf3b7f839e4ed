"""Batched Blinn-Phong shading terms + surface attribute gathers.

Everything operates on flat ray batches ``[N]``; control flow from the
reference's recursive shader (Demo-RayTracing/RayTracingSetup.cs:304-455)
appears here as masks. Radiance lives on the reference's 0-255 "Rgb" scale
throughout (Data/Shading/Rgb.cs); conversion to display scale happens once at
image assembly.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from unity_raytracer_tpu.models.scene import Materials, Scene
from unity_raytracer_tpu.ops import intersect as isect
from unity_raytracer_tpu.ops.intersect import (
    Hit, KIND_MESH, KIND_SPHERE, KIND_TRI, dot3)

SHADOW_EPS = 1e-4  # ShadowRayEpsilon, RayTracingSetup.cs:42


def _sel3(mask: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(mask[:, None], a, b)




def take_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Row lookup that avoids XLA gather for small tables.

    For tables with <= 32 rows an unrolled masked-select chain is pure
    elementwise work that XLA fuses into neighbouring ops. Falls back to
    a real gather for big tables. ``idx`` must already be clipped to
    [0, rows).
    """
    r = table.shape[0]
    if r > isect._SMALL_TABLE:
        return jnp.take(table, idx, axis=0)
    m = idx[(...,) + (None,) * (table.ndim - 1)]  # broadcast over row dims
    out = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    for k in range(1, r):
        out = jnp.where(m == k, table[k], out)
    return out


def surface_attributes(scene: Scene, p: jnp.ndarray,
                       hit: Hit) -> Tuple[jnp.ndarray, Materials]:
    """Per-ray surface normal and material via masked selects.

    Replaces the reference's ObjectType switch
    (RayTracingSetup.cs:409-436): look up each category at the clipped hit
    index, then select by category code. Sphere normals are recomputed from
    the hit point (GetSphereNormal, RayTracingSetup.cs:402-407); triangle
    and mesh normals are table lookups. Material fields come from ONE
    combined (sphere ++ loose-tri ++ mesh) table per field indexed by a
    single combined index — small-table lookups lower to fused selects
    rather than 21 separate gathers (take_rows).
    """
    idx = jnp.clip(hit.index, 0, None)
    is_s = hit.kind == KIND_SPHERE
    is_m = hit.kind == KIND_MESH

    s_cnt = scene.spheres.count
    t_cnt = scene.triangles.count
    k_cnt = scene.meshes.mesh_count

    # sphere normal: normalize(p - center)
    sc = take_rows(scene.spheres.centers, jnp.clip(idx, 0, s_cnt - 1))
    sn = p - sc
    sn = sn * jax.lax.rsqrt(jnp.maximum(dot3(sn, sn), 1e-60))[:, None]

    tn = take_rows(scene.triangles.normals, jnp.clip(idx, 0, t_cnt - 1))
    if hit.mesh_n is not None:
        # re-derived in the BVH traversal epilogue (bvh.shading_normal) —
        # no gather from the [M]-row normal table needed
        mn = hit.mesh_n
    else:
        mn = jnp.take(scene.meshes.normals,
                      jnp.clip(idx, 0, scene.meshes.count - 1), axis=0)

    n = _sel3(is_s, sn, _sel3(is_m, mn, tn))

    comb = jnp.where(
        is_s, jnp.clip(idx, 0, s_cnt - 1),
        jnp.where(is_m,
                  s_cnt + t_cnt + jnp.clip(hit.mesh_index, 0, k_cnt - 1),
                  s_cnt + jnp.clip(idx, 0, t_cnt - 1)))

    def field(f):
        table = jnp.concatenate(
            [f(scene.spheres.materials), f(scene.triangles.materials),
             f(scene.meshes.mesh_materials)], axis=0)
        return take_rows(table, comb)

    mats = Materials(
        diffuse=field(lambda m: m.diffuse),
        ambient=field(lambda m: m.ambient),
        mirror=field(lambda m: m.mirror),
        specular=field(lambda m: m.specular),
        phong=field(lambda m: m.phong),
        is_mirror=field(lambda m: m.is_mirror),
        transparency=field(lambda m: m.transparency),
        ior=field(lambda m: m.ior),
        is_dielectric=field(lambda m: m.is_dielectric),
    )
    return n, mats


def shadow_min_t(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                 bvh=None, t_max: jnp.ndarray | None = None,
                 kernel: str = "auto", any_hit: bool = False,
                 with_mesh: bool = False):
    """Minimum hit distance per ray (no identity), +inf on miss.

    The reference issues a *full* nearest-hit query per shadow ray
    (RayTracingSetup.cs:333) but only consumes the distance; the occlusion
    predicate ``min_t^2 < light_dist^2`` is equivalent under nearest- or
    any-hit, so this cheaper min-reduction is exact. With a BVH, ``t_max``
    (the light distance) seeds the walk's cull so far subtrees prune;
    negative ``t_max`` culls a lane outright. ``any_hit`` stops a lane at
    its first occluder (hard-shadow queries only — the returned t is *an*
    occluder distance below t_max, sufficient for the occlusion predicate
    but not the minimum, so keep it off when soft-shadow gradients need
    the true min margin). ``with_mesh`` also returns the mesh triangles'
    own distance (the soft replay records).
    """
    if bvh is None:
        t_m = isect.ray_triangles(o, d, scene.meshes.verts,
                                  scene.meshes.valid).min(axis=1)
    else:
        from unity_raytracer_tpu.ops.bvh import traverse_any
        t_m, _, _ = traverse_any(bvh, o, d, t_max=t_max, kernel=kernel,
                                 any_hit=any_hit)
    t_s, _ = isect._best(isect.ray_spheres(
        o, d, scene.spheres.centers, scene.spheres.radius_sq,
        scene.spheres.valid))
    t_t, _ = isect._best(isect.ray_triangles(
        o, d, scene.triangles.verts, scene.triangles.valid))
    t = jnp.minimum(jnp.minimum(t_m, t_s), t_t)
    in_box = isect.ray_aabb(o, d, scene.aabb_min[None, :], scene.aabb_max[None, :])
    t = jnp.where(in_box, t, jnp.inf)
    return (t, t_m) if with_mesh else t


def _soft_or_hard_vis(hard: jnp.ndarray, margin: jnp.ndarray, temp: float,
                      straight_through: bool) -> jnp.ndarray:
    """Visibility in [0,1]. temp==0 -> hard. Otherwise sigmoid(margin/temp);
    with straight_through the forward value is hard and only gradients are
    soft (out = soft + stop_grad(hard - soft))."""
    if temp <= 0.0:
        return hard.astype(jnp.float32)
    soft = jax.nn.sigmoid(margin / temp)
    if straight_through:
        return soft + jax.lax.stop_gradient(hard.astype(jnp.float32) - soft)
    return soft


class LightQuery(NamedTuple):
    """Per-(lane, light) geometry and the shadow query's result."""

    ldist_sq: jnp.ndarray    # [N,L]
    ldir: jnp.ndarray        # [N,L,3]
    ln: jnp.ndarray          # [N,L] l.n
    need: jnp.ndarray        # [N,L] bool: shadow ray issued
    keep: jnp.ndarray        # [N,L] float: light kept by light_cull
    st: jnp.ndarray          # [N,L] occluder distance (+inf: none)
    st_mesh: jnp.ndarray     # [N,L] mesh triangles' own distance


def shadow_queries(scene: Scene, p: jnp.ndarray, n: jnp.ndarray,
                   mats: Materials, bvh=None, kernel: str = "auto",
                   mask: jnp.ndarray | None = None,
                   light_cull: float = 0.0,
                   any_hit: bool = True) -> LightQuery:
    """Light geometry + one shadow query per (lane, light) that matters.

    ``mask`` (optional [N]) marks lanes whose result is consumed;
    back-facing lights (l.n < 0) contribute exactly zero with zero
    parameter gradient, so their shadow rays are culled too, as are
    lights dropped by ``light_cull`` (lanes whose conservative bound
    (max(kd)+max(ks))*max(I)/d^2 is below the threshold skip the query
    AND the light's contribution; bounded error <= threshold per light
    per segment). Culled queries report +inf.
    """
    L = scene.lights.positions.shape[0]
    N = p.shape[0]
    lvec = scene.lights.positions[None, :, :] - p[:, None, :]      # [N,L,3]
    ldist_sq = dot3(lvec, lvec)                                    # [N,L]
    ldist = jnp.sqrt(ldist_sq)
    ldir = lvec / ldist[..., None]
    ln = dot3(ldir, n[:, None, :])                                 # [N,L]

    need = (ln >= 0.0) & scene.lights.valid[None, :]               # [N,L]
    if mask is not None:
        need = need & mask[:, None]
    keep = jnp.ones_like(ldist_sq)
    if light_cull > 0.0:
        kdks = (jnp.max(mats.diffuse, axis=-1)
                + jnp.max(mats.specular, axis=-1))                 # [N]
        imax = jnp.max(scene.lights.intensities, axis=-1)          # [L]
        cull_keep = (kdks[:, None] * imax[None, :]
                     >= light_cull * ldist_sq)                     # [N,L]
        need = need & cull_keep
        keep = cull_keep.astype(jnp.float32)

    so = p + n * SHADOW_EPS                                        # [N,3]
    # LIGHT-MAJOR layout: each walk-kernel block then carries a single
    # light direction (coherent walks) instead of interleaving L
    # different directions per block
    so_lm = jnp.broadcast_to(so[None, :, :], (L, N, 3)).reshape(-1, 3)
    sd_lm = jnp.transpose(ldir, (1, 0, 2)).reshape(-1, 3)
    tmax_lm = jnp.where(need, ldist, -1.0).T.reshape(-1)
    st, st_mesh = shadow_min_t(scene, so_lm, sd_lm, bvh=bvh,
                               t_max=tmax_lm, kernel=kernel,
                               any_hit=any_hit, with_mesh=True)
    st = jnp.where(need, st.reshape(L, N).T, jnp.inf)
    st_mesh = jnp.where(need, st_mesh.reshape(L, N).T, jnp.inf)
    return LightQuery(ldist_sq, ldir, ln, need, keep, st, st_mesh)


def direct_lighting(scene: Scene, p: jnp.ndarray, n: jnp.ndarray,
                    v: jnp.ndarray, mats: Materials,
                    soft_shadow_temp: float = 0.0,
                    straight_through: bool = True, bvh=None,
                    kernel: str = "auto",
                    mask: jnp.ndarray | None = None,
                    light_cull: float = 0.0,
                    with_stats: bool = False,
                    query: LightQuery | None = None) -> jnp.ndarray:
    """Ambient + per-light shadowed diffuse + Blinn-Phong specular, [N,3].

    Mirrors the light loop (RayTracingSetup.cs:324-356):
    * shadow ray from ``p + n*1e-4`` toward the light; light skipped when an
      occluder sits closer than the light (hitDist^2 < lightDist^2, :337-345)
    * irradiance ``Intensity / d^2`` (:350)
    * diffuse ``kd * max(0, l.n) * E`` (:443-455)
    * specular ``ks * max(0, n.h)^phong * E`` with halfway ``(l+v)/|l+v|``,
      zeroed when the light is behind the surface (l.n < 0 — the reference
      computes ``degrees(acos(l.n)) > 90``, :375-400)

    The shadow queries are ``shadow_queries`` (``mask`` and
    ``light_cull`` documented there); ``query`` passes in ones already
    made (the replay records).
    """
    if query is None:
        query = shadow_queries(scene, p, n, mats, bvh=bvh, kernel=kernel,
                               mask=mask, light_cull=light_cull,
                               any_hit=(soft_shadow_temp <= 0.0))
    ldist_sq, ldir, ln, need, keep, st, _ = query

    color = mats.ambient * scene.lights.ambient[None, :]  # [N,3] (:438-441)
    occluded = (st * st) < ldist_sq                                # [N,L]
    vis = _soft_or_hard_vis(~occluded, (st * st) - ldist_sq,
                            soft_shadow_temp, straight_through)

    irr = scene.lights.intensities[None, :, :] / ldist_sq[..., None]  # [N,L,3]
    diffuse = mats.diffuse[:, None, :] * jnp.maximum(0.0, ln)[..., None] * irr

    hv = ldir + v[:, None, :]
    hv = hv / jnp.maximum(jnp.sqrt(dot3(hv, hv)), 1e-30)[..., None]
    nh = jnp.maximum(0.0, dot3(n[:, None, :], hv))                 # [N,L]
    spec_mask = (ln >= 0.0).astype(jnp.float32)                    # behind cut
    # nh > 0 gate (replay parity): 0**0 == 1 would leak specular for
    # phong==0 materials on back-halfway lanes. Double-where keeps the
    # nh==0 power-rule gradient (inf for phong<1) masked out.
    pos_nh = nh > 0.0
    spec_term = jnp.where(
        pos_nh, jnp.where(pos_nh, nh, 1.0) ** mats.phong[:, None], 0.0)
    spec = (mats.specular[:, None, :]
            * spec_term[..., None] * irr
            * spec_mask[..., None])

    # culled lights contribute nothing (not unshadowed light)
    lvalid = (scene.lights.valid[None, :, None].astype(jnp.float32)
              * keep[..., None])
    terms = (diffuse + spec) * vis[..., None] * lvalid              # [N,L,3]
    for l in range(terms.shape[1]):  # static light count, no reduce op
        color = color + terms[:, l]
    if with_stats:  # live shadow-query lanes (bench honest accounting)
        return color, jnp.sum(need.astype(jnp.int32))
    return color


def reflect_dir(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror direction. The reference computes ``2 n (v.n) - v`` with
    ``v = -d`` (Reflect, RayTracingSetup.cs:368-373); equivalently
    ``d - 2 n (d.n)``. Unit-length when d, n are."""
    return d - 2.0 * n * dot3(d, n)[..., None]


def refract_dir(d: jnp.ndarray, n: jnp.ndarray,
                eta: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Snell refraction (extension; no refraction exists in the reference).

    ``n`` must oppose ``d`` (cos_i = -d.n >= 0). Returns (refracted dir,
    total-internal-reflection mask). On TIR the direction is garbage —
    callers must mask."""
    cos_i = -dot3(d, n)[..., None]
    k = 1.0 - eta[:, None] ** 2 * (1.0 - cos_i ** 2)
    tir = (k < 0.0)[:, 0]
    # double-where keeps sqrt'(0)=inf from poisoning masked-lane gradients
    k_safe = jnp.where(k < 0.0, 1.0, k)
    out = eta[:, None] * d + (eta[:, None] * cos_i - jnp.sqrt(k_safe)) * n
    return out, tir


def schlick_fresnel(cos_i: jnp.ndarray, n1: jnp.ndarray,
                    n2: jnp.ndarray) -> jnp.ndarray:
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5
