"""Record-replay backward: one hard forward that records the discrete
decisions + a differentiable shading replay — the fast fwd+bwd path.

The composed differentiable path re-walks the BVH per segment inside the
gradient and stores [N,L] lighting tensors as autodiff residuals. This
module gets gradients at forward speed by splitting the work the way the
math actually splits:

* **The walk is index logic** — which primitive wins, which lights are
  occluded. It carries no parameter gradient in the hard-visibility
  regime (temps 0): the composed path already wraps it in
  ``stop_gradient`` / fixed-argmin selection.
* **Shading is the differentiable part** — the winner's analytic t, the
  surface normal, Blinn-Phong terms, light falloff.

So: run the bounce chain ONCE with ``trace_records`` — the composed
pieces (``nearest_hit`` plus the shadow queries of
``shade.shadow_queries``, on whichever walk ``ops/backend`` routes to) —
to get per-segment hit records ``(t, n, matid, occbits)``, then REPLAY
the bounce chain's shading in pure differentiable jnp with the discrete
decisions frozen to the records. No walk in the backward, no [N,L]
shadow queries, no per-lane gathers (winner geometry/material comes from
small-table masked selects, ops/shade.take_rows).

Gradient semantics = the composed path at ``soft_*_temp == 0`` exactly
(tests/test_replay.py asserts allclose grads):

* sphere winners: t and normal recomputed analytically from the sphere
  params -> full gradients w.r.t. centers / radius_sq;
* loose-triangle winners: t via Moller-Trumbore and the stored normal
  table -> gradients w.r.t. tri_verts / normals;
* mesh-triangle winners: recorded t/normal used as constants — correct
  for every optimizable parameter class in fit.PARAM_PATHS except
  'mesh_verts' (use the composed path for those);
* visibility (hit/shadow bits): frozen — identical to the hard forward
  whose gradient is zero/straight-through anyway.

Soft silhouette fitting (temps > 0): ``trace_records(soft=True)`` also
records per-light MIN mesh-occluder distances (``any_hit=False`` shadow
walks bounded by the light distance) and ``replay_radiance_soft``
rebuilds the composed soft semantics differentiably — sphere silhouettes
and sphere/loose soft shadows exact, mesh facts frozen (see its
docstring). The composed path (fit.py chunked/remat) remains the
exact-reference fallback.

Reference semantics mirrored: shading terms RayTracingSetup.cs:324-455,
Intensity/d^2 falloff :350, mirror continuation :358-373, 0-255 Rgb
scale (Data/Shading/Rgb.cs).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from unity_raytracer_tpu.models.scene import Materials, Scene
from unity_raytracer_tpu.ops import shade as sh
from unity_raytracer_tpu.ops.bvh import _mt_one
from unity_raytracer_tpu.ops.intersect import (
    KIND_SPHERE, KIND_TRI, dot3, nearest_hit)
from unity_raytracer_tpu.ops.shade import SHADOW_EPS, take_rows
from unity_raytracer_tpu.utils.config import RenderConfig

# records tuple, each stacked over segments (leading dim B):
#   hard: (t [B,N], n [B,N,3], matid [B,N], occbits [B,N])
#   soft (trace_records(soft=True)): + (st [B,N,L] min mesh-occluder t)
Records = Tuple[jnp.ndarray, ...]
_BIG = 3.0e38   # "no occluder" in the soft st record


def combined_materials(scene: Scene) -> Materials:
    """One material table in combined id order: sphere ++ loose-triangle
    ++ per-mesh rows (the order of ops/shade.surface_attributes)."""
    return jax.tree.map(
        lambda a, b, c: jnp.concatenate([a, b, c], axis=0),
        scene.spheres.materials, scene.triangles.materials,
        scene.meshes.mesh_materials)


@partial(jax.jit, static_argnames=("cfg", "soft"))
def trace_records(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                  cfg: RenderConfig, bvh=None,
                  soft: bool = False) -> Tuple[jnp.ndarray, Records]:
    """Hard-visibility mirror bounce chain with hit recording.

    Returns ``(acc [N,3], records)``: ``acc`` the radiance (0-255 scale,
    equal to ``trace_radiance`` at temps 0) and each record stacked over
    the ``max_bounces+1`` segments with leading dim B:

    * ``t`` — winner distance, -1 on a miss or a retired lane;
    * ``n`` — the shading normal used;
    * ``matid`` — combined material id (sphere ++ loose ++ mesh rows);
    * ``occbits`` — bit ``l`` set where light ``l``'s shadow ray was
      issued and found an occluder closer than the light.

    Everything is stop-gradient (the records are facts, not functions).
    ``soft=True``: shadow walks run in MIN mode (``any_hit=False``) and
    the records gain ``st [B, N, L]`` — per light, the minimum
    mesh-occluder distance below the light distance (``_BIG`` when none
    or when the query was not issued), what the soft-shadow replay needs.
    """
    scene = jax.lax.stop_gradient(scene)
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    n_rays = o.shape[0]
    L = scene.lights.positions.shape[0]
    S = scene.spheres.count
    T = scene.triangles.count
    bg = jnp.asarray(cfg.background, jnp.float32) * 255.0

    def live_seg(args):
        o, d, thr, active, acc, depth = args
        hit = nearest_hit(scene, o, d, bvh=bvh, kernel=cfg.kernel,
                          t_max=jnp.where(active, 3.0e38, -1.0))
        hit_mask = hit.is_hit & active
        p = o + d * jnp.where(hit_mask, hit.t, 1.0)[:, None]
        n, mats = sh.surface_attributes(scene, p, hit)
        q = sh.shadow_queries(scene, p, n, mats, bvh=bvh,
                              kernel=cfg.kernel, mask=hit_mask,
                              light_cull=cfg.light_cull, any_hit=not soft)
        local = sh.direct_lighting(scene, p, n, -d, mats, query=q)
        contrib = jnp.where(hit_mask[:, None], local, bg[None, :])
        acc = acc + thr * contrib * active[:, None]

        idx = jnp.clip(hit.index, 0, None)
        comb = jnp.where(hit.kind == KIND_SPHERE, idx,
                         jnp.where(hit.kind == KIND_TRI, S + idx,
                                   S + T + jnp.clip(hit.mesh_index, 0,
                                                    None)))
        occ = q.need & (q.st * q.st < q.ldist_sq)                  # [N,L]
        bits = jnp.zeros((n_rays,), jnp.int32)
        for l in range(L):
            bits = bits | (occ[:, l].astype(jnp.int32) << l)
        rec = (jnp.where(hit_mask, hit.t, -1.0),
               jnp.where(hit_mask[:, None], n, 0.0),
               jnp.where(hit_mask, comb, -1).astype(jnp.float32),
               bits.astype(jnp.float32))
        if soft:
            rec = rec + (jnp.where(jnp.isfinite(q.st_mesh), q.st_mesh,
                                   _BIG),)
        cont = hit_mask & mats.is_mirror & (depth < cfg.max_bounces)
        thr = jnp.where(cont[:, None], thr * mats.mirror, thr)
        o = p + n * SHADOW_EPS    # Reflect origin offset (:368-373)
        d = jnp.where(cont[:, None], sh.reflect_dir(d, n), d)
        return (o, d, thr, cont, acc), rec

    def dead_seg(args):
        o, d, thr, active, acc, depth = args
        rec = (jnp.full((n_rays,), -1.0, jnp.float32),
               jnp.zeros((n_rays, 3), jnp.float32),
               jnp.full((n_rays,), -1.0, jnp.float32),
               jnp.zeros((n_rays,), jnp.float32))
        if soft:
            rec = rec + (jnp.full((n_rays, L), _BIG, jnp.float32),)
        return (o, d, thr, active, acc), rec

    def bounce(carry, depth):
        o, d, thr, active, acc = carry
        return jax.lax.cond(jnp.any(active), live_seg, dead_seg,
                            (o, d, thr, active, acc, depth))

    init = (o, d, jnp.ones((n_rays, 3), jnp.float32),
            jnp.ones((n_rays,), bool), jnp.zeros((n_rays, 3), jnp.float32))
    (_, _, _, _, acc), recs = jax.lax.scan(
        bounce, init, jnp.arange(cfg.max_bounces + 1))
    return acc, recs


def _sphere_t(o, d, center, r2, selected):
    """Reference smallest-positive-root sphere t (RMath.cs:81-108) for
    the per-lane SELECTED sphere; differentiable w.r.t. center/r2.
    Guarded so non-selected lanes stay finite with zero gradient."""
    oc = o - center
    uoc = dot3(d, oc)
    oc2 = dot3(oc, oc)
    disc = uoc * uoc - (oc2 - r2)
    # double-where with exact forward: masked/tangent lanes contribute a
    # zero subgradient instead of sqrt'(0)=inf (ops/intersect._safe_sqrt)
    pos = selected & (disc > 0.0)
    sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
    big = -uoc + sq
    small = -uoc - sq
    return jnp.where(small < 0.0, big, small)


def _winner_geometry(scene: Scene, o, d, t_rec, n_rec, comb_f, hit):
    """Differentiable ``(t_safe, p, n, comb)`` for recorded winners.

    Spheres / loose triangles re-derived analytically from the scene
    parameters (full gradients); mesh winners via the frozen-plane trick
    (value == t_rec exactly, chain gradient through o/d preserved — see
    module docstring). Non-hit lanes carry safe finite values.
    """
    S = scene.spheres.count
    T = scene.triangles.count
    K = scene.meshes.mesh_count
    sel3 = lambda m, a, b: jnp.where(m[:, None], a, b)
    comb = jnp.clip(comb_f.astype(jnp.int32), 0, S + T + K - 1)
    is_sp = hit & (comb_f >= 0.0) & (comb_f < S)
    is_lo = hit & (comb_f >= S) & (comb_f < S + T)

    if S:
        sidx = jnp.clip(comb, 0, S - 1)
        c_sel = take_rows(scene.spheres.centers, sidx)
        r2_sel = take_rows(scene.spheres.radius_sq, sidx)
        t_sph = _sphere_t(o, d, c_sel, r2_sel, is_sp)
    if T:
        tidx = jnp.clip(comb - S, 0, T - 1)
        tv = take_rows(scene.triangles.verts, tidx)          # [N,3,3]
        t_tri = _mt_one(o, d, tv[:, 0], tv[:, 1], tv[:, 2])
        t_tri = jnp.where(is_lo & jnp.isfinite(t_tri), t_tri, 1.0)
        n_tri = take_rows(scene.triangles.normals, tidx)

    # mesh winners: differentiable plane-intersection t against the
    # FROZEN winner plane (constant point p0 + recorded normal); value
    # == t_rec exactly, d t/d(o,d) preserved for mirror-chain gradients
    p0 = (jax.lax.stop_gradient(o)
          + jax.lax.stop_gradient(d) * t_rec[:, None])
    denom = dot3(n_rec, d)
    denom = jnp.where(jnp.abs(denom) < 1e-12, 1.0, denom)
    t_mesh = dot3(n_rec, p0 - o) / denom + \
        jax.lax.stop_gradient(t_rec - dot3(n_rec, p0 - o) / denom)
    t = jnp.where(hit & (comb_f >= S + T), t_mesh, t_rec)
    n = n_rec
    if S:
        t = jnp.where(is_sp, t_sph, t)
    if T:
        t = jnp.where(is_lo, t_tri, t)
    t_safe = jnp.where(hit, t, 1.0)
    p = o + d * t_safe[:, None]
    if S:
        n_sph = (p - c_sel) * jax.lax.rsqrt(
            jnp.maximum(r2_sel, 1e-60))[:, None]
        n = sel3(is_sp, n_sph, n)
    if T:
        n = sel3(is_lo, n_tri, n)
    return t_safe, p, n, comb


def replay_lighting(scene: Scene, p, n, v, mats: Materials,
                    occbits: jnp.ndarray, mask: jnp.ndarray,
                    light_cull: float = 0.0):
    """Direct lighting with visibility frozen to the recorded per-light
    occlusion bits — same terms as shade.direct_lighting, no queries."""
    occ_int = occbits.astype(jnp.int32)
    color = mats.ambient * scene.lights.ambient[None, :]
    L = scene.lights.positions.shape[0]
    if L == 0:
        return color

    lvec = scene.lights.positions[None, :, :] - p[:, None, :]   # [N,L,3]
    ldist_sq = dot3(lvec, lvec)
    ldir = lvec * jax.lax.rsqrt(jnp.maximum(ldist_sq, 1e-60))[..., None]
    ln = dot3(ldir, n[:, None, :])                              # [N,L]

    occ = jnp.stack([(occ_int >> l) & 1 for l in range(L)],
                    axis=1) > 0                                 # [N,L]
    need = (ln >= 0.0) & scene.lights.valid[None, :] & mask[:, None]
    if light_cull > 0.0:
        # same attenuation gate as the recording pass — culled lanes'
        # bits were never computed, so their terms must stay off
        kdks = (jnp.max(mats.diffuse, axis=-1)
                + jnp.max(mats.specular, axis=-1))
        imax = jnp.max(scene.lights.intensities, axis=-1)
        need = need & jax.lax.stop_gradient(
            kdks[:, None] * imax[None, :] >= light_cull * ldist_sq)
    vis = (need & ~occ).astype(jnp.float32)

    irr = scene.lights.intensities[None, :, :] \
        / jnp.maximum(ldist_sq, 1e-60)[..., None]               # [N,L,3]
    diffuse = (mats.diffuse[:, None, :]
               * jnp.maximum(0.0, ln)[..., None] * irr)

    hv = ldir + v[:, None, :]
    hv = hv * jax.lax.rsqrt(jnp.maximum(dot3(hv, hv), 1e-60))[..., None]
    nh = jnp.maximum(0.0, dot3(n[:, None, :], hv))
    # nh > 0 gate mirrors shade.direct_lighting exactly: without it,
    # exp(phong*log(max(nh,1e-30))) evaluates to 1.0 at nh==0 when
    # phong==0, adding false specular light
    spec_term = jnp.where(
        nh > 0.0,
        jnp.exp(mats.phong[:, None] * jnp.log(jnp.maximum(nh, 1e-30))),
        0.0)
    spec = mats.specular[:, None, :] * spec_term[..., None] * irr

    terms = (diffuse + spec) * vis[..., None]                   # [N,L,3]
    for l in range(L):  # static light count, no reduce op
        color = color + terms[:, l]
    return color


def replay_radiance(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                    records: Records, cfg: RenderConfig,
                    live_segments: int | None = None) -> jnp.ndarray:
    """Differentiable radiance [N,3] (0-255 scale) from frozen records.

    Statically unrolled over the (small) segment count; each level is
    shading-only — winner geometry is recomputed analytically from the
    scene parameters for spheres/loose triangles, taken from the record
    for mesh triangles (see module docstring for why that is exact for
    every fit.PARAM_PATHS class).

    ``live_segments`` (static): process only the first k segments —
    exact IF no record beyond the prefix is live (caller-measured, see
    live_depth); None processes all.
    """
    rt_all, rn_all, rmat_all, rocc_all = records
    B = rt_all.shape[0]
    S = scene.spheres.count
    T = scene.triangles.count
    K = scene.meshes.mesh_count
    mats_table = combined_materials(scene)
    bg = jnp.asarray(cfg.background, jnp.float32) * 255.0

    n_rays = o.shape[0]
    acc = jnp.zeros((n_rays, 3), jnp.float32)
    thr = jnp.ones((n_rays, 3), jnp.float32)
    live = jnp.ones((n_rays,), bool)
    sel3 = lambda m, a, b: jnp.where(m[:, None], a, b)

    def segment(s, t_rec, n_rec, comb_f, occ, acc, thr, o, d, live):
        hit = live & (t_rec >= 0.0)
        _, p, n, comb = _winner_geometry(scene, o, d, t_rec, n_rec,
                                         comb_f, hit)
        mats = jax.tree.map(lambda a: take_rows(a, comb), mats_table)
        local = replay_lighting(scene, p, n, -d, mats, occ, hit,
                                light_cull=cfg.light_cull)
        contrib = sel3(hit, local, jnp.broadcast_to(bg, (n_rays, 3)))
        acc = acc + thr * contrib * live[:, None]
        if s == B - 1:
            return acc, thr, o, d, live

        cont = hit & mats.is_mirror.astype(bool) & (s < cfg.max_bounces)
        thr = sel3(cont, thr * mats.mirror, thr)
        o = p + n * SHADOW_EPS
        d = sel3(cont, sh.reflect_dir(d, n), d)
        return acc, thr, o, d, cont

    # All-dead segments (the flagship's segments 2-4) contribute exactly
    # zero (live gates the add) and feed only further dead segments, so
    # processing just the live PREFIX is exact. The prefix length is a
    # STATIC argument (``live_segments``, measured once by the caller —
    # bench.py / fit.py): under value_and_grad a dynamic lax.cond skip
    # would keep both branches' residual buffers. This cuts the replay's
    # fwd+bwd [N,L] tensor work from B segments to the live prefix.
    for s in range(B if live_segments is None
                   else min(B, max(1, live_segments))):
        t_rec = jax.lax.stop_gradient(rt_all[s])
        n_rec = jax.lax.stop_gradient(rn_all[s])
        comb_f = jax.lax.stop_gradient(rmat_all[s])
        occ = jax.lax.stop_gradient(rocc_all[s])
        acc, thr, o, d, live = segment(s, t_rec, n_rec, comb_f, occ,
                                       acc, thr, o, d, live)
    return acc


def _soft_lighting(scene: Scene, p, n, v, mats: Materials,
                   st_rec: jnp.ndarray, cfg: RenderConfig,
                   diag_proxy: jnp.ndarray | None = None):
    """Soft-shadow direct lighting from recorded mesh min-t plus
    jnp-recomputed sphere / loose-triangle occluder minima — the terms
    of shade.direct_lighting at ``soft_shadow_temp > 0`` without any
    traversal. ``st_rec [N,L]`` is the min-mode record (_BIG when
    unoccluded); sphere/loose occluders are re-derived so their
    silhouette gradients flow; the mesh branch is a frozen constant.

    Every temporary is [N]- or [N,3]-shaped (static unroll over lights /
    spheres / loose tris), so no rank-3 [N,L,S] intermediates are
    materialized.

    ``diag_proxy`` (optional [N] bool — the segment's proxy-adopted
    lanes) switches on the BIAS DIAGNOSTICS return: the function then
    returns ``(color, frozen_any, proxy_risk_any)`` where

    * ``frozen_any`` marks lanes where, for some light, the MESH record
      is the winning occluder min inside the sigmoid's active band —
      exactly the lanes whose d(st)/d(·) chain terms are silently
      frozen (the documented soft-replay bias regime);
    * ``proxy_risk_any`` marks proxy lanes whose shadow segment enters
      the mesh-soup AABB — lanes whose assumed-no-mesh-occlusion may be
      wrong (the hard forward never queried them).

    Compile-time note: the static unrolls make
    compile time scale with S * L and T * L; at the presets' table
    sizes (S, T <= ~16) this is seconds, but hundreds of spheres or
    loose triangles would blow up compilation quadratically-ish —
    route such scenes through the composed path instead.
    """
    from unity_raytracer_tpu.ops import intersect as isect
    from unity_raytracer_tpu.ops.shade import _soft_or_hard_vis

    temp = cfg.diff.soft_shadow_temp
    stt = cfg.diff.straight_through
    color = mats.ambient * scene.lights.ambient[None, :]
    L = scene.lights.positions.shape[0]
    if L == 0:
        return color
    so = p + n * SHADOW_EPS
    big = jnp.float32(3.0e38)
    S = scene.spheres.count
    T = scene.triangles.count
    if cfg.light_cull > 0.0:
        kdks = (jnp.max(mats.diffuse, axis=-1)
                + jnp.max(mats.specular, axis=-1))

    diag = diag_proxy is not None
    if diag:
        n_lanes = p.shape[0]
        frozen_any = jnp.zeros((n_lanes,), bool)
        frozen_band_any = jnp.zeros((n_lanes,), bool)
        proxy_risk_any = jnp.zeros((n_lanes,), bool)
        # mesh-soup AABB (diagnostics only — conservative entry test for
        # proxy lanes whose shadow rays the hard forward never queried)
        mv = scene.meshes.verts                                  # [M,3,3]
        mvalid = scene.meshes.valid[:, None, None]
        mesh_lo = jnp.min(jnp.where(mvalid, mv, jnp.inf), axis=(0, 1))
        mesh_hi = jnp.max(jnp.where(mvalid, mv, -jnp.inf), axis=(0, 1))

    acc = color
    for l in range(L):
        lp = scene.lights.positions[l]
        lint = scene.lights.intensities[l]                      # [3]
        lvec = lp[None, :] - p                                  # [N,3]
        ld2 = dot3(lvec, lvec)
        linv = jax.lax.rsqrt(jnp.maximum(ld2, 1e-60))
        ldir = lvec * linv[:, None]
        ln = dot3(ldir, n)

        st = jnp.full_like(ld2, big)
        for s in range(S):
            oc = so - scene.spheres.centers[s][None, :]
            uoc = dot3(ldir, oc)
            oc2 = dot3(oc, oc)
            disc = uoc * uoc - (oc2 - scene.spheres.radius_sq[s])
            pos = disc > 0.0
            # double-where: masked lanes get a zero subgradient
            sq = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)),
                           0.0)
            bigroot = -uoc + sq
            small = -uoc - sq
            t_s = jnp.where(small < 0.0, bigroot, small)
            ok = ((disc >= 0.0) & (bigroot >= 0.0)
                  & scene.spheres.valid[s])
            st = jnp.minimum(st, jnp.where(ok, t_s, big))
        for ti in range(T):
            tv = scene.triangles.verts[ti]
            tt = _mt_one(so, ldir, tv[0][None], tv[1][None],
                         tv[2][None])
            tt = jnp.where(jnp.isfinite(tt) & scene.triangles.valid[ti],
                           tt, big)
            st = jnp.minimum(st, tt)
        # scene-AABB gate (shadow_min_t inherits IntersectRay's early-out)
        in_box = isect.ray_aabb(so, ldir, scene.aabb_min[None, :],
                                scene.aabb_max[None, :])
        st = jnp.where(in_box, st, big)
        # min with the frozen mesh record; <= keeps the DIFFERENTIABLE
        # branch at exact ties
        stl = st_rec[:, l]
        if diag:
            # biased regime: the mesh record wins the occluder min AND
            # occludes — its d(st) chain terms are frozen below. The
            # band-filtered variant keeps only lanes inside the
            # sigmoid's active region, where the frozen gradient is
            # actually non-negligible (outside it vis is saturated).
            mesh_wins = ((stl < st) & (stl * stl < ld2)
                         & scene.lights.valid[l] & (ln >= 0.0))
            band = (jnp.abs(stl * stl - ld2) < 30.0 * max(temp, 1e-6))
            frozen_any = frozen_any | mesh_wins
            frozen_band_any = frozen_band_any | (mesh_wins & band)
            proxy_risk_any = proxy_risk_any | (
                diag_proxy & scene.lights.valid[l] & (ln >= 0.0)
                & isect.ray_aabb(so, ldir, mesh_lo[None, :],
                                 mesh_hi[None, :]))
        st = jnp.where(st <= stl, st, jax.lax.stop_gradient(stl))
        occ = (st * st) < ld2
        vis = _soft_or_hard_vis(~occ, st * st - ld2, temp, stt)

        irr_s = 1.0 / jnp.maximum(ld2, 1e-60)                   # [N]
        dterm = jnp.maximum(0.0, ln) * irr_s * vis
        hv = ldir + v
        hv = hv * jax.lax.rsqrt(jnp.maximum(dot3(hv, hv), 1e-60))[:, None]
        nh = jnp.maximum(0.0, dot3(n, hv))
        # nh > 0 gate mirrors shade.direct_lighting (and
        # replay_lighting): at nh == 0 with phong == 0, nh**phong
        # evaluates to 1 and leaks specular light the forward never
        # emits.
        # Double-where keeps d(nh**phong)/d(nh) = inf at nh==0 (phong<1)
        # off the masked lanes.
        pos_nh = nh > 0.0
        sterm = (jnp.where(pos_nh,
                           jnp.where(pos_nh, nh, 1.0) ** mats.phong, 0.0)
                 * (ln >= 0.0).astype(jnp.float32) * irr_s * vis)
        keepf = scene.lights.valid[l].astype(jnp.float32)
        if cfg.light_cull > 0.0:
            keepf = keepf * jax.lax.stop_gradient(
                kdks * jnp.max(lint) >= cfg.light_cull * ld2
            ).astype(jnp.float32)
        acc = acc + (mats.diffuse * (dterm * keepf)[:, None]
                     + mats.specular * (sterm * keepf)[:, None]
                     ) * lint[None, :]
    if diag:
        return acc, frozen_any, frozen_band_any, proxy_risk_any
    return acc


def replay_radiance_soft(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                         records, cfg: RenderConfig,
                         live_segments: int | None = None,
                         with_diag: bool = False) -> jnp.ndarray:
    """Differentiable SOFT-visibility radiance from soft records — the
    fast silhouette-fitting path.

    Under ``straight_through`` the forward VALUE equals the hard
    forward image exactly (soft terms enter gradients only).
    Gradient semantics vs the composed soft path:

    * sphere silhouettes (soft_hit proxy/winner margins) and sphere /
      loose-triangle occluder soft shadows: recomputed in pure jnp —
      exact, full parameter gradients;
    * mesh winner geometry and mesh-occluder st: frozen records — no
      gradient through mesh geometry (not optimizable) and the
      d st/d(origin, light) chain terms through a MESH occluder are
      dropped;
    * proxy (miss-side silhouette) lanes assume no mesh occlusion of
      their shadow rays — the hard forward never queried them; their
      sphere/loose occlusion is recomputed exactly.

    ``with_diag=True`` additionally returns a dict of lane counts for
    the biased regimes above: ``mesh_occ_frozen`` (lanes whose winning
    shadow occluder is a frozen mesh record inside the sigmoid band)
    and ``proxy_mesh_risk`` (proxy lanes whose unqueried shadow rays
    enter the mesh AABB). Both zero <=> the soft gradients match the
    composed path's semantics for mesh-shadow terms. fit() warns once
    at start when nonzero; tests/test_replay_soft.py quantifies the
    actual gradient bias on a crafted mesh-shadowed scene.
    """
    rt_all, rn_all, rmat_all, _, rst_all = records
    B = rt_all.shape[0]
    S = scene.spheres.count
    mats_table = combined_materials(scene)
    bg = jnp.asarray(cfg.background, jnp.float32) * 255.0
    n_rays = o.shape[0]
    acc = jnp.zeros((n_rays, 3), jnp.float32)
    thr = jnp.ones((n_rays, 3), jnp.float32)
    live = jnp.ones((n_rays,), bool)
    sel3 = lambda m, a, b: jnp.where(m[:, None], a, b)
    ht = cfg.diff.soft_hit_temp
    stt = cfg.diff.straight_through

    def segment(s, t_rec, n_rec, comb_f, st_rec, acc, thr, o, d, live,
                diag_acc):
        hit = live & (t_rec >= 0.0)
        _, p, n, comb = _winner_geometry(scene, o, d, t_rec, n_rec,
                                         comb_f, hit)
        shade_mask = hit
        w = hit.astype(jnp.float32)
        comb2 = comb
        use_proxy = jnp.zeros((n_rays,), bool)
        if ht > 0.0 and S:
            # sphere silhouette relaxation — the proxy-adoption and
            # margin-blend logic of render._local_radiance, computed as
            # a running argmax over the (small, unrolled) sphere table
            # in [N]-shaped temps — no per-lane take_along_axis.
            margs = []
            m_best = jnp.full((n_rays,), -jnp.inf)
            j_best = jnp.zeros((n_rays,), jnp.int32)
            t_prox = jnp.full((n_rays,), 1e-3)
            for si in range(S):
                oc = o - scene.spheres.centers[si][None, :]
                uoc = dot3(d, oc)
                oc2 = dot3(oc, oc)
                r2s = scene.spheres.radius_sq[si]
                disc = uoc * uoc - (oc2 - r2s)
                marg = disc / jnp.maximum(r2s, 1e-12)
                ok = ((-uoc) > 0.0) & scene.spheres.valid[si]
                marg = jnp.where(ok, marg, -jnp.inf)
                margs.append(marg)
                better = marg > m_best   # first max wins ties (argmax)
                m_best = jnp.where(better, marg, m_best)
                j_best = jnp.where(better, si, j_best)
                t_prox = jnp.where(better, jnp.maximum(-uoc, 1e-3),
                                   t_prox)
            use_proxy = live & ~hit & jnp.isfinite(m_best)
            c_prox = take_rows(scene.spheres.centers, j_best)
            p = sel3(use_proxy, o + d * t_prox[:, None], p)
            n_prox = p - c_prox
            n_prox = n_prox * jax.lax.rsqrt(jnp.maximum(
                dot3(n_prox, n_prox), 1e-60))[:, None]
            n = sel3(use_proxy, n_prox, n)
            comb2 = jnp.where(use_proxy, j_best, comb)
            shade_mask = hit | use_proxy
            win_sphere = hit & (comb_f >= 0.0) & (comb_f < S)
            sel_idx = jnp.where(win_sphere, jnp.clip(comb, 0, S - 1),
                                j_best)
            own = margs[0]
            for si in range(1, S):
                own = jnp.where(sel_idx == si, margs[si], own)
            margin_sel = jnp.where(win_sphere | use_proxy, own, jnp.inf)
            w_soft = jax.nn.sigmoid(jnp.clip(margin_sel / ht,
                                             -30.0, 30.0))
            w = (w_soft + jax.lax.stop_gradient(
                hit.astype(jnp.float32) - w_soft) if stt else w_soft)

        mats = jax.tree.map(lambda a: take_rows(a, comb2), mats_table)
        if with_diag:
            local, frozen, frozen_band, proxy_risk = _soft_lighting(
                scene, p, n, -d, mats, st_rec, cfg,
                diag_proxy=use_proxy)
            diag_acc = (
                diag_acc[0]
                + jnp.sum((frozen & shade_mask).astype(jnp.int32)),
                diag_acc[1]
                + jnp.sum((frozen_band & shade_mask).astype(jnp.int32)),
                diag_acc[2] + jnp.sum(proxy_risk.astype(jnp.int32)))
        else:
            local = _soft_lighting(scene, p, n, -d, mats, st_rec, cfg)
        local_safe = sel3(shade_mask, local,
                          jnp.broadcast_to(bg, (n_rays, 3)))
        contrib = bg[None, :] + w[:, None] * (local_safe - bg[None, :])
        acc = acc + thr * contrib * live[:, None]
        if s == B - 1:
            return acc, thr, o, d, live, diag_acc
        cont = hit & mats.is_mirror.astype(bool) & (s < cfg.max_bounces)
        thr = sel3(cont, thr * mats.mirror, thr)
        o = p + n * SHADOW_EPS
        d = sel3(cont, sh.reflect_dir(d, n), d)
        return acc, thr, o, d, cont, diag_acc

    # same static live-prefix skip as the hard replay (see the comment
    # there: a dynamic cond skip OOMs under value_and_grad)
    diag_acc = (jnp.int32(0), jnp.int32(0), jnp.int32(0))
    for s in range(B if live_segments is None
                   else min(B, max(1, live_segments))):
        t_rec = jax.lax.stop_gradient(rt_all[s])
        n_rec = jax.lax.stop_gradient(rn_all[s])
        comb_f = jax.lax.stop_gradient(rmat_all[s])
        st_rec = jax.lax.stop_gradient(rst_all[s])
        acc, thr, o, d, live, diag_acc = segment(
            s, t_rec, n_rec, comb_f, st_rec, acc, thr, o, d, live,
            diag_acc)
    if with_diag:
        return acc, {"mesh_occ_frozen": diag_acc[0],
                     "mesh_occ_in_band": diag_acc[1],
                     "proxy_mesh_risk": diag_acc[2]}
    return acc


def _chunk_records(o, d, target, weights, recs, chunk):
    """Reshape per-lane arrays to [nc, chunk, ...] (records keep their
    leading segment dim B inside each chunk: [nc, B, chunk, ...]).
    Pads with dead lanes / zero weights."""
    n = o.shape[0]
    pad = (-n) % chunk
    w = (jnp.asarray(weights, jnp.float32) if weights is not None
         else jnp.ones((n,), jnp.float32))
    if pad:
        z = jnp.zeros((pad, 3), jnp.float32).at[:, 2].set(1.0)
        o = jnp.concatenate([o, z], 0)
        d = jnp.concatenate([d, z], 0)
        if target is not None:
            target = jnp.concatenate(
                [target, jnp.zeros((pad, 3), jnp.float32)], 0)
        w = jnp.concatenate([w, jnp.zeros((pad,), jnp.float32)])

        def pad_rec(r, fill):
            shp = (r.shape[0], pad) + r.shape[2:]
            return jnp.concatenate(
                [r, jnp.full(shp, fill, r.dtype)], axis=1)
        recs = (pad_rec(recs[0], -1.0), pad_rec(recs[1], 0.0),
                pad_rec(recs[2], -1.0), pad_rec(recs[3], 0.0)) + (
            (pad_rec(recs[4], 3.0e38),) if len(recs) > 4 else ())
    nc = o.shape[0] // chunk
    cl = lambda x: x.reshape(nc, chunk, *x.shape[1:])
    # records: [B, N, ...] -> [nc, B, chunk, ...]
    cr = lambda r: jnp.moveaxis(
        r.reshape(r.shape[0], nc, chunk, *r.shape[2:]), 1, 0)
    return (cl(o), cl(d),
            cl(target) if target is not None else None, cl(w),
            tuple(cr(r) for r in recs), jnp.sum(w))


@partial(jax.jit, static_argnames=("cfg", "live_segments", "chunk"))
def trace_radiance_replay_soft(scene: Scene, o: jnp.ndarray,
                               d: jnp.ndarray, cfg: RenderConfig,
                               bvh, live_segments: int | None = None,
                               chunk: int | None = None) -> jnp.ndarray:
    """Soft records + differentiable soft replay in one jit. Forward
    equals the hard forward image (straight-through); gradients carry
    the soft silhouette/shadow terms. ``chunk`` bounds the replay's
    working set (lax.map over record chunks) at frame sizes."""
    _, recs = trace_records(scene, o, d, cfg, bvh, soft=True)
    if not chunk or chunk >= o.shape[0]:
        return replay_radiance_soft(scene, o, d, recs, cfg,
                                    live_segments=live_segments)
    n = o.shape[0]
    oc, dc, _, _, rc, _ = _chunk_records(o, d, None, None, recs, chunk)
    rad = jax.lax.map(
        lambda xs: replay_radiance_soft(scene, xs[0], xs[1], xs[2], cfg,
                                        live_segments=live_segments),
        (oc, dc, rc))
    return rad.reshape(-1, 3)[:n]


@partial(jax.jit, static_argnames=("cfg", "live_segments"))
def soft_replay_bias_counts(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                            cfg: RenderConfig, bvh,
                            live_segments: int | None = None):
    """One soft-records pass + diagnostic replay -> the biased-regime
    lane counts of ``replay_radiance_soft(with_diag=True)``:
    ``{mesh_occ_frozen, proxy_mesh_risk}`` (both int32 scalars). Cheap
    enough to run once at fit start (fit() does, and warns if nonzero);
    not intended for the per-step hot path."""
    _, recs = trace_records(scene, o, d, cfg, bvh, soft=True)
    _, diag = replay_radiance_soft(scene, o, d, recs, cfg,
                                   live_segments=live_segments,
                                   with_diag=True)
    return diag


def _mse(rad, target, weights):
    if weights is None:
        return jnp.mean((rad - target) ** 2)
    return (jnp.sum(((rad - target) ** 2) * weights[:, None])
            / (jnp.sum(weights) * 3.0))


@partial(jax.jit, static_argnames=("cfg", "live_segments", "chunk"))
def soft_replay_value_and_grad(template: Scene, params, o, d, target,
                               cfg: RenderConfig, bvh, weights=None,
                               live_segments: int | None = None,
                               chunk: int | None = None):
    """Fused SOFT fwd+bwd step: min-mode records
    with the CURRENT params + pixel-MSE value_and_grad through the soft
    replay — the fast path for silhouette fitting (the composed
    remat+chunked path remains the exact-reference fallback).
    ``weights`` (optional [N]): per-lane loss weights (e.g. zero on the
    block-raygen pad margin); loss becomes the weighted mean.
    ``chunk`` (static): scan-of-vjp gradient accumulation over record
    chunks — bounds the replay's backward working set at any frame size
    (same pattern as fit.make_chunked_value_and_grad; grads identical
    to the unchunked mean-MSE gradient)."""
    from unity_raytracer_tpu.fit import set_params

    scene_now = set_params(template, params)
    _, recs = trace_records(scene_now, o, d, cfg, bvh, soft=True)

    if not chunk or chunk >= o.shape[0]:
        def loss_fn(params):
            s = set_params(template, params)
            rad = replay_radiance_soft(s, o, d, recs, cfg,
                                       live_segments=live_segments)
            return _mse(rad, target, weights)

        return jax.value_and_grad(loss_fn)(params)

    oc, dc, tc, wc, rc, n_eff = _chunk_records(o, d, target, weights,
                                               recs, chunk)

    def body(carry, xs):
        loss_sum, grad_sum = carry
        o_i, d_i, t_i, w_i, r_i = xs

        def chunk_loss(p):
            s = set_params(template, p)
            rad = replay_radiance_soft(s, o_i, d_i, r_i, cfg,
                                       live_segments=live_segments)
            return jnp.sum(((rad - t_i) ** 2) * w_i[:, None])

        l_i, g_i = jax.value_and_grad(chunk_loss)(params)
        return (loss_sum + l_i,
                jax.tree.map(jnp.add, grad_sum, g_i)), None

    zero = (jnp.zeros((), jnp.float32),
            jax.tree.map(jnp.zeros_like, params))
    (loss, grads), _ = jax.lax.scan(body, zero, (oc, dc, tc, wc, rc))
    denom = n_eff * 3.0
    return loss / denom, jax.tree.map(lambda g: g / denom, grads)


@partial(jax.jit, static_argnames=("cfg",))
def trace_radiance_replay(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                          cfg: RenderConfig, bvh) -> jnp.ndarray:
    """Forward records + differentiable replay in one jit — the radiance
    equals ``trace_radiance``'s to fp-reassociation noise, and gradients
    flow to every fit.PARAM_PATHS parameter class but 'mesh_verts'."""
    _, recs = trace_records(scene, o, d, cfg, bvh)
    return replay_radiance(scene, o, d, recs, cfg)


def live_depth(records) -> int:
    """Number of bounce segments with >= 1 live record — the exact
    static prefix for ``live_segments``. Host-side (one tiny sync);
    stable across a fit (mirror topology does not change), so measure
    once and reuse."""
    rt = records[0]
    return int(np.asarray(jnp.any(rt >= 0.0, axis=1).sum()))


@partial(jax.jit, static_argnames=("cfg", "live_segments"))
def replay_value_and_grad(template: Scene, params, o, d, target,
                          cfg: RenderConfig, bvh, weights=None,
                          live_segments: int | None = None):
    """One fused fwd+bwd step: hard forward (records) with the
    CURRENT params + pixel-MSE value_and_grad through the replay.
    ``target`` is radiance on the 0-255 scale, shaped [N,3] like the
    ray batch. This is the unit bench.py times as fwd+bwd."""
    from unity_raytracer_tpu.fit import set_params

    scene_now = set_params(template, params)
    _, recs = trace_records(scene_now, o, d, cfg, bvh)

    def loss_fn(params):
        s = set_params(template, params)
        rad = replay_radiance(s, o, d, recs, cfg,
                              live_segments=live_segments)
        return _mse(rad, target, weights)

    return jax.value_and_grad(loss_fn)(params)
