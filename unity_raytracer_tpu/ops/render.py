"""Wavefront renderer: raygen -> bounce chain -> image.

The reference's per-pixel recursion (Demo-RayTracing/RayTracingSetup.cs:
288-301 pixel loop, :304-366 recursive ``Shade``) is re-designed as a batched
bounce chain over flat ray tensors:

* **linear chain** (`_trace_chain`) — the exact reference semantics: only
  mirrors spawn secondary rays, so the ray tree is a path; carried state is
  ``(origin, dir, throughput, active, accum)`` and depth is a static unrolled
  loop (max_bounces is tiny and static, which XLA fuses best).
* **branching tree** (`_trace_tree`) — the refraction extension (baseline
  config 2): dielectric hits spawn reflect+refract children; recursion is
  static Python recursion to a fixed depth, each node fully batched.

Radiance accumulates on the reference's 0-255 Rgb scale; `render` divides by
255 at the end like ``Rgb.Color`` (Data/Shading/Rgb.cs:13).

All ``where`` selects use guarded operands (no inf/NaN on masked lanes) so
the whole pipeline is cleanly differentiable — masked-out lanes cannot
poison gradients.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from unity_raytracer_tpu.models.camera import (
    Camera, generate_rays, generate_rays_blocks)
from unity_raytracer_tpu.models.scene import Scene
from unity_raytracer_tpu.ops import shade as sh
from unity_raytracer_tpu.ops.intersect import Hit, dot3, nearest_hit
from unity_raytracer_tpu.utils.config import RenderConfig

SHADOW_EPS = sh.SHADOW_EPS


def _local_radiance(scene: Scene, o, d, cfg: RenderConfig,
                    hit: Hit, bvh=None,
                    active: jnp.ndarray | None = None,
                    with_stats: bool = False):
    """Shared per-segment work: surface point, attributes, local shading.

    Returns (contrib [N,3] — local radiance or background, p, n, mats,
    hit_mask); with ``with_stats`` the tuple is paired with the number of
    live shadow-query lanes this segment issued. Masked lanes carry safe
    (finite) values.
    """
    hit_mask = hit.is_hit
    soft_temp = cfg.diff.soft_hit_temp
    if soft_temp > 0.0:
        # SoftRas-style silhouette relaxation for spheres: miss rays adopt a
        # proxy hit on their best near-miss sphere (shaded at the closest-
        # approach point) so the soft blend weight has a sensible color to
        # blend toward; forward values stay exactly hard via straight-through.
        # Computed as a running argmax over the (small, unrolled) sphere
        # table in [N]-shaped temps — no per-lane gathers.
        from unity_raytracer_tpu.ops.intersect import KIND_SPHERE
        S = scene.spheres.count
        margs = []
        m_best = jnp.full(hit_mask.shape, -jnp.inf)
        j_best = jnp.zeros(hit_mask.shape, jnp.int32)
        t_close_best = jnp.full(hit_mask.shape, 1e-3)
        for si in range(S):
            oc = o - scene.spheres.centers[si][None, :]
            uoc = dot3(d, oc)
            oc2 = dot3(oc, oc)
            r2s = scene.spheres.radius_sq[si]
            disc = uoc * uoc - (oc2 - r2s)
            marg = disc / jnp.maximum(r2s, 1e-12)
            okm = ((-uoc) > 0.0) & scene.spheres.valid[si]
            marg = jnp.where(okm, marg, -jnp.inf)
            margs.append(marg)
            better = marg > m_best   # first max wins ties (== argmax)
            m_best = jnp.where(better, marg, m_best)
            j_best = jnp.where(better, si, j_best)
            t_close_best = jnp.where(better, jnp.maximum(-uoc, 1e-3),
                                     t_close_best)
        proxy_ok = jnp.isfinite(m_best)
        use_proxy = ~hit_mask & proxy_ok
        hit = Hit(
            t=jnp.where(use_proxy, t_close_best, hit.t),
            kind=jnp.where(use_proxy, KIND_SPHERE, hit.kind),
            index=jnp.where(use_proxy, j_best, hit.index),
            mesh_index=hit.mesh_index, mesh_n=hit.mesh_n)
        shade_mask = hit_mask | use_proxy
        # winner margin: sphere hits use their own margin (relaxes the
        # sphere's own silhouette); non-sphere hits stay hard (+inf)
        win_sphere = hit_mask & (hit.kind == KIND_SPHERE)
        sel_idx = jnp.where(win_sphere,
                            jnp.clip(hit.index, 0, max(S - 1, 0)),
                            j_best)
        own = margs[0] if S else jnp.full(hit_mask.shape, -jnp.inf)
        for si in range(1, S):
            own = jnp.where(sel_idx == si, margs[si], own)
        margin_sel = jnp.where(win_sphere | use_proxy, own, jnp.inf)
        w_soft = jax.nn.sigmoid(
            jnp.clip(margin_sel / soft_temp, -30.0, 30.0))
        if cfg.diff.straight_through:  # forward hard, backward soft
            w = w_soft + jax.lax.stop_gradient(
                hit_mask.astype(jnp.float32) - w_soft)
        else:
            w = w_soft
    else:
        shade_mask = hit_mask
        w = hit_mask.astype(jnp.float32)

    t_safe = jnp.where(shade_mask, hit.t, 1.0)
    p = o + d * t_safe[:, None]
    n, mats = sh.surface_attributes(scene, p, hit)
    v = -d  # unit direction back toward the segment origin (= reference's
    #         normalize(rayOrigin - surfacePoint), RayTracingSetup.cs:325)
    shadow_mask = shade_mask if active is None else (shade_mask & active)
    local, n_shadow = sh.direct_lighting(
        scene, p, n, v, mats,
        soft_shadow_temp=cfg.diff.soft_shadow_temp,
        straight_through=cfg.diff.straight_through, bvh=bvh,
        kernel=cfg.kernel, mask=shadow_mask,
        light_cull=cfg.light_cull, with_stats=True)
    bg = jnp.asarray(cfg.background, jnp.float32) * 255.0
    local_safe = jnp.where(shade_mask[:, None], local, bg[None, :])
    contrib = bg[None, :] + w[:, None] * (local_safe - bg[None, :])
    out = (contrib, p, n, mats, hit_mask)
    return (out, n_shadow) if with_stats else out


def _trace_chain(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                 cfg: RenderConfig, bvh=None,
                 with_stats: bool = False) -> jnp.ndarray:
    """Mirror-only linear bounce chain — exact reference semantics.

    Segment s contributes ``prod(mirror_0..s-1) * local_s``; the chain stops
    at the first non-mirror hit or miss, and the bounce cap means segment
    depth max_bounces shades locally but spawns nothing
    (``IsMirror && bounce < MaxReflectionBounces``, RayTracingSetup.cs:358).

    Dead-lane handling:

    * retired lanes are culled from the walk via ``t_max = -1``; with
      block-ordered lanes (generate_rays_blocks) the surviving bounce
      rays stay spatially clustered, so most walk-kernel blocks turn
      all-dead and exit at once;
    * a whole segment with ZERO live lanes is skipped entirely with one
      ``lax.cond`` (the flagship scene is dead after segment 1 — live
      counts [2.07M, 126k, 0, 0, 0]).

    ``with_stats`` additionally returns ``(live [B], shadow_live [B])`` lane
    counts per segment — the honest-ray-accounting inputs for bench.py.
    """
    n_rays = o.shape[0]
    acc0 = jnp.zeros((n_rays, 3), jnp.float32)
    thr0 = jnp.ones((n_rays, 3), jnp.float32)
    active0 = jnp.ones((n_rays,), bool)

    def live_seg(args):
        o, d, thr, active, acc, depth = args
        # retired lanes are culled from the traversal union via t_max=-1
        tmax = jnp.where(active, 3.0e38, -1.0)
        with jax.named_scope("nearest_hit"):
            hit = nearest_hit(scene, o, d, bvh=bvh, kernel=cfg.kernel,
                              t_max=tmax)
        with jax.named_scope("shade"):
            (contrib, p, n, mats, hit_mask), n_shadow = _local_radiance(
                scene, o, d, cfg, hit, bvh=bvh, active=active,
                with_stats=True)
        acc = acc + thr * contrib * active[:, None]
        with jax.named_scope("bounce_update"):
            cont = (active & hit_mask & mats.is_mirror
                    & (depth < cfg.max_bounces))
            thr = jnp.where(cont[:, None], thr * mats.mirror, thr)
            o = p + n * SHADOW_EPS    # Reflect origin offset (:368-373)
            d = jnp.where(cont[:, None], sh.reflect_dir(d, n), d)
        return (o, d, thr, cont, acc), n_shadow

    def dead_seg(args):
        o, d, thr, active, acc, depth = args
        return (o, d, thr, active, acc), jnp.int32(0)

    def bounce(carry, depth):
        o, d, thr, active, acc = carry
        n_live = jnp.sum(active.astype(jnp.int32))
        carry, n_shadow = jax.lax.cond(
            n_live > 0, live_seg, dead_seg, (o, d, thr, active, acc, depth))
        return carry, (n_live, n_shadow)

    # lax.scan: the bounce body compiles ONCE regardless of depth — keeps
    # XLA program size (and compile time) flat vs depth, unlike a
    # Python unroll which inlines the intersect+shade stage per segment.
    # cfg.remat checkpoints the body so the backward pass recomputes each
    # segment from its [N]-sized carry instead of storing the full
    # intersect+shade residuals (20+ [N,*] temps/segment at 1080p).
    bounce_fn = jax.checkpoint(bounce) if cfg.remat else bounce
    (_, _, _, _, acc), stats = jax.lax.scan(
        bounce_fn, (o, d, thr0, active0, acc0),
        jnp.arange(cfg.max_bounces + 1), unroll=1)
    if with_stats:
        return acc, stats
    return acc


def _trace_tree(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                cfg: RenderConfig, depth: int, bvh=None,
                with_stats: bool = False) -> jnp.ndarray:
    """Whitted tree with mirror + dielectric branches, evaluated as a
    LEVEL-SYNCHRONOUS WAVEFRONT.

    A naive recursive tree would inline 2^depth intersect+shade stages and
    blow up XLA compile time exponentially. Instead each depth level is ONE
    batched stage over a widened lane array: every dielectric hit forks its
    lane into (reflect, refract) children, and a segment scatter-add folds
    each lane's weighted radiance back into its primary ray. Lane arrays
    are kept at O(cfg.tree_cap * n_rays) by dead-fork compaction — the
    exactly-dead children (zero reflect weight, TIR refract, misses) that
    would otherwise make lane count 2^depth are sorted out after each
    fork. Mirror-only scenes should use the linear chain instead
    (mode='scan').

    The reflect child is shared between mirrors (weight
    ``is_mirror*MirrorReflectance``, reference RayTracingSetup.cs:358-363)
    and dielectrics (weight ``is_dielectric*F*transparency``, Schlick
    Fresnel — the refraction extension the reference lacks).
    """
    del depth  # the wavefront always starts at the root
    n_rays = o.shape[0]
    branching = scene_has_dielectrics_static(scene)

    acc = jnp.zeros((n_rays, 3), jnp.float32)
    parent = jnp.arange(n_rays, dtype=jnp.int32)   # lane -> primary ray
    weight = jnp.ones((n_rays, 3), jnp.float32)    # accumulated throughput
    live = jnp.ones((n_rays,), bool)
    # live weighted lanes dropped by tree_cap compaction (accuracy loss
    # when > 0) — returned as a plain array (trace_radiance_tree_stats)
    n_truncated = jnp.int32(0)

    for level in range(cfg.max_bounces + 1):
        tmax = jnp.where(live, 3.0e38, -1.0)
        hit = nearest_hit(scene, o, d, bvh=bvh, kernel=cfg.kernel,
                          t_max=tmax)
        contrib, p, n, mats, hit_mask = _local_radiance(
            scene, o, d, cfg, hit, bvh=bvh, active=live)
        lane_rad = weight * contrib * live[:, None]
        acc = acc.at[parent].add(lane_rad)
        if level == cfg.max_bounces:
            break

        hm = hit_mask[:, None]
        d_dot_n = dot3(d, n)[:, None]
        entering = (d_dot_n < 0.0)
        n_eff = jnp.where(entering, n, -n)
        is_die = mats.is_dielectric[:, None]
        is_mir = mats.is_mirror[:, None]

        n_refl = jnp.where(is_die, n_eff, n)
        ro = p + n_refl * SHADOW_EPS   # Reflect origin offset (:368-373)
        rd = sh.reflect_dir(d, n_refl)
        rd_safe = jnp.where(hm, rd, jnp.asarray([0.0, 0.0, 1.0]))

        ior = mats.ior
        n1 = jnp.where(entering[:, 0], 1.0, ior)
        n2 = jnp.where(entering[:, 0], ior, 1.0)
        cos_i = jnp.abs(d_dot_n[:, 0])
        refr_d, tir = sh.refract_dir(d, n_eff, n1 / n2)
        fres = jnp.where(tir, 1.0, sh.schlick_fresnel(cos_i, n1, n2))[:, None]

        w_refl = (is_mir * mats.mirror
                  + is_die * fres * mats.transparency) * hm
        refl_live = live & hit_mask & (mats.is_mirror | mats.is_dielectric)

        if branching:
            to = p - n_eff * SHADOW_EPS
            refr_ok = hm & is_die & ~tir[:, None]
            refr_safe = jnp.where(refr_ok, refr_d,
                                  jnp.asarray([0.0, 0.0, 1.0]))
            w_refr = (is_die * (1.0 - fres) * mats.transparency
                      * refr_ok.astype(jnp.float32))
            refr_live = live & hit_mask & mats.is_dielectric & ~tir
            o = jnp.concatenate([ro, to], axis=0)
            d = jnp.concatenate([rd_safe, refr_safe], axis=0)
            weight = jnp.concatenate([weight * w_refl, weight * w_refr],
                                     axis=0)
            parent = jnp.concatenate([parent, parent], axis=0)
            live = jnp.concatenate([refl_live, refr_live], axis=0)
            # dead-fork compaction: most children are exactly dead
            # (non-dielectric/non-mirror reflect weight 0, TIR refract
            # children, misses); sort the live-and-weighted lanes to the
            # front and truncate to the static cap so lane count stays
            # O(cap * n_rays) instead of 2^depth. Live lanes beyond the
            # cap (pathological full-screen dielectric chains) drop
            # weakest-first — standard throughput culling.
            cap = (cfg.tree_cap or 0) * n_rays
            if cap and o.shape[0] > cap:
                live = live & ((weight[:, 0] != 0.0) | (weight[:, 1] != 0.0)
                               | (weight[:, 2] != 0.0))
                score = jnp.where(live, dot3(jnp.abs(weight), jnp.ones(3)),
                                  -1.0)
                n_truncated = n_truncated + jnp.maximum(
                    jnp.sum(live.astype(jnp.int32)) - cap, 0)
                order = jnp.argsort(-score)[:cap]
                # ONE gather of the packed per-lane state instead of
                # five
                state = jnp.concatenate(
                    [o, d, weight,
                     jax.lax.bitcast_convert_type(
                         parent, jnp.float32)[:, None],
                     live.astype(jnp.float32)[:, None]], axis=1)
                sel = jnp.take(state, order, axis=0)
                o = sel[:, 0:3]
                d = sel[:, 3:6]
                weight = sel[:, 6:9]
                parent = jax.lax.bitcast_convert_type(sel[:, 9],
                                                      jnp.int32)
                live = sel[:, 10] > 0.5
        else:
            o, d = ro, rd_safe
            weight = weight * w_refl
            live = refl_live
    if with_stats:
        return acc, n_truncated
    return acc


_HAS_DIELECTRIC_HINT: dict = {}


def scene_has_dielectrics_static(scene: Scene) -> bool:
    """Static (trace-time) dielectric hint.

    Inside jit the scene leaves are tracers, so the concrete flag must be
    decided before tracing; `trace_radiance` resolves cfg.mode='auto' outside
    jit and threads the decision through as the static ``mode``.
    """
    try:
        return scene.has_dielectrics  # concrete scene
    except jax.errors.TracerArrayConversionError:
        return True  # conservative under jit if mode was not resolved


def resolve_mode(scene: Scene, cfg: RenderConfig) -> RenderConfig:
    """Resolve mode='auto' on a concrete scene (call outside jit)."""
    if cfg.mode != "auto":
        return cfg
    try:
        tree = scene.has_dielectrics
    except jax.errors.TracerArrayConversionError as e:
        raise ValueError(
            "RenderConfig.mode='auto' must be resolved on a concrete scene "
            "before jit; call resolve_mode() first.") from e
    return cfg.with_(mode="tree" if tree else "scan")


@partial(jax.jit, static_argnames=("cfg",))
def trace_radiance(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                   cfg: RenderConfig, bvh=None) -> jnp.ndarray:
    """Radiance [N,3] (0-255 scale) for arbitrary ray batches."""
    mode = cfg.mode
    if mode == "auto":  # under jit this must have been resolved already
        mode = "tree"
    if mode == "scan":
        return _trace_chain(scene, o, d, cfg, bvh=bvh)
    return _trace_tree(scene, o, d, cfg, 0, bvh=bvh)


@partial(jax.jit, static_argnames=("cfg",))
def trace_radiance_stats(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                         cfg: RenderConfig, bvh=None):
    """Scan-mode trace that also returns per-segment (live nearest lanes,
    live shadow lanes) counts — bench.py's honest-ray-accounting probe."""
    return _trace_chain(scene, o, d, cfg, bvh=bvh, with_stats=True)


@partial(jax.jit, static_argnames=("cfg",))
def trace_radiance_tree_stats(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                              cfg: RenderConfig, bvh=None):
    """Tree-mode trace returning ``(radiance [N,3], n_truncated [])`` —
    the count of live weighted lanes the tree_cap compaction dropped
    (accuracy loss iff > 0); bench.py, chip_smoke.py and tests read
    it."""
    return _trace_tree(scene, o, d, cfg, 0, bvh=bvh, with_stats=True)


@partial(jax.jit, static_argnames=("cfg",))
def _frame_core(scene: Scene, cam: Camera, cfg: RenderConfig,
                bvh=None) -> jnp.ndarray:
    """Jitted block-order raygen -> trace -> unswizzle -> [H,W,3] image.

    No gathers anywhere: rays are generated directly in pixel-block order
    (models/camera.generate_rays_blocks, integer lane math) and the image
    is restored with one reshape+transpose (utils/swizzle.unswizzle_image).
    """
    from unity_raytracer_tpu.utils.swizzle import unswizzle_image
    with jax.named_scope("raygen"):
        o, d = generate_rays_blocks(cam, cfg.block_size)
    rad = trace_radiance(scene, o, d, cfg, bvh=bvh)
    with jax.named_scope("image_assembly"):
        return unswizzle_image(rad, cam.width, cam.height,
                               cfg.block_size) / 255.0


def render_frame(scene: Scene, cam: Camera, cfg: RenderConfig,
                 bvh=None) -> jnp.ndarray:
    """Full-frame render, one jit: the benchmark's timed unit.

    Primary rays are emitted in ``cfg.block_size``-square screen-block lane
    order so every walk-kernel block covers a compact square of pixels;
    the image is un-swizzled by a pure relayout on the way out. Exact same
    image as row-major order.
    """
    cfg = resolve_mode(scene, cfg)
    return _frame_core(scene, cam, cfg, bvh)


def render(scene: Scene, cam: Camera, cfg: RenderConfig,
           bvh=None) -> jnp.ndarray:
    """Render the full image [H,W,3] on the display (0-1) scale.

    Host-side wrapper: resolves 'auto' mode, builds the BVH if
    ``cfg.use_bvh`` and none was passed, and jit-runs the block-ordered
    frame — chunked over rays if ``cfg.ray_chunk`` bounds the working set.
    """
    cfg = resolve_mode(scene, cfg)
    if cfg.use_bvh and bvh is None:
        from unity_raytracer_tpu.ops import bvh as bvhmod
        bvh = bvhmod.prepare_bvh(scene, cfg)
    n = cam.width * cam.height
    if cfg.ray_chunk and cfg.ray_chunk < n:
        return _frame_chunked(scene, cam, cfg, bvh)
    return _frame_core(scene, cam, cfg, bvh)


@partial(jax.jit, static_argnames=("cfg",))
def _frame_chunked(scene: Scene, cam: Camera, cfg: RenderConfig,
                   bvh=None) -> jnp.ndarray:
    """Chunked frame (bounded working set): lax.map over ray chunks.

    One jit like _frame_core — raygen compiles in the same context both
    ways, so chunked and unchunked images agree to FP-reassociation
    noise (tested at rtol 1e-6 in practice).
    """
    from unity_raytracer_tpu.utils.swizzle import unswizzle_image
    o, d = generate_rays_blocks(cam, cfg.block_size)
    total = o.shape[0]
    c = cfg.ray_chunk
    pad = (-total) % c
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)
                             .at[:, 2].set(1.0)], axis=0)
        d = jnp.concatenate([d, jnp.zeros((pad, 3), d.dtype)
                             .at[:, 2].set(1.0)], axis=0)
    oc = o.reshape(-1, c, 3)
    dc = d.reshape(-1, c, 3)
    rad = jax.lax.map(
        lambda od: trace_radiance(scene, od[0], od[1], cfg, bvh=bvh),
        (oc, dc)).reshape(-1, 3)[:total]
    img = unswizzle_image(rad, cam.width, cam.height, cfg.block_size)
    return img / 255.0
