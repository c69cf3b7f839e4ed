"""Differentiable inverse rendering (baseline config 4).

Recover scene parameters (sphere positions, materials, light intensities)
from a target image by pixel-gradient descent — the capability the
reference's C# forward tracer could never have. The forward model is the
same wavefront renderer; gradients flow through the unrolled bounce chain
(smoothed visibility for silhouettes, see utils/config.DiffConfig).

Design: the optimizable parameters are a small pytree ``FitParams``
installed into a template scene with ``dataclasses.replace`` — the scene
stays one static-shape pytree, so the whole optimization step jits once.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from unity_raytracer_tpu.models.camera import Camera
from unity_raytracer_tpu.models.scene import Scene
from unity_raytracer_tpu.ops.render import render, resolve_mode
from unity_raytracer_tpu.utils.config import DiffConfig, RenderConfig
from unity_raytracer_tpu.utils import checkpoint as ckpt


# Parameter classes that can be optimized; each names a leaf of the scene.
PARAM_PATHS = {
    "sphere_centers": ("spheres", "centers"),
    "sphere_radius_sq": ("spheres", "radius_sq"),
    "sphere_diffuse": ("spheres", "materials", "diffuse"),
    "sphere_ambient": ("spheres", "materials", "ambient"),
    "sphere_specular": ("spheres", "materials", "specular"),
    "sphere_mirror": ("spheres", "materials", "mirror"),
    "tri_verts": ("triangles", "verts"),
    "tri_diffuse": ("triangles", "materials", "diffuse"),
    "light_positions": ("lights", "positions"),
    "light_intensities": ("lights", "intensities"),
    # mesh-vertex deformation (the 100k-tri mesh class): gradients flow
    # via ops/bvh.bind_verts — the loss functions below re-bind the
    # BVH's epilogue triangle table to the CURRENT verts each step.
    # Contract: composed path, BVH built with
    # cfg.bvh_pad >= the max expected displacement (bind_verts doc).
    "mesh_verts": ("meshes", "verts"),
}


def get_params(scene: Scene, names: Tuple[str, ...]) -> Dict[str, jnp.ndarray]:
    out = {}
    for name in names:
        node = scene
        for attr in PARAM_PATHS[name]:
            node = getattr(node, attr)
        out[name] = node
    return out


def set_params(scene: Scene, params: Dict[str, jnp.ndarray]) -> Scene:
    for name, value in params.items():
        path = PARAM_PATHS[name]
        scene = _replace_path(scene, path, value)
    return scene


def _replace_path(node, path, value):
    if len(path) == 1:
        return dataclasses.replace(node, **{path[0]: value})
    child = getattr(node, path[0])
    return dataclasses.replace(
        node, **{path[0]: _replace_path(child, path[1:], value)})


@dataclass(frozen=True)
class FitConfig:
    param_names: Tuple[str, ...] = ("sphere_centers", "sphere_diffuse")
    learning_rate: float = 0.05
    steps: int = 200
    soft_shadow_temp: float = 1.0
    soft_hit_temp: float = 0.05
    log_every: int = 20
    checkpoint_every: int = 0          # 0 = disabled
    checkpoint_path: Optional[str] = None
    use_replay: bool = False           # soft record-replay step
    #   (ops/replay.soft_replay_value_and_grad): one hard forward with
    #   min-mode shadow records + differentiable soft replay, no walk in
    #   the backward. Needs scan mode (mirror chains); silhouette
    #   gradients for sphere/loose geometry are exact, mesh-occluder
    #   gradient terms are frozen (see replay_radiance_soft docstring).
    prefix_guard_every: int = 25       # replay path: every K steps,
    #   re-measure the live bounce depth on the CURRENT params; if the
    #   mirror topology deepened past the static live-segment prefix
    #   (which would silently truncate radiance/gradients), bump the
    #   prefix and re-jit. 0 disables the guard.


class FitResult(NamedTuple):
    scene: Scene
    params: Dict[str, jnp.ndarray]
    losses: np.ndarray
    step: int
    # replay path only: the final static live-segment prefix (None on
    # the composed path). > the initial measurement iff the prefix
    # guard fired and re-jitted mid-fit.
    live_prefix: Optional[int] = None


def make_loss_fn(template: Scene, cam: Camera, rcfg: RenderConfig,
                 target: jnp.ndarray, bvh=None) -> Callable:
    """Pixel-MSE loss. ``rcfg`` should carry a soft DiffConfig so silhouette
    gradients exist; forward stays hard when straight_through=True.

    ``bvh``: prebuilt mesh BVH (ops/bvh.prepare_bvh) — REQUIRED for
    use_bvh scenes (the loss runs under jit, where a host-side build is
    impossible). Mesh geometry is never an optimizable class
    (PARAM_PATHS), so a fixed BVH stays valid across steps."""
    rcfg = resolve_mode(template, rcfg)

    def loss_fn(params: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        scene = set_params(template, params)
        b = _bind(bvh, scene)
        img = render(scene, cam, rcfg, bvh=b)
        return jnp.mean((img - target) ** 2)

    return loss_fn


def _bind(bvh, scene):
    """Re-bind the BVH epilogue verts to the current scene (mesh-vertex
    gradients, ops/bvh.bind_verts). Constant-folds to a no-op when the
    mesh verts are not a traced parameter."""
    if bvh is None:
        return None
    from unity_raytracer_tpu.ops.bvh import bind_verts
    return bind_verts(bvh, scene)


def make_chunked_value_and_grad(template: Scene, rcfg: RenderConfig,
                                o: jnp.ndarray, d: jnp.ndarray,
                                target: jnp.ndarray, bvh=None,
                                chunk: Optional[int] = None,
                                weights: Optional[jnp.ndarray] = None
                                ) -> Callable:
    """Chunked gradient accumulation for the composed differentiable path.

    ``lax.map``-chunking the forward (ops/render._frame_chunked) does NOT
    bound backward memory — the scan stores every chunk's residuals. This
    builds the gradient the memory-safe way: one ``lax.scan`` over ray
    chunks whose body runs ``value_and_grad`` of that chunk's
    sum-of-squared-error and adds it into a running (loss, grad)
    accumulator. Peak residency is one chunk's residuals + one grad
    pytree, independent of the total ray count; grads are mathematically
    identical to the unchunked mean-MSE gradient (sum of per-chunk sums,
    divided once at the end). Combine with ``rcfg.remat`` to also bound
    the per-chunk bounce-chain residuals.

    ``target``: radiance on the 0-255 scale, [N,3] aligned with (o, d).
    ``weights`` (optional [N]): per-lane loss weights — e.g. 0 on the
    pad-margin lanes of block-ordered raygen; the loss is the weighted
    mean. Returns ``f(params) -> (loss, grads)``, jittable.
    """
    from unity_raytracer_tpu.ops.render import trace_radiance

    rcfg = resolve_mode(template, rcfg)
    n = o.shape[0]
    c = chunk or rcfg.ray_chunk or n
    c = min(c, n)
    pad = (-n) % c
    w = (jnp.asarray(weights, jnp.float32) if weights is not None
         else jnp.ones((n,), jnp.float32))
    n_eff = jnp.sum(w)
    if pad:
        z = jnp.zeros((pad, 3), jnp.float32).at[:, 2].set(1.0)
        o = jnp.concatenate([o, z], axis=0)
        d = jnp.concatenate([d, z], axis=0)
        target = jnp.concatenate([target,
                                  jnp.zeros((pad, 3), jnp.float32)], 0)
        w = jnp.concatenate([w, jnp.zeros((pad,), jnp.float32)])
    oc = o.reshape(-1, c, 3)
    dc = d.reshape(-1, c, 3)
    tc = target.reshape(-1, c, 3)
    wc = w.reshape(-1, c)

    def value_and_grad_fn(params):
        def body(carry, xs):
            loss_sum, grad_sum = carry
            o_i, d_i, t_i, w_i = xs

            def chunk_loss(p):
                s = set_params(template, p)
                rad = trace_radiance(s, o_i, d_i, rcfg,
                                     bvh=_bind(bvh, s))
                return jnp.sum(((rad - t_i) ** 2) * w_i[:, None])

            l_i, g_i = jax.value_and_grad(chunk_loss)(params)
            return (loss_sum + l_i,
                    jax.tree.map(jnp.add, grad_sum, g_i)), None

        zero = (jnp.zeros((), jnp.float32),
                jax.tree.map(jnp.zeros_like, params))
        (loss, grads), _ = jax.lax.scan(body, zero, (oc, dc, tc, wc))
        denom = n_eff * 3.0
        return loss / denom, jax.tree.map(lambda g: g / denom, grads)

    return value_and_grad_fn


def fit(template: Scene, cam: Camera, rcfg: RenderConfig,
        target: jnp.ndarray, cfg: FitConfig,
        init_params: Optional[Dict[str, jnp.ndarray]] = None,
        resume_from: Optional[str] = None,
        grad_transform: Optional[Callable] = None,
        bvh=None) -> FitResult:
    """Adam descent on pixel MSE.

    ``grad_transform(grads, params) -> grads`` hooks in multi-device grad
    psum when running under shard_map (see parallel/).
    ``bvh``: prebuilt mesh BVH for use_bvh scenes (see make_loss_fn).
    When ``rcfg.ray_chunk`` is set the step uses chunked gradient
    accumulation (make_chunked_value_and_grad) so frame-sized fits run in
    bounded memory; combine with ``rcfg.remat`` for deep bounce chains.
    """
    rcfg = resolve_mode(template, rcfg).with_(
        diff=DiffConfig(soft_shadow_temp=cfg.soft_shadow_temp,
                        soft_hit_temp=cfg.soft_hit_temp,
                        straight_through=True))
    params = dict(init_params or get_params(template, cfg.param_names))
    live_prefix = None
    measure_prefix = None
    make_replay_vg = None
    if cfg.use_replay:
        from unity_raytracer_tpu.models.camera import generate_rays_blocks
        from unity_raytracer_tpu.ops.replay import (
            soft_replay_value_and_grad)
        from unity_raytracer_tpu.utils.swizzle import swizzle_image
        if rcfg.mode != "scan":
            raise ValueError("FitConfig.use_replay needs mode='scan' (the "
                             "records follow mirror chains only)")
        rcfg_m = rcfg
        o, d = generate_rays_blocks(cam, rcfg.block_size)
        tgt_rad = swizzle_image(target, rcfg.block_size) * 255.0
        lane_w = swizzle_image(
            jnp.ones((cam.height, cam.width, 1), jnp.float32),
            rcfg.block_size)[:, 0]
        # static live-segment prefix for the replay (exact skip of the
        # all-dead bounce tail), measured on the scene actually being
        # optimized (template + init params — NOT the ground-truth
        # template, whose mirror topology can differ) with
        # +1 margin for a chain extending by one. The periodic guard
        # below catches deeper extensions mid-fit and re-jits.
        from unity_raytracer_tpu.ops.replay import (live_depth,
                                                    trace_records)

        def measure_prefix(p):
            _, recs = trace_records(set_params(template, p), o, d,
                                    rcfg_m, bvh, soft=True)
            return live_depth(recs)

        k = min(rcfg_m.max_bounces + 1, measure_prefix(params) + 1)
        # chunk the pure-jnp replay at frame scale (the records pass
        # streams fine; the replay's [N,L,S] temps don't)
        ch = rcfg.ray_chunk or ((1 << 18) if o.shape[0] > (1 << 18)
                                else None)
        scale = 1.0 / (255.0 * 255.0)  # radiance-scale MSE -> image MSE

        def make_replay_vg(k):
            return lambda p: jax.tree.map(
                lambda x: x * scale,
                soft_replay_value_and_grad(template, p, o, d, tgt_rad,
                                           rcfg_m, bvh, weights=lane_w,
                                           live_segments=k, chunk=ch))

        live_prefix = k
        value_and_grad = make_replay_vg(k)
        # one-time honesty check: warn when the fit
        # starts inside the soft replay's biased mesh-shadow regime —
        # frozen d(st) terms through mesh occluders / unqueried proxy
        # shadow rays entering the mesh box
        from unity_raytracer_tpu.ops.replay import soft_replay_bias_counts
        diag = jax.tree.map(int, soft_replay_bias_counts(
            set_params(template, params), o, d, rcfg_m, bvh,
            live_segments=k))
        if diag["mesh_occ_frozen"] or diag["proxy_mesh_risk"]:
            print(f"[fit] WARNING: soft-replay mesh-shadow bias regime "
                  f"active — {diag['mesh_occ_frozen']} lanes with frozen "
                  f"mesh-occluder shadow terms, "
                  f"{diag['proxy_mesh_risk']} proxy lanes with unqueried "
                  f"mesh-shadow risk; gradients for those lanes drop "
                  f"mesh silhouette terms (use the composed path for "
                  f"exactness)")
    elif rcfg.ray_chunk:
        from unity_raytracer_tpu.models.camera import generate_rays_blocks
        from unity_raytracer_tpu.utils.swizzle import swizzle_image
        o, d = generate_rays_blocks(cam, rcfg.block_size)
        tgt_rad = swizzle_image(target, rcfg.block_size) * 255.0
        lane_w = swizzle_image(
            jnp.ones((cam.height, cam.width, 1), jnp.float32),
            rcfg.block_size)[:, 0]
        # radiance-scale MSE / 255^2 == the image-scale MSE
        raw_vg = make_chunked_value_and_grad(
            template, rcfg, o, d, tgt_rad, bvh=bvh, weights=lane_w)
        scale = 1.0 / (255.0 * 255.0)
        value_and_grad = lambda p: jax.tree.map(
            lambda x: x * scale, raw_vg(p))
    else:
        loss_fn = make_loss_fn(template, cam, rcfg, target, bvh=bvh)
        value_and_grad = jax.value_and_grad(loss_fn)
    tx = optax.adam(cfg.learning_rate)

    opt_state = tx.init(params)
    start_step = 0
    if resume_from:
        start_step, params, opt_state, _, _ = ckpt.load_checkpoint(resume_from)

    def make_step_fn(value_and_grad):
        @jax.jit
        def step_fn(params, opt_state):
            loss, grads = value_and_grad(params)
            if grad_transform is not None:
                grads = grad_transform(grads, params)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss
        return step_fn

    step_fn = make_step_fn(value_and_grad)

    losses = []
    step = start_step
    for step in range(start_step, cfg.steps):
        params, opt_state, loss = step_fn(params, opt_state)
        losses.append(float(loss))
        if cfg.log_every and (step % cfg.log_every == 0 or
                              step == cfg.steps - 1):
            print(f"[fit] step {step:5d} loss {float(loss):.6e}")
        if (measure_prefix is not None and cfg.prefix_guard_every
                and (step + 1) % cfg.prefix_guard_every == 0
                and live_prefix < rcfg.max_bounces + 1):
            # live-prefix guard: the static replay prefix silently drops
            # radiance if the optimizer deepens a mirror chain past it
            # (ops/replay.py documents the topology assumption) — detect
            # and re-jit with a bigger prefix instead
            depth_now = measure_prefix(params)
            if depth_now + 1 > live_prefix:
                live_prefix = min(rcfg.max_bounces + 1, depth_now + 1)
                print(f"[fit] live-prefix guard: bounce depth grew to "
                      f"{depth_now}; re-jitting with prefix "
                      f"{live_prefix}")
                step_fn = make_step_fn(make_replay_vg(live_prefix))
        if (cfg.checkpoint_every and cfg.checkpoint_path
                and (step + 1) % cfg.checkpoint_every == 0):
            ckpt.save_checkpoint(cfg.checkpoint_path, step + 1, params,
                                 opt_state)

    return FitResult(scene=set_params(template, params), params=params,
                     losses=np.asarray(losses), step=step + 1,
                     live_prefix=live_prefix)
