"""Smoke test of the renderer on one NVIDIA GPU.

    python chip_smoke.py           # one card, every phase below
    python chip_smoke.py --four    # four cards: the sharded paths only

Drives the main path once through the entry points a user calls, at the
full width of the flagship configuration (mesh100k: 1920x1080, depth 4,
3 shadowed lights, 102,400-triangle SAH BVH; cornell_box: 512x512 depth 4
reflect + refract), runs the GPU walk kernel as compiled for the card and
compares it with the XLA walk, and checks the results against the stored
oracle goldens and against the CPU in the same process. Each phase prints
one JSON line; the card's name and power limit come before them; the last
line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero with
no such line. Phases: card, native BVH builder, oracle goldens,
mesh100k frame (kernel vs XLA walk, GPU vs CPU at mesh10k 128^2),
cornell tree path, fwd+bwd (replay, soft replay, composed), fit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
# the walk kernel may flip a grazing lane (FMA contraction): equal prim
# index on this share of the primary nearest query, and an image within
# IMG_ATOL (display scale, per pixel) on this share of the pixels
PRIM_AGREE = 0.9999
IMG_ATOL = 1e-4
IMG_AGREE = 0.999


def last_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def emit(phase: str, **rec) -> None:
    print(json.dumps({"phase": phase, **rec}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _timed(fn):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _pixel_agreement(a, b):
    import numpy as np
    err = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    return float(np.mean(err <= IMG_ATOL)), float(err.max())


def _prim_agreement(scene, cam, cfg, bvh, kernels):
    """Primary nearest query: share of lanes whose prim index agrees."""
    import jax
    import numpy as np

    from unity_raytracer_tpu.models.camera import generate_rays_blocks
    from unity_raytracer_tpu.ops import bvh as bvhmod

    o, d = generate_rays_blocks(cam, cfg.block_size)
    prims = []
    for kernel, dev in kernels:
        with jax.default_device(dev):
            o_, d_, b_ = jax.device_put((o, d, bvh), dev)
            prims.append(np.asarray(jax.jit(
                lambda b, o, d, k=kernel: bvhmod.traverse_any(
                    b, o, d, kernel=k)[1])(b_, o_, d_)))
    return float(np.mean(prims[0] == prims[1])), float(
        np.mean(prims[1] >= 0))


def phase_card(jax, profiling):
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found {devs[0].platform}, not a GPU")
    card = profiling.card()
    check(card is not None, "nvidia-smi gave no card")
    print(card, flush=True)
    emit("card", platform=devs[0].platform, kind=devs[0].device_kind,
         count=len(devs), card=card)


def phase_native():
    from unity_raytracer_tpu.models.presets import get_preset
    from unity_raytracer_tpu.ops import bvh as bvhmod

    check(bvhmod._native_lib() is not None,
          "native BVH builder did not build (numpy fallback)")
    scene, _, cfg = get_preset("mesh100k")
    t0 = time.perf_counter()
    bvh = bvhmod.prepare_bvh(scene, cfg)
    emit("native_bvh", lib=str(bvhmod.NATIVE_SO.relative_to(ROOT)),
         prepare_s=time.perf_counter() - t0, nodes=bvh.n_nodes,
         tris=int(bvh.tri_verts.shape[0]))


def phase_goldens():
    import numpy as np

    from unity_raytracer_tpu.ops.render import render

    spec = importlib.util.spec_from_file_location(
        "golden_cases", ROOT / "tests" / "test_render_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, (fn, w, h) in sorted(mod.CASES.items()):
        scene, cam, cfg = fn(width=w, height=h)
        img = np.asarray(render(scene, cam, cfg))
        ref = np.load(mod.GOLDENS / f"{name}_{w}x{h}.npy")
        mod._check(img, ref, h, w)
        err = np.abs(img - ref)
        emit("golden", case=name, size=[w, h],
             p999_err=float(np.quantile(err, 0.999)),
             mean_err=float(err.mean()), limit_p999=5e-3)


def phase_mesh100k(jax, cpu):
    import numpy as np

    from unity_raytracer_tpu.models.presets import get_preset
    from unity_raytracer_tpu.ops import bvh as bvhmod
    from unity_raytracer_tpu.ops.render import render_frame, resolve_mode

    scene, cam, cfg = get_preset("mesh100k")
    cfg = resolve_mode(scene, cfg)
    bvh = bvhmod.prepare_bvh(scene, cfg)
    img, first_s = _timed(lambda: render_frame(scene, cam, cfg, bvh))
    _, frame_s = _timed(lambda: render_frame(scene, cam, cfg, bvh))
    check(img.shape == (cam.height, cam.width, 3) and bool(np.isfinite(
        np.asarray(img)).all()), "mesh100k frame not finite")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    xla_cfg = cfg.with_(kernel="xla")
    img_x, xla_first_s = _timed(lambda: render_frame(scene, cam, xla_cfg,
                                                     bvh))
    _, xla_frame_s = _timed(lambda: render_frame(scene, cam, xla_cfg, bvh))
    gpu = jax.devices()[0]
    prim, hit_share = _prim_agreement(scene, cam, cfg, bvh,
                                      [("auto", gpu), ("xla", gpu)])
    px, max_err = _pixel_agreement(img, img_x)
    emit("mesh100k", size=[cam.width, cam.height], depth=cfg.max_bounces,
         frame_s=frame_s, compile_and_first_s=first_s,
         xla_walk_frame_s=xla_frame_s, xla_walk_first_s=xla_first_s,
         peak_bytes=peak, prim_agree=prim, hit_share=hit_share,
         limit_prim=PRIM_AGREE, pixel_agree=px, max_abs_err=max_err,
         limit_pixels=IMG_AGREE, atol=IMG_ATOL)
    check(prim >= PRIM_AGREE, f"walk kernel vs XLA walk prim agree {prim}")
    check(px >= IMG_AGREE, f"walk kernel vs XLA walk pixels {px}")

    # mesh10k at 128^2: GPU (walk kernel) against the CPU (XLA walk)
    scene, cam, cfg = get_preset("mesh10k", width=128, height=128)
    cfg = resolve_mode(scene, cfg)
    bvh = bvhmod.prepare_bvh(scene, cfg)
    img_g = np.asarray(render_frame(scene, cam, cfg, bvh))
    with jax.default_device(cpu):
        s_c, b_c = jax.device_put((scene, bvh), cpu)
        img_c = np.asarray(render_frame(s_c, cam, cfg.with_(kernel="xla"),
                                        b_c))
    prim, _ = _prim_agreement(scene, cam, cfg, bvh,
                              [("auto", gpu), ("xla", cpu)])
    px, max_err = _pixel_agreement(img_g, img_c)
    emit("mesh10k_gpu_vs_cpu", size=[128, 128], prim_agree=prim,
         limit_prim=PRIM_AGREE, pixel_agree=px, max_abs_err=max_err,
         limit_pixels=IMG_AGREE, atol=IMG_ATOL)
    check(prim >= PRIM_AGREE, f"mesh10k GPU vs CPU prim agree {prim}")
    check(px >= IMG_AGREE, f"mesh10k GPU vs CPU pixels {px}")


def phase_cornell(jax, cpu):
    import numpy as np

    from unity_raytracer_tpu.models.camera import generate_rays_blocks
    from unity_raytracer_tpu.models.presets import get_preset
    from unity_raytracer_tpu.ops.render import (render, resolve_mode,
                                                trace_radiance_tree_stats)

    spec = importlib.util.spec_from_file_location(
        "golden_cases", ROOT / "tests" / "test_render_golden.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    scene, cam, cfg = get_preset("cornell_box")
    cfg = resolve_mode(scene, cfg)
    check(cfg.mode == "tree", "cornell_box is not on the tree path")
    o, d = generate_rays_blocks(cam, cfg.block_size)
    (rad, n_tr), first_s = _timed(
        lambda: trace_radiance_tree_stats(scene, o, d, cfg))
    _, frame_s = _timed(lambda: trace_radiance_tree_stats(scene, o, d, cfg))
    finite = bool(np.isfinite(np.asarray(rad)).all())
    emit("cornell_box", size=[512, 512], depth=cfg.max_bounces,
         frame_s=frame_s, compile_and_first_s=first_s,
         truncated=int(n_tr), finite=finite)
    check(finite and int(n_tr) == 0, "cornell tree path")

    scene, cam, cfg = get_preset("cornell_box", width=64, height=64)
    img_g = np.asarray(render(scene, cam, cfg))
    with jax.default_device(cpu):
        img_c = np.asarray(render(jax.device_put(scene, cpu), cam,
                                  cfg.with_(kernel="xla")))
    mod._check(img_g, img_c, 64, 64)
    err = np.abs(img_g - img_c)
    emit("cornell_gpu_vs_cpu", size=[64, 64],
         p999_err=float(np.quantile(err, 0.999)), mean_err=float(err.mean()),
         limit_p999=5e-3)


def _finite(tree):
    import jax
    import numpy as np
    return all(bool(np.isfinite(np.asarray(x)).all())
               for x in jax.tree.leaves(tree))


def phase_grads(jax):
    import numpy as np

    from unity_raytracer_tpu.fit import (get_params,
                                         make_chunked_value_and_grad,
                                         set_params)
    from unity_raytracer_tpu.models.camera import generate_rays_blocks
    from unity_raytracer_tpu.models.presets import get_preset
    from unity_raytracer_tpu.ops import bvh as bvhmod
    from unity_raytracer_tpu.ops import replay as rp
    from unity_raytracer_tpu.ops.render import resolve_mode, trace_radiance
    from unity_raytracer_tpu.utils.config import DiffConfig

    names = ("sphere_centers", "sphere_diffuse", "light_intensities")
    scene, cam, cfg = get_preset("mesh100k")
    cfg = resolve_mode(scene, cfg)
    bvh = bvhmod.prepare_bvh(scene, cfg)
    o, d = generate_rays_blocks(cam, cfg.block_size)
    params = get_params(scene, names)
    acc, recs = rp.trace_records(scene, o, d, cfg, bvh)
    target = jax.lax.stop_gradient(acc) * 0.9
    k = rp.live_depth(recs)
    (loss, g), first_s = _timed(lambda: rp.replay_value_and_grad(
        scene, params, o, d, target, cfg, bvh, live_segments=k))
    _, step_s = _timed(lambda: rp.replay_value_and_grad(
        scene, params, o, d, target, cfg, bvh, live_segments=k))
    emit("fwd_bwd_replay", size=[cam.width, cam.height], loss=float(loss),
         step_s=step_s, compile_and_first_s=first_s, live_segments=k,
         finite=_finite((loss, g)))
    check(_finite((loss, g)), "replay loss/grads not finite")

    cfg_s = cfg.with_(diff=DiffConfig(soft_shadow_temp=1.0,
                                      soft_hit_temp=0.1))
    ch = 1 << 18
    (loss, g), first_s = _timed(lambda: rp.soft_replay_value_and_grad(
        scene, params, o, d, target, cfg_s, bvh, live_segments=k, chunk=ch))
    emit("fwd_bwd_soft_replay", size=[cam.width, cam.height], loss=float(loss),
         compile_and_first_s=first_s, finite=_finite((loss, g)))
    check(_finite((loss, g)), "soft replay loss/grads not finite")

    cfg_c = cfg.with_(remat=True)
    vg = jax.jit(make_chunked_value_and_grad(scene, cfg_c, o, d, target,
                                             bvh=bvh, chunk=ch))
    (loss, g), first_s = _timed(lambda: vg(params))
    emit("fwd_bwd_composed", size=[cam.width, cam.height], loss=float(loss),
         compile_and_first_s=first_s, finite=_finite((loss, g)))
    check(_finite((loss, g)), "composed loss/grads not finite")

    # mesh10k at 256^2: replay gradients against composed gradients, at
    # the tolerances of tests/test_replay.py
    scene, cam, cfg = get_preset("mesh10k", width=256, height=256)
    cfg = resolve_mode(scene, cfg)
    bvh = bvhmod.prepare_bvh(scene, cfg)
    o, d = generate_rays_blocks(cam, cfg.block_size)
    names = names + ("light_positions",)
    params = get_params(scene, names)
    target = jax.lax.stop_gradient(trace_radiance(scene, o, d, cfg,
                                                  bvh=bvh)) * 0.9

    def composed_loss(p):
        s = set_params(scene, p)
        rad = trace_radiance(s, o, d, cfg, bvh=bvh)
        return jax.numpy.mean((rad - target) ** 2)

    loss_c, g_c = jax.jit(jax.value_and_grad(composed_loss))(params)
    loss_r, g_r = rp.replay_value_and_grad(scene, params, o, d, target,
                                           cfg, bvh)
    worst = {}
    for name in names:
        a, b = np.asarray(g_r[name]), np.asarray(g_c[name])
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4 * scale,
                                   err_msg=name)
        worst[name] = float(np.abs(a - b).max() / scale)
    np.testing.assert_allclose(float(loss_r), float(loss_c), rtol=1e-4,
                               atol=1e-6)
    emit("replay_vs_composed", size=[cam.width, cam.height],
         loss_replay=float(loss_r),
         loss_composed=float(loss_c), max_err_over_scale=worst,
         rtol=5e-3, atol_over_scale=5e-4)


def phase_fit(jax):
    import numpy as np

    from unity_raytracer_tpu.fit import FitConfig, fit, get_params
    from unity_raytracer_tpu.models.presets import get_preset
    from unity_raytracer_tpu.ops import bvh as bvhmod
    from unity_raytracer_tpu.ops.render import render, resolve_mode

    scene, cam, cfg = get_preset("mesh10k", width=512, height=512)
    cfg = resolve_mode(scene, cfg)
    bvh = bvhmod.prepare_bvh(scene, cfg)
    target = render(scene, cam, cfg, bvh=bvh)
    names = ("sphere_centers", "sphere_diffuse")
    true_p = get_params(scene, names)
    rng = np.random.default_rng(0)
    init = {k: v + jax.numpy.asarray(rng.uniform(-0.3, 0.3, v.shape),
                                     jax.numpy.float32)
            for k, v in true_p.items()}
    init["sphere_diffuse"] = jax.numpy.clip(init["sphere_diffuse"], 0, 1)
    fcfg = FitConfig(param_names=names, learning_rate=0.02, steps=5,
                     soft_shadow_temp=1.0, soft_hit_temp=0.1, log_every=0,
                     use_replay=True)
    t0 = time.perf_counter()
    res = fit(scene, cam, cfg, target, fcfg, init_params=init, bvh=bvh)
    losses = [float(x) for x in res.losses]
    emit("fit_replay", size=[512, 512], depth=cfg.max_bounces,
         losses=losses, seconds=time.perf_counter() - t0)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"fit loss did not fall: {losses}")


def phase_four(jax):
    """render_tiled on a (4, 1) mesh vs single-card render_frame, and
    the sharded train step vs the single-device step."""
    import numpy as np
    import optax

    from unity_raytracer_tpu.fit import get_params, set_params
    from unity_raytracer_tpu.models.camera import generate_rays
    from unity_raytracer_tpu.models.presets import get_preset
    from unity_raytracer_tpu.ops import bvh as bvhmod
    from unity_raytracer_tpu.ops.render import (render_frame, resolve_mode,
                                                trace_radiance)
    from unity_raytracer_tpu.parallel import mesh as meshmod
    from unity_raytracer_tpu.parallel import shard as shardmod

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    mesh = meshmod.make_mesh((4, 1), devices=devs)
    scene, cam, cfg = get_preset("mesh100k")
    cfg = resolve_mode(scene, cfg)
    bvh = bvhmod.prepare_bvh(scene, cfg)
    ref = np.asarray(render_frame(scene, cam, cfg, bvh))
    img, first_s = _timed(lambda: shardmod.render_tiled(scene, cam, cfg,
                                                        mesh, bvh=bvh))
    _, frame_s = _timed(lambda: shardmod.render_tiled(scene, cam, cfg, mesh,
                                                      bvh=bvh))
    err = float(np.abs(np.asarray(img) - ref).max())
    emit("render_tiled_4", size=[cam.width, cam.height], frame_s=frame_s,
         compile_and_first_s=first_s, max_abs_err=err, atol=1e-6)
    check(err <= 1e-6, f"render_tiled vs render_frame max err {err}")

    scene, cam, cfg = get_preset("mesh10k", width=256, height=256)
    cfg = resolve_mode(scene, cfg.with_(max_bounces=1))
    bvh = bvhmod.prepare_bvh(scene, cfg)
    o, d = generate_rays(cam)
    tgt = (trace_radiance(scene, o, d, cfg, bvh=bvh) / 255.0) * 0.9
    names = ("sphere_centers", "sphere_diffuse")
    params = {k: v + 0.1 for k, v in get_params(scene, names).items()}
    tx = optax.adam(0.02)

    def loss_local(p):
        rad = trace_radiance(set_params(scene, p), o, d, cfg, bvh=bvh)
        return jax.numpy.sum((rad / 255.0 - tgt) ** 2) / tgt.size

    l_ref, g_ref = jax.jit(jax.value_and_grad(loss_local))(params)
    up, _ = tx.update(g_ref, tx.init(params), params)
    p_ref = optax.apply_updates(params, up)
    step = shardmod.make_sharded_train_step(scene, cam, cfg, tgt, mesh,
                                            names, tx, bvh=bvh)
    p_sh, _, l_sh = step(params, tx.init(params), o, d, tgt)
    np.testing.assert_allclose(float(l_sh), float(l_ref), rtol=1e-5)
    for k in names:
        np.testing.assert_allclose(np.asarray(p_sh[k]), np.asarray(p_ref[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    emit("sharded_train_step_4", loss_sharded=float(l_sh),
         loss_single=float(l_ref), rtol=1e-5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    import jax

    from unity_raytracer_tpu.utils import profiling
    from unity_raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    phase_card(jax, profiling)
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        if args.four:
            phase_four(jax)
        else:
            phase_native()
            phase_goldens()
            phase_mesh100k(jax, cpu)
            phase_cornell(jax, cpu)
            phase_grads(jax)
            phase_fit(jax)
    print(last_line(profiling.device_info()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
