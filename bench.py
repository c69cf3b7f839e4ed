"""Benchmark harness — flagship: rays/s on one GPU, 1080p, depth 4,
3 shadowed lights, 102,400-triangle SAH BVH (preset ``mesh100k``).

Prints the card's name and power limit (``nvidia-smi``) on one line, then
ONE JSON line to stdout:
  {"metric", "value", "unit", "rays_per_s_fwd", "rays_per_s_fwd_bwd",
   "rays_per_s_live", "frame_s", "grad_s", ..., "device", "card"}
Per-phase records go to stderr.

Ray accounting (two numbers, both reported):
* issued — pixels * segments * (1 + lights): every query slot the
  wavefront issues, live or not (the headline);
* live — the sum of actually-live nearest + shadow query lanes per
  segment (measured by trace_radiance_stats); after bounce 0 most lanes
  are retired, so this is the "useful rays" number.

Timing: every phase runs once to compile (reported as its compile time),
then ``repeats`` times, each call ending in ``block_until_ready``; the
median is reported. No phase is caught: a failing phase fails the run,
and the flagship path refuses to run without a GPU.

fwd+bwd: value_and_grad of a pixel-MSE w.r.t. sphere centers, sphere
diffuse, and light intensities — the inverse-rendering parameter
classes (fit.py). Three measured paths:
* replay (headline; mirror-chain presets) — one hard forward that
  records hits + the gather-free differentiable shading replay
  (ops/replay.py);
* soft replay — the silhouette-fitting variant (min-mode shadow
  records + soft replay);
* composed — the general soft-temp path, with cfg.remat (checkpointed
  bounce scan) + chunked gradient accumulation
  (fit.make_chunked_value_and_grad) bounding backward memory.

Usage: python bench.py [--preset mesh100k] [--width W --height H]
                       [--repeats N] [--no-bvh] [--no-grad] [--all]
                       [--kernel auto|xla]
"""

import argparse
import json
import statistics
import sys
import time

import numpy as np


def count_rays(max_bounces, width, height, n_lights):
    """Issued query slots per frame for the linear chain renderer."""
    pixels = width * height
    segments = max_bounces + 1
    return pixels * segments * (1 + n_lights)


def _timed(fn, repeats=3):
    """(compile_s, median per-call seconds): first call compiles, then
    ``repeats`` calls each synced with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return compile_s, statistics.median(times)


def _log(rec):
    print(json.dumps(rec), file=sys.stderr, flush=True)


def run_once(name="mesh100k", width=None, height=None, repeats=3,
             use_bvh=True, max_bounces=None, kernel="auto", grad=True):
    import jax

    from unity_raytracer_tpu.fit import (get_params,
                                         make_chunked_value_and_grad)
    from unity_raytracer_tpu.models.camera import generate_rays_blocks
    from unity_raytracer_tpu.models.presets import get_preset
    from unity_raytracer_tpu.ops import bvh as bvhmod
    from unity_raytracer_tpu.ops import replay as rp
    from unity_raytracer_tpu.ops.render import (
        render_frame, resolve_mode, trace_radiance, trace_radiance_stats,
        trace_radiance_tree_stats)
    from unity_raytracer_tpu.utils.config import DiffConfig

    kw = {}
    if width:
        kw["width"] = width
    if height:
        kw["height"] = height
    scene, cam, cfg = get_preset(name, **kw)
    cfg = resolve_mode(scene, cfg.with_(use_bvh=use_bvh, kernel=kernel))
    if max_bounces is not None:
        cfg = cfg.with_(max_bounces=max_bounces)

    has_mesh = int(np.asarray(scene.meshes.valid).sum()) > 0
    bvh = None
    build_s = 0.0
    if use_bvh and has_mesh:
        t0 = time.perf_counter()
        bvh = bvhmod.prepare_bvh(scene, cfg)
        build_s = time.perf_counter() - t0

    # ---- forward ----------------------------------------------------------
    compile_s, frame_s = _timed(
        lambda: render_frame(scene, cam, cfg, bvh=bvh), repeats)
    n_lights = int(np.asarray(scene.lights.valid).sum())
    issued = count_rays(cfg.max_bounces, cam.width, cam.height, n_lights)
    fwd = issued / frame_s
    _log({"phase": "forward", "frame_s": frame_s, "compile_s": compile_s})

    o, d = generate_rays_blocks(cam, cfg.block_size)
    tree_truncated = None
    live_rays = None
    if cfg.mode == "tree":
        # tree_cap compaction drops live lanes silently; count them
        _, n_tr = trace_radiance_tree_stats(scene, o, d, cfg, bvh=bvh)
        tree_truncated = int(np.asarray(n_tr))
        if tree_truncated:
            print(f"[bench] WARNING: tree_cap={cfg.tree_cap} truncated "
                  f"{tree_truncated} live lanes (accuracy loss — raise "
                  f"tree_cap)", file=sys.stderr)
    else:
        _, (live, shadow) = trace_radiance_stats(scene, o, d, cfg, bvh=bvh)
        live_rays = int(np.asarray(live).sum() + np.asarray(shadow).sum())

    # ---- fwd+bwd ----------------------------------------------------------
    names = ("sphere_centers", "sphere_diffuse", "light_intensities")
    grad_s = grad_soft_s = grad_composed_s = None
    if grad:
        params0 = get_params(scene, names)
        if cfg.mode == "scan":
            # 0.9x so the loss/grads are nonzero (real backward values)
            target = jax.lax.stop_gradient(rp.trace_radiance_replay(
                scene, o, d, cfg, bvh)) * 0.9
            # static live prefix: replay only the segments that carry
            # live records (exact; measured once)
            k = rp.live_depth(rp.trace_records(scene, o, d, cfg, bvh)[1])
            gc, grad_s = _timed(
                lambda: rp.replay_value_and_grad(
                    scene, params0, o, d, target, cfg, bvh,
                    live_segments=k), repeats)
            _log({"phase": "fwd_bwd_replay", "grad_s": grad_s,
                  "compile_s": gc, "live_segments": k})

            cfg_s = cfg.with_(diff=DiffConfig(
                soft_shadow_temp=1.0, soft_hit_temp=0.1,
                straight_through=True))
            ch = 1 << 18  # bound the pure-jnp replay working set
            target_s = jax.lax.stop_gradient(rp.trace_radiance_replay_soft(
                scene, o, d, cfg_s, bvh, chunk=ch)) * 0.9
            k_s = rp.live_depth(
                rp.trace_records(scene, o, d, cfg_s, bvh, soft=True)[1])
            gc, grad_soft_s = _timed(
                lambda: rp.soft_replay_value_and_grad(
                    scene, params0, o, d, target_s, cfg_s, bvh,
                    live_segments=k_s, chunk=ch), repeats)
            _log({"phase": "fwd_bwd_soft_replay", "grad_s": grad_soft_s,
                  "compile_s": gc})

        cfg_g = cfg.with_(remat=True)
        target_c = jax.lax.stop_gradient(
            trace_radiance(scene, o, d, cfg_g, bvh=bvh)) * 0.9
        chunk = cfg.ray_chunk or min(o.shape[0], 1 << 18)
        vg = jax.jit(make_chunked_value_and_grad(
            scene, cfg_g, o, d, target_c, bvh=bvh, chunk=chunk))
        gc, grad_composed_s = _timed(lambda: vg(params0), repeats)
        _log({"phase": "fwd_bwd_composed", "grad_s": grad_composed_s,
              "compile_s": gc})
        if grad_s is None:  # no replay path -> composed is the number
            grad_s = grad_composed_s

    def rate(t):
        return issued / t if t else None

    return {
        "preset": name,
        "width": cam.width,
        "height": cam.height,
        "depth": cfg.max_bounces,
        "lights": n_lights,
        "mesh_tris": int(np.asarray(scene.meshes.valid).sum()),
        "kernel": cfg.kernel,
        "use_bvh": bvh is not None,
        "bvh_build_s": build_s,
        "compile_s": compile_s,
        "frame_s": frame_s,
        "grad_s": grad_s,
        "grad_composed_s": grad_composed_s,
        "grad_soft_s": grad_soft_s,
        "rays_issued": issued,
        "rays_live": live_rays,
        "tree_truncated": tree_truncated,
        "rays_per_s_fwd": fwd,
        "rays_per_s_fwd_bwd": rate(grad_s),
        "rays_per_s_fwd_bwd_composed": rate(grad_composed_s),
        "rays_per_s_fwd_bwd_soft": rate(grad_soft_s),
        "rays_per_s_live": (live_rays / frame_s) if live_rays else None,
    }


def run_sharded(name="mesh10k", width=None, height=None, repeats=2,
                counts=(1, 2, 4, 8)):
    """Scaling harness: rays/s vs device count on the available mesh
    (real cards; virtual CPU devices with --virtual N).

    Emits one JSON record per device count with efficiency relative to
    the 1-device run — the BASELINE ">=85% 1 chip -> N" measurement
    harness. (On virtual CPU devices the numbers prove the harness and
    sharding, not real scaling.) Call parallel.bootstrap.maybe_initialize
    first on multi-host deployments.
    """
    import jax

    from unity_raytracer_tpu.models.presets import get_preset
    from unity_raytracer_tpu.ops import bvh as bvhmod
    from unity_raytracer_tpu.ops.render import resolve_mode
    from unity_raytracer_tpu.parallel import mesh as meshmod
    from unity_raytracer_tpu.parallel import shard as shardmod
    from unity_raytracer_tpu.parallel.bootstrap import maybe_initialize
    from unity_raytracer_tpu.utils.profiling import device_info

    maybe_initialize()
    kw = {}
    if width:
        kw["width"] = width
    if height:
        kw["height"] = height
    scene, cam, cfg = get_preset(name, **kw)
    cfg = resolve_mode(scene, cfg)
    bvh = bvhmod.prepare_bvh(scene, cfg) if cfg.use_bvh else None

    devices = jax.devices()
    issued = count_rays(cfg.max_bounces, cam.width, cam.height,
                        int(np.asarray(scene.lights.valid).sum()))
    rows = []
    base = None
    for n in [c for c in counts if c <= len(devices)]:
        mesh = meshmod.make_mesh((n, 1), devices=devices[:n])
        c, t = _timed(lambda: shardmod.render_tiled(scene, cam, cfg,
                                                    mesh, bvh=bvh),
                      repeats)
        rps = issued / t
        if base is None:
            base = rps
        row = {"devices": n, "frame_s": t, "rays_per_s": rps,
               "efficiency": rps / (base * n), "compile_s": c}
        rows.append(row)
        _log(row)
    return {"metric": f"scaling_efficiency_{name}",
            "value": rows[-1]["efficiency"] if rows else 0.0,
            "unit": "fraction",
            "table": rows,
            "device": device_info()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="mesh100k")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--no-bvh", action="store_true")
    ap.add_argument("--no-grad", action="store_true")
    ap.add_argument("--kernel", default="auto", choices=("auto", "xla"),
                    help="BVH walk: auto (the GPU walk kernel) or the XLA "
                         "loop, for comparison")
    ap.add_argument("--all", action="store_true",
                    help="also time the other presets (to stderr)")
    ap.add_argument("--sharded", action="store_true",
                    help="scaling table over device counts instead of "
                         "the flagship single-card run")
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (scaling harness "
                         "without a multi-card host)")
    args = ap.parse_args()
    if args.virtual:
        import os
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}")
        import jax
        jax.config.update("jax_platforms", "cpu")
    from unity_raytracer_tpu.utils.compile_cache import enable_compile_cache
    from unity_raytracer_tpu.utils.profiling import (card, device_hbm_gbps,
                                                     device_info)
    enable_compile_cache()

    if args.sharded:
        preset = args.preset if args.preset != "mesh100k" or not \
            args.virtual else "mesh10k"
        out = run_sharded(preset, width=args.width, height=args.height,
                          repeats=max(1, args.repeats - 1))
        print(json.dumps(out))
        return

    dev = device_info()
    if dev["platform"] != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev['platform']}")
    card_line = card()
    print(card_line, flush=True)

    if args.all:
        for p in ["three_spheres", "cornell_box", "mesh10k"]:
            r = run_once(p, repeats=args.repeats, grad=False,
                         kernel=args.kernel)
            _log(r)

    r = run_once(args.preset, width=args.width, height=args.height,
                 repeats=args.repeats, use_bvh=not args.no_bvh,
                 kernel=args.kernel, grad=not args.no_grad)
    _log(r)
    out = {
        "metric": "rays_per_s_fwd_1080p_d4_100k_bvh"
        if args.preset == "mesh100k" else f"rays_per_s_{args.preset}",
        "value": r["rays_per_s_fwd"],
        "unit": "rays/s",
        **{k: r[k] for k in (
            "rays_per_s_fwd", "rays_per_s_fwd_bwd",
            "rays_per_s_fwd_bwd_composed", "rays_per_s_fwd_bwd_soft",
            "rays_per_s_live", "frame_s", "compile_s", "grad_s",
            "grad_composed_s", "grad_soft_s", "tree_truncated", "kernel")},
        "hbm_peak_gbps": device_hbm_gbps(),
        "device": dev,
        "card": card_line,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
