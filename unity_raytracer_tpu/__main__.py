"""CLI entry points: render / bench / fit / dryrun.

The reference has no CLI — its only entry is the Unity editor lifecycle
(RayTracingSetup.cs:44,171). Usage::

    python -m unity_raytracer_tpu render --preset cornell_box --out img.png
    python -m unity_raytracer_tpu bench --preset mesh100k
    python -m unity_raytracer_tpu fit --steps 300 --out-dir /tmp/fit
    python -m unity_raytracer_tpu dryrun --devices 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_render(args):
    import numpy as np

    from unity_raytracer_tpu.models.presets import get_preset
    from unity_raytracer_tpu.ops import bvh as bvhmod
    from unity_raytracer_tpu.ops.render import render, resolve_mode
    from unity_raytracer_tpu.utils import image as imgutil

    kw = {}
    if args.width:
        kw["width"] = args.width
    if args.height:
        kw["height"] = args.height
    scene, cam, cfg = get_preset(args.preset, **kw)
    if args.depth is not None:
        cfg = cfg.with_(max_bounces=args.depth)
    if args.bvh:
        cfg = cfg.with_(use_bvh=True)
    cfg = resolve_mode(scene, cfg)
    bvh = bvhmod.prepare_bvh(scene, cfg) if cfg.use_bvh else None
    t0 = time.perf_counter()
    img = np.asarray(render(scene, cam, cfg, bvh=bvh))
    dt = time.perf_counter() - t0
    print(f"rendered {cam.width}x{cam.height} depth={cfg.max_bounces} "
          f"in {dt:.2f}s (incl. compile)", file=sys.stderr)
    out = args.out or f"{args.preset}.png"
    if out.endswith(".npy"):
        imgutil.write_npy(out, img)
    else:
        imgutil.write_png(out, img)
    print(out)


def cmd_bench(args):
    import bench as benchmod  # repo-root harness
    sys.argv = ["bench.py", "--preset", args.preset] + (
        ["--all"] if args.all else [])
    benchmod.main()


def cmd_fit(args):
    import numpy as np

    from unity_raytracer_tpu.fit import FitConfig, fit, get_params
    from unity_raytracer_tpu.models.camera import Camera
    from unity_raytracer_tpu.models.presets import get_preset, three_spheres
    from unity_raytracer_tpu.ops.render import render, resolve_mode
    from unity_raytracer_tpu.utils import image as imgutil
    import jax.numpy as jnp

    if args.preset == "three_spheres":
        if getattr(args, "replay", False):
            print("fit: --replay is ignored for the three_spheres toy "
                  "config (depth 0, nothing to replay) — using the "
                  "composed gradient path", file=sys.stderr)
        # toy config: brute force, depth 0, custom close-up camera
        scene, _, cfg = three_spheres(width=args.size, height=args.size)
        cfg = resolve_mode(scene, cfg.with_(max_bounces=0))
        cam = Camera.from_fov(position=(0, 5, 6), look_at=(0, 2.5, 26),
                              fov_y_deg=40.0, width=args.size,
                              height=args.size)
        bvh = None
    elif args.replay:
        # fast path: soft record-replay step (hard forward with records
        # + differentiable replay bwd) — full preset depth
        scene, cam, cfg = get_preset(args.preset, width=args.size,
                                     height=args.size)
        cfg = resolve_mode(scene, cfg.with_(use_bvh=True))
        from unity_raytracer_tpu.ops import bvh as bvhmod
        bvh = bvhmod.prepare_bvh(scene, cfg)
    else:
        # any preset (e.g. mesh10k): BVH + chunked/remat gradient step
        scene, cam, cfg = get_preset(args.preset, width=args.size,
                                     height=args.size)
        cfg = resolve_mode(scene, cfg.with_(
            max_bounces=min(cfg.max_bounces, 1),
            ray_chunk=args.size * args.size // 4 or None, remat=True))
        bvh = None
        if cfg.use_bvh:
            from unity_raytracer_tpu.ops import bvh as bvhmod
            bvh = bvhmod.prepare_bvh(scene, cfg)
    target = render(scene, cam, cfg, bvh=bvh)
    true_p = get_params(scene, ("sphere_centers", "sphere_diffuse"))
    n_sph = np.asarray(true_p["sphere_centers"]).shape[0]
    rng = np.random.default_rng(args.seed)
    init = {
        "sphere_centers": true_p["sphere_centers"]
        + jnp.asarray(rng.uniform(-0.4, 0.4, (n_sph, 3)), jnp.float32),
        "sphere_diffuse": jnp.clip(
            true_p["sphere_diffuse"]
            + jnp.asarray(rng.uniform(-0.2, 0.2, (n_sph, 3)),
                          jnp.float32), 0.0, 1.0),
    }
    fcfg = FitConfig(param_names=("sphere_centers", "sphere_diffuse"),
                     learning_rate=args.lr, steps=args.steps,
                     soft_shadow_temp=1.0, soft_hit_temp=0.1,
                     log_every=max(args.steps // 10, 1),
                     checkpoint_every=args.ckpt_every,
                     checkpoint_path=(f"{args.out_dir}/fit.npz"
                                      if args.out_dir else None),
                     use_replay=bool(getattr(args, "replay", False)
                                     and args.preset != "three_spheres"))
    res = fit(scene, cam, cfg, target, fcfg, init_params=init, bvh=bvh)
    err = np.abs(np.asarray(res.params["sphere_centers"])
                 - np.asarray(true_p["sphere_centers"])).max()
    print(json.dumps({"final_loss": float(res.losses[-1]),
                      "loss_ratio": float(res.losses[-1] / res.losses[0]),
                      "center_err": float(err)}))
    if args.out_dir:
        final = np.asarray(render(res.scene, cam, cfg, bvh=bvh))
        imgutil.write_png(f"{args.out_dir}/recovered.png", final)
        imgutil.write_png(f"{args.out_dir}/target.png", np.asarray(target))


def cmd_dryrun(args):
    import os
    if args.devices and "cpu" in (args.platform or "cpu"):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}")
        import jax
        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ".")
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(args.devices)


def main():
    ap = argparse.ArgumentParser(prog="unity_raytracer_tpu")
    ap.add_argument("--platform", default=None,
                    help="force the jax platform (cpu or gpu); default: "
                         "the environment's (JAX_PLATFORMS)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a preset to PNG/NPY")
    r.add_argument("--preset", default="cornell_box")
    r.add_argument("--width", type=int)
    r.add_argument("--height", type=int)
    r.add_argument("--depth", type=int, default=None)
    r.add_argument("--bvh", action="store_true")
    r.add_argument("--out", default=None)
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("bench", help="run the benchmark harness")
    b.add_argument("--preset", default="mesh100k")
    b.add_argument("--all", action="store_true")
    b.set_defaults(fn=cmd_bench)

    f = sub.add_parser("fit", help="inverse-rendering demo (config 4)")
    f.add_argument("--preset", default="three_spheres",
                   help="scene preset; non-toy presets fit with BVH + "
                        "chunked/remat gradients at depth 1")
    f.add_argument("--size", type=int, default=48)
    f.add_argument("--steps", type=int, default=300)
    f.add_argument("--lr", type=float, default=0.02)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--ckpt-every", type=int, default=0)
    f.add_argument("--out-dir", default=None)
    f.add_argument("--replay", action="store_true",
                   help="soft record-replay gradient step (hard fwd "
                        "with records + differentiable replay bwd) — the "
                        "fast fitting path; full preset depth")
    f.set_defaults(fn=cmd_fit)

    d = sub.add_parser("dryrun", help="multi-chip dry run on fake devices")
    d.add_argument("--devices", type=int, default=8)
    d.add_argument("--platform", default="cpu")
    d.set_defaults(fn=cmd_dryrun)

    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)
    from unity_raytracer_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
