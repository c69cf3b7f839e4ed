"""Sweep the GPU BVH walk kernel against the XLA walk at frame size.

For each BVH leaf size, times the nearest-hit walk of a frame's primary
rays and the any-hit walk of their shadow rays toward the first light,
with the Pallas walk kernel at each (rays per program, warps) setting and
with the XLA loop, and checks that both walks pick the same triangle.
Then times whole frames (``render_frame``) on both routes.

Needs a GPU. One JSON line per measurement on stdout (and appended to
``--out`` when given):

    python scripts/walk_sweep.py --preset mesh100k --leaf 4,8 \
        --block 64,128,256 --warps 2,4,8
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def _time(fn, repeats):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, statistics.median(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="mesh100k")
    ap.add_argument("--leaf", default="4,8")
    ap.add_argument("--block", default="64,128,256")
    ap.add_argument("--warps", default="2,4,8")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--no-frame", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from unity_raytracer_tpu.models.camera import generate_rays_blocks
    from unity_raytracer_tpu.models.presets import get_preset
    from unity_raytracer_tpu.ops import bvh as bvhmod
    from unity_raytracer_tpu.ops.pallas import walk as wk
    from unity_raytracer_tpu.ops.render import render_frame, resolve_mode
    from unity_raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("walk_sweep.py needs a GPU")
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    emit({"card": card, "device_kind": jax.devices()[0].device_kind})

    scene, cam, cfg = get_preset(args.preset)
    cfg = resolve_mode(scene, cfg)
    o, d = generate_rays_blocks(cam, cfg.block_size)
    n = o.shape[0]
    light = scene.lights.positions[0]

    for leaf in _ints(args.leaf):
        t0 = time.perf_counter()
        bvh = bvhmod.prepare_bvh(scene, cfg.with_(bvh_leaf=leaf))
        build_s = time.perf_counter() - t0
        tmax = jnp.full((n,), jnp.inf, jnp.float32)

        xla_near = jax.jit(lambda b, o, d, t: bvhmod._walk_xla(b, o, d, t))
        c, xs = _time(lambda: xla_near(bvh, o, d, tmax), args.repeats)
        t_ref, i_ref = xla_near(bvh, o, d, tmax)
        i_ref = np.asarray(i_ref)
        # shadow rays from the primary hits toward the first light
        hit = np.isfinite(np.asarray(t_ref))
        p = o + d * jnp.where(jnp.asarray(hit), t_ref, 1.0)[:, None]
        lv = light[None, :] - p
        ld = jnp.linalg.norm(lv, axis=-1)
        so = p + 1e-3 * lv / ld[:, None]
        sd = lv / ld[:, None]
        stmax = jnp.where(jnp.asarray(hit), ld, -1.0)
        xla_occ = jax.jit(lambda b, o, d, t: bvhmod._walk_xla(
            b, o, d, t, any_hit=True))
        cs, xs_occ = _time(lambda: xla_occ(bvh, so, sd, stmax), args.repeats)
        occ_ref = np.asarray(xla_occ(bvh, so, sd, stmax)[1]) >= 0
        emit({"leaf": leaf, "nodes": bvh.n_nodes, "build_s": build_s,
              "route": "xla", "nearest_s": xs, "occlusion_s": xs_occ,
              "compile_s": c + cs, "rays": n,
              "hit_frac": float(hit.mean()),
              "occluded_frac": float(occ_ref.mean())})

        for block in _ints(args.block):
            for warps in _ints(args.warps):
                near = jax.jit(lambda b, o, d, t, bl=block, w=warps: wk.walk(
                    b, o, d, t, block=bl, num_warps=w))
                occ = jax.jit(lambda b, o, d, t, bl=block, w=warps: wk.walk(
                    b, o, d, t, any_hit=True, block=bl, num_warps=w))
                c1, ks = _time(lambda: near(bvh, o, d, tmax), args.repeats)
                c2, ks_occ = _time(lambda: occ(bvh, so, sd, stmax),
                                   args.repeats)
                i_k = np.asarray(near(bvh, o, d, tmax)[1])
                occ_k = np.asarray(occ(bvh, so, sd, stmax)[1]) >= 0
                emit({"leaf": leaf, "route": "walk", "block": block,
                      "warps": warps, "nearest_s": ks,
                      "occlusion_s": ks_occ, "compile_s": c1 + c2,
                      "prim_agree": float((i_k == i_ref).mean()),
                      "occ_agree": float((occ_k == occ_ref).mean())})

    if not args.no_frame:
        bvh = bvhmod.prepare_bvh(scene, cfg)
        for kernel in ("auto", "xla", "auto", "xla"):
            c, fs = _time(lambda: render_frame(scene, cam,
                                               cfg.with_(kernel=kernel), bvh),
                          args.repeats)
            emit({"frame": args.preset, "kernel": kernel, "frame_s": fs,
                  "first_call_s": c, "leaf": cfg.bvh_leaf})


if __name__ == "__main__":
    main()
