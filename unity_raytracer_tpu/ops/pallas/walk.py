"""Stackless BVH walk as one Pallas kernel for NVIDIA GPUs (Triton route).

The same walk as the XLA loop in ``ops/bvh._walk_xla``: every ray carries
one node cursor through the depth-first node order; an interior box hit
descends to ``cursor + 1``, a miss or a finished leaf follows the
``miss_next`` skip pointer, ``-1`` ends the walk. Leaves hold at most
``leaf_size`` triangles, tested with the same Moller-Trumbore rejects.

What the kernel changes is where the state lives. The XLA loop steps every
lane of the batch in lockstep until the single longest walk ends, and each
step reads and writes the whole ray state through device memory. Here one
program owns ``block`` rays: origin, direction, ``1/d``, cursor and the
running best hit stay in registers, the loop runs until that block's own
lanes are done, and node and triangle rows are fetched with per-lane
index loads served from L2 (the flagship BVH is a few MB). Leaf tests run
only on steps where some lane of the block is at a leaf.

Pallas has no autodiff: callers pass ``stop_gradient``-ed rays and
re-derive the winner's t and normal differentiably (``ops/bvh._epilogue``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from unity_raytracer_tpu.ops.intersect import EPS

NODE_ROW = 8      # lo.xyz, hi.xyz, miss_next, leaf code (int32 bit patterns)
TRI_ROW = 9       # v0.xyz, e1.xyz, e2.xyz
_COUNT_BITS = 4   # leaf code = first << 4 | count

# rays per program and warps per program (scripts/walk_sweep.py)
BLOCK = 128
NUM_WARPS = 4


def pack_nodes(bvh) -> jnp.ndarray:
    """[Nn * 8] float32 node rows read by the kernel, derived from the
    ``MeshBVH`` arrays: box corners, then the int32 bit patterns of
    ``miss_next`` and the leaf code (``first << 4 | count``; ``-1`` for an
    interior node)."""
    if bvh.leaf_size >= (1 << _COUNT_BITS):
        raise ValueError(f"leaf_size {bvh.leaf_size} does not fit the "
                         f"{_COUNT_BITS}-bit leaf count")
    if bvh.tri_verts.shape[0] >= (1 << (31 - _COUNT_BITS)):
        raise ValueError("too many triangles for the packed leaf code")
    leaf = bvh.first >= 0
    code = jnp.where(leaf, (bvh.first << _COUNT_BITS) | bvh.count, -1)
    ints = jnp.stack([bvh.miss_next, code], axis=1).astype(jnp.int32)
    rows = jnp.concatenate(
        [bvh.node_min, bvh.node_max,
         jax.lax.bitcast_convert_type(ints, jnp.float32)], axis=1)
    return rows.reshape(-1)


def pack_tris(bvh) -> jnp.ndarray:
    """[M * 9] float32 leaf-order triangle rows ``v0, v1 - v0, v2 - v0``
    (the edges ``_mt_one`` forms, computed once per call)."""
    v = bvh.tri_verts
    rows = jnp.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]],
                           axis=1)
    return rows.reshape(-1)


def _safe_inv(x):
    return 1.0 / jnp.where(jnp.abs(x) < 1e-30,
                           jnp.where(x < 0, -1e-30, 1e-30), x)


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmax_ref,
            nodes_ref, tris_ref, t_ref, i_ref, *, leaf_size, n_nodes,
            n_tris, any_hit):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    best_t0 = tmax_ref[...]
    cursor0 = jnp.where(best_t0 < 0.0, -1, 0).astype(jnp.int32)
    best_i0 = jnp.full(best_t0.shape, -1, jnp.int32)

    def node_f(base, k):
        return nodes_ref[base + k]

    def node_i(base, k):
        return jax.lax.bitcast_convert_type(nodes_ref[base + k], jnp.int32)

    def leaf_tests(first, count, live, best_t, best_i):
        for k in range(leaf_size):
            pi = jnp.clip(first + k, 0, n_tris - 1)
            b = pi * TRI_ROW
            v0x, v0y, v0z = tris_ref[b], tris_ref[b + 1], tris_ref[b + 2]
            e1x, e1y, e1z = tris_ref[b + 3], tris_ref[b + 4], tris_ref[b + 5]
            e2x, e2y, e2z = tris_ref[b + 6], tris_ref[b + 7], tris_ref[b + 8]
            hx = dy * e2z - dz * e2y
            hy = dz * e2x - dx * e2z
            hz = dx * e2y - dy * e2x
            a = e1x * hx + e1y * hy + e1z * hz
            parallel = jnp.abs(a) < EPS
            f = 1.0 / jnp.where(parallel, 1.0, a)
            sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
            u = f * (sx * hx + sy * hy + sz * hz)
            qx = sy * e1z - sz * e1y
            qy = sz * e1x - sx * e1z
            qz = sx * e1y - sy * e1x
            v = f * (dx * qx + dy * qy + dz * qz)
            t = f * (e2x * qx + e2y * qy + e2z * qz)
            miss = (parallel | (u < 0.0) | (u > 1.0) | (v < 0.0)
                    | (u + v > 1.0) | (t <= EPS))
            upd = live & (k < count) & ~miss & (t < best_t)
            best_t = jnp.where(upd, -1.0 if any_hit else t, best_t)
            best_i = jnp.where(upd, pi, best_i)
        return best_t, best_i

    def cond(state):
        return jnp.max(state[0]) >= 0

    def body(state):
        cursor, best_t, best_i = state
        active = cursor >= 0
        base = jnp.clip(cursor, 0, n_nodes - 1) * NODE_ROW
        t1x = (node_f(base, 0) - ox) * ix
        t1y = (node_f(base, 1) - oy) * iy
        t1z = (node_f(base, 2) - oz) * iz
        t2x = (node_f(base, 3) - ox) * ix
        t2y = (node_f(base, 4) - oy) * iy
        t2z = (node_f(base, 5) - oz) * iz
        t_enter = jnp.maximum(
            jnp.maximum(jnp.maximum(jnp.minimum(t1x, t2x),
                                    jnp.minimum(t1y, t2y)),
                        jnp.minimum(t1z, t2z)), 0.0)
        t_exit = jnp.minimum(
            jnp.minimum(jnp.minimum(jnp.maximum(t1x, t2x),
                                    jnp.maximum(t1y, t2y)),
                        jnp.maximum(t1z, t2z)), best_t)
        box_hit = active & (t_enter <= t_exit)
        miss_next = node_i(base, 6)
        code = node_i(base, 7)
        is_leaf = code >= 0
        leaf_live = box_hit & is_leaf
        first = jnp.where(is_leaf, code >> _COUNT_BITS, 0)
        count = jnp.where(is_leaf, code & ((1 << _COUNT_BITS) - 1), 0)
        best_t, best_i = jax.lax.cond(
            jnp.max(leaf_live.astype(jnp.int32)) > 0,
            functools.partial(leaf_tests, first, count, leaf_live),
            lambda bt, bi: (bt, bi), best_t, best_i)
        descend = box_hit & ~is_leaf
        cursor = jnp.where(active, jnp.where(descend, cursor + 1, miss_next),
                           cursor)
        if any_hit:  # occluded lanes retire at once
            cursor = jnp.where(best_t < 0.0, -1, cursor)
        return cursor, best_t, best_i

    _, best_t, best_i = jax.lax.while_loop(
        cond, body, (cursor0, best_t0, best_i0))
    t_ref[...] = best_t
    i_ref[...] = best_i


def walk(bvh, o: jnp.ndarray, d: jnp.ndarray, t_max: jnp.ndarray,
         any_hit: bool = False, block: int | None = None,
         num_warps: int | None = None, interpret: bool = False):
    """Kernel walk -> ``(best_t [N], best_i [N])`` in leaf order, the same
    contract as ``ops/bvh._walk_xla``: ``best_t`` is seeded with ``t_max``
    (negative culls the lane), ``best_i`` is ``-1`` where nothing closer
    was hit. ``block`` (a power of two) is the rays per program."""
    block = block or BLOCK
    num_warps = num_warps or NUM_WARPS
    if block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    n = o.shape[0]
    pad = (-n) % block
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    t_max = jax.lax.stop_gradient(jnp.asarray(t_max, jnp.float32))
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_max]
    if pad:
        fill = [0.0, 0.0, 0.0, 0.0, 0.0, 1.0, -1.0]
        cols = [jnp.concatenate([c, jnp.full((pad,), f, jnp.float32)])
                for c, f in zip(cols, fill)]
    nodes = jax.lax.stop_gradient(pack_nodes(bvh))
    tris = jax.lax.stop_gradient(pack_tris(bvh))
    n_pad = n + pad
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    kernel = functools.partial(
        _kernel, leaf_size=bvh.leaf_size, n_nodes=bvh.n_nodes,
        n_tris=bvh.tri_verts.shape[0], any_hit=any_hit)
    t, i = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32)),
        grid=(n_pad // block,),
        in_specs=[ray_spec] * 7 + [
            pl.BlockSpec(nodes.shape, lambda i: (0,)),
            pl.BlockSpec(tris.shape, lambda i: (0,))],
        out_specs=(ray_spec, ray_spec),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
        name="bvh_walk",
    )(*cols, nodes, tris)
    return t[:n], i[:n]
