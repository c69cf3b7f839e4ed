"""Sharded rendering + distributed training step (shard_map / GSPMD).

Three scaling regimes, mirroring SP/TP/ring-attention (SURVEY.md §5.7):

1. ``render_tiled`` — rays sharded over ``dp``, scene replicated. Zero
   communication in forward except the final gather. The default and the
   BASELINE config-5 shape.
2. ``scene_sharded_hit`` — mesh triangles sharded over ``tp``, rays
   replicated; per-device partial nearest hit combined with a lexicographic
   (t, id) pmin (collectives.min_hit_combine). For scenes too big to
   replicate.
3. ``nearest_hit_ring`` — rays AND scene sharded on one axis; scene shards
   rotate around the ring with ``lax.ppermute`` while each ray shard folds
   a running nearest hit — the ray-tracing analogue of ring attention's KV
   rotation with min-combine instead of softmax accumulation.

``make_sharded_train_step`` runs inverse rendering with the loss psum'd over
``dp``; the backward pass then carries the scene-parameter gradient
all-reduce, which XLA's scheduler overlaps with backward compute.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from unity_raytracer_tpu.models.camera import (
    Camera, generate_rays, generate_rays_blocks)
from unity_raytracer_tpu.models.scene import Scene
from unity_raytracer_tpu.ops import intersect as isect
from unity_raytracer_tpu.ops.intersect import Hit, KIND_NONE
from unity_raytracer_tpu.ops.render import trace_radiance, resolve_mode
from unity_raytracer_tpu.parallel import collectives
from unity_raytracer_tpu.parallel.mesh import RAY_AXIS, SCENE_AXIS
from unity_raytracer_tpu.utils.config import RenderConfig
from unity_raytracer_tpu.utils.swizzle import unswizzle_image


def _pad_rays(o, d, multiple: int):
    n = o.shape[0]
    pad = (-n) % multiple
    if pad:
        filler_d = jnp.zeros((pad, 3), d.dtype).at[:, 2].set(1.0)
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)], axis=0)
        d = jnp.concatenate([d, filler_d], axis=0)
    return o, d, n


def render_tiled(scene: Scene, cam: Camera, cfg: RenderConfig, mesh: Mesh,
                 bvh=None) -> jnp.ndarray:
    """Regime 1: explicit shard_map render, rays over ``dp``.

    Rays are generated in the same pixel-block lane order as
    ``render_frame`` (each device gets a contiguous run of screen blocks,
    so the walk kernel's blocks stay coherent). Returns the [H,W,3]
    display-scale image. Scene (and BVH) are replicated broadcast
    operands.
    """
    return _render_tiled(scene, cam, resolve_mode(scene, cfg), mesh, bvh)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _render_tiled(scene, cam, cfg, mesh, bvh):
    o, d = generate_rays_blocks(cam, cfg.block_size)
    o, d, n = _pad_rays(o, d, mesh.shape[RAY_AXIS])

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS)),
             out_specs=P(RAY_AXIS), check_vma=False)
    def _go(scene_, bvh_, o_, d_):
        return trace_radiance(scene_, o_, d_, cfg, bvh=bvh_)

    rad = _go(scene, bvh, o, d)[:n]
    return unswizzle_image(rad, cam.width, cam.height,
                           cfg.block_size) / 255.0


def render_auto(scene: Scene, cam: Camera, cfg: RenderConfig, mesh: Mesh,
                bvh=None) -> jnp.ndarray:
    """Regime 1 via GSPMD: annotate ray shardings, let XLA partition.

    The idiomatic pjit path — same math, compiler-chosen comms.
    """
    cfg = resolve_mode(scene, cfg)
    o, d = generate_rays(cam)
    n_dp = mesh.shape[RAY_AXIS]
    o, d, n = _pad_rays(o, d, n_dp)
    ray_sh = NamedSharding(mesh, P(RAY_AXIS))
    o = jax.device_put(o, ray_sh)
    d = jax.device_put(d, ray_sh)
    rad = trace_radiance(scene, o, d, cfg, bvh=bvh)[:n]
    return rad.reshape(cam.height, cam.width, 3) / 255.0


# ---------------------------------------------------------------------------
# Regime 2: scene sharded (TP analogue)
# ---------------------------------------------------------------------------

def _rest_scene(scene: Scene) -> Scene:
    """The replicated part of a scene-sharded computation: everything
    EXCEPT the per-triangle mesh arrays, which are replaced by 1-row
    dummies. The big [M]-row arrays travel ONLY as shards — per-device
    memory for them is M/tp rows, which is the entire point of the TP
    regime (SURVEY.md §5.7 regime 2). The small per-MESH side tables
    (AABBs, materials: K rows) stay replicated."""
    m = scene.meshes
    dummy = dataclasses.replace(
        m,
        verts=jnp.zeros((1, 3, 3), jnp.float32),
        normals=jnp.zeros((1, 3), jnp.float32),
        mesh_id=jnp.zeros((1,), jnp.int32),
        valid=jnp.zeros((1,), bool))
    return dataclasses.replace(scene, meshes=dummy)


def shard_scene_mesh_tris(scene: Scene, mesh: Mesh) -> Scene:
    """Place the mesh-triangle arrays sharded over ``tp`` (row-sharded);
    everything else replicated. Requires M % tp == 0 (pad the builder)."""
    tp_sh = NamedSharding(mesh, P(SCENE_AXIS))
    rep = NamedSharding(mesh, P())
    m = scene.meshes
    m = dataclasses.replace(
        m,
        verts=jax.device_put(m.verts, tp_sh),
        normals=jax.device_put(m.normals, tp_sh),
        mesh_id=jax.device_put(m.mesh_id, tp_sh),
        valid=jax.device_put(m.valid, tp_sh))
    return dataclasses.replace(jax.device_put(_rest_scene(scene), rep),
                               meshes=m)


def _combine_partial_hits(t, kind, index_gl, mesh_index, normal):
    """Lexicographic (t, key) pmin over ``tp`` + winner-shard carry.

    ``index_gl`` must be GLOBAL (unique across shards) so the packed key
    identifies exactly one shard; the winner's mesh_index and shading
    normal then ride a psum (zero from every losing shard)."""
    key = collectives.pack_hit(kind, jnp.clip(index_gl, 0, None))
    key = jnp.where(kind == KIND_NONE, jnp.int32(2**31 - 1), key)
    t_g, key_g = collectives.min_hit_combine(t, key, SCENE_AXIS)
    kind_g, index_g = collectives.unpack_hit(key_g)
    missed = key_g == 2**31 - 1
    kind_g = jnp.where(missed, KIND_NONE, kind_g)
    index_g = jnp.where(missed, -1, index_g)

    # winner-shard carry: for MESH winners exactly one shard matches the
    # global key (global index => unique); sphere/loose winners are
    # computed identically on every shard, so gate on kind==MESH and let
    # psum pick up the single contributor
    won_mesh = ((key == key_g) & (t == t_g)
                & (kind == isect.KIND_MESH) & (kind_g == isect.KIND_MESH))
    mesh_index_g = jax.lax.psum(
        jnp.where(won_mesh, mesh_index + 1, 0), SCENE_AXIS) - 1
    normal_g = jax.lax.psum(
        jnp.where(won_mesh[:, None], normal, 0.0), SCENE_AXIS)
    mesh_index_g = jnp.where(kind_g == isect.KIND_MESH, mesh_index_g, -1)
    return t_g, kind_g, index_g, mesh_index_g, normal_g


def scene_sharded_hit(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                      mesh: Mesh) -> Hit:
    """Regime 2 (brute): nearest hit with mesh triangles sharded over
    ``tp`` — the shards are the ONLY copy of the [M]-row arrays.

    Each device brute-forces its triangle shard (plus the replicated
    sphere/loose-triangle tables — tiny), then partial winners combine
    with the lexicographic (t, key) pmin; the winner shard also carries
    its mesh id and shading normal across (no global [M] table needed
    anywhere). Exactly equal to the single-device result, including the
    reference's category tie order (keys pack kind-major).
    """
    tp = mesh.shape[SCENE_AXIS]
    m_total = scene.meshes.count
    assert m_total % tp == 0, "pad mesh triangles to a multiple of tp"
    shard_rows = m_total // tp
    rest = _rest_scene(scene)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(SCENE_AXIS), P(SCENE_AXIS), P(SCENE_AXIS),
                       P(SCENE_AXIS), P(), P()),
             out_specs=(P(), P(), P(), P(), P()), check_vma=False)
    def _go(rest_, mverts, mnormals, mid, mvalid, o_, d_):
        local = dataclasses.replace(
            rest_, meshes=dataclasses.replace(
                rest_.meshes, verts=mverts, normals=mnormals,
                mesh_id=mid, valid=mvalid))
        hit = isect.nearest_hit(local, o_, d_)
        shard_i = jax.lax.axis_index(SCENE_AXIS)
        is_mesh = hit.kind == isect.KIND_MESH
        gl_index = jnp.where(is_mesh, hit.index + shard_i * shard_rows,
                             hit.index)
        nrm = jnp.take(mnormals, jnp.clip(hit.index, 0, shard_rows - 1),
                       axis=0)
        return _combine_partial_hits(hit.t, hit.kind, gl_index,
                                     hit.mesh_index, nrm)

    t, kind, index, mesh_index, normal = _go(
        rest, scene.meshes.verts, scene.meshes.normals,
        scene.meshes.mesh_id, scene.meshes.valid, o, d)
    return Hit(t=t, kind=kind, index=index, mesh_index=mesh_index,
               mesh_n=normal)


def build_shard_bvhs(scene: Scene, tp: int):
    """Host-side: one BVH per contiguous triangle shard, padded to common
    array sizes and stacked on a leading ``tp`` dim for shard_map.

    Returns a dict of stacked arrays; pad nodes are never visited (the
    threaded miss chain terminates inside the real subtree)."""
    import numpy as np

    from unity_raytracer_tpu.ops import bvh as bvhmod

    verts = bvhmod.canonical_winding(np.asarray(scene.meshes.verts),
                                     np.asarray(scene.meshes.normals))
    valid = np.asarray(scene.meshes.valid)
    mid = np.asarray(scene.meshes.mesh_id)
    m_total = verts.shape[0]
    assert m_total % tp == 0
    rows = m_total // tp

    shards = []
    for s in range(tp):
        sl = slice(s * rows, (s + 1) * rows)
        shards.append(bvhmod.build(verts[sl], valid[sl]))
    nn_max = max(b.n_nodes for b in shards)

    def pad_nodes(a, fill):
        a = np.asarray(a)
        out = np.full((nn_max,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    import numpy as _np
    stacked = {
        "node_min": _np.stack([pad_nodes(b.node_min, _np.inf)
                               for b in shards]),
        "node_max": _np.stack([pad_nodes(b.node_max, -_np.inf)
                               for b in shards]),
        "first": _np.stack([pad_nodes(b.first, 0) for b in shards]),
        "count": _np.stack([pad_nodes(b.count, 0) for b in shards]),
        "miss_next": _np.stack([pad_nodes(b.miss_next, -1)
                                for b in shards]),
        # leaf-order triangles + local prim rows + their mesh ids
        "tri_verts": _np.stack([_np.asarray(b.tri_verts) for b in shards]),
        "prim_index": _np.stack([_np.asarray(b.prim_index)
                                 for b in shards]),
        "prim_mesh_id": _np.stack(
            [mid[s * rows:(s + 1) * rows][_np.asarray(b.prim_index)]
             for b in shards]),
        "leaf_size": shards[0].leaf_size,
    }
    return {k: (jnp.asarray(v) if not isinstance(v, int) else v)
            for k, v in stacked.items()}


def scene_sharded_hit_bvh(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                          mesh: Mesh, shard_bvhs: Dict) -> Hit:
    """Regime 2 (BVH): like scene_sharded_hit but each device traverses
    its OWN BVH over its triangle shard (build_shard_bvhs) instead of
    brute force — the production TP path for large scenes."""
    from unity_raytracer_tpu.ops import bvh as bvhmod

    tp = mesh.shape[SCENE_AXIS]
    m_total = scene.meshes.count
    shard_rows = m_total // tp
    leaf_size = shard_bvhs["leaf_size"]
    rest = _rest_scene(scene)
    arrays = [shard_bvhs[k] for k in
              ("node_min", "node_max", "first", "count", "miss_next",
               "tri_verts", "prim_index", "prim_mesh_id")]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(),) + (P(SCENE_AXIS),) * 8 + (P(), P()),
             out_specs=(P(), P(), P(), P(), P()), check_vma=False)
    def _go(rest_, nmin, nmax, first, count, miss, tv, prim, pmid,
            o_, d_):
        local_bvh = bvhmod.MeshBVH(
            node_min=nmin[0], node_max=nmax[0], first=first[0],
            count=count[0], miss_next=miss[0], tri_verts=tv[0],
            prim_index=prim[0], leaf_size=leaf_size, canonical=True)
        t_m, i_loc, nrm = bvhmod.traverse(local_bvh, o_, d_)
        # scene-AABB early-out applies to mesh candidates too (Scene.cs:54)
        in_box = isect.ray_aabb(o_, d_, rest_.aabb_min[None, :],
                                rest_.aabb_max[None, :])
        t_m = jnp.where(in_box, t_m, jnp.inf)
        # fold in the replicated sphere/loose categories via nearest_hit
        # on the dummy-mesh rest scene, then merge mesh candidates.
        # Reference order evaluates mesh FIRST and later categories win
        # only on strictly smaller t (Scene.cs:94,107) — so an equal-t
        # mesh candidate keeps the win (<=).
        hit_rest = isect.nearest_hit(rest_, o_, d_)
        mesh_wins = (t_m <= hit_rest.t) & jnp.isfinite(t_m)
        kind = jnp.where(mesh_wins, isect.KIND_MESH, hit_rest.kind)
        index = jnp.where(mesh_wins, i_loc, hit_rest.index)
        t = jnp.where(mesh_wins, t_m, hit_rest.t)
        pmid_sel = jnp.where(
            mesh_wins & (i_loc >= 0),
            jnp.take(pmid[0], jnp.clip(i_loc, 0, None)), -1)
        shard_i = jax.lax.axis_index(SCENE_AXIS)
        gl_index = jnp.where(kind == isect.KIND_MESH,
                             index + shard_i * shard_rows, index)
        return _combine_partial_hits(t, kind, gl_index, pmid_sel, nrm)

    t, kind, index, mesh_index, normal = _go(rest, *arrays, o, d)
    return Hit(t=t, kind=kind, index=index, mesh_index=mesh_index,
               mesh_n=normal)


# ---------------------------------------------------------------------------
# Regime 4: Ulysses-style all-to-all reshard (axis swap between phases)
# ---------------------------------------------------------------------------

def swap_shard_axes(x: jnp.ndarray, mesh: Mesh, from_axis: str,
                    to_axis: str) -> jnp.ndarray:
    """Reshard a [N, ...] tensor from ``from_axis`` to ``to_axis`` — the
    Ulysses pattern (SURVEY.md §5.7's fourth tool): when consecutive
    pipeline phases prefer different layouts (e.g. traversal rays-major
    over dp, then a scene-sharded phase that wants each tp group to own
    a ray block), swap the sharded axis WITHOUT materializing the full
    tensor anywhere. Per-device comm volume = one target shard (the
    all-to-all optimum).

    Output GLOBAL order is the fixed block interleave
    ``x.reshape(pf, pt, -1, ...).swapaxes(0, 1).reshape(N, ...)`` —
    calling again with the axes swapped restores the original exactly
    (involution), the same way Ulysses undoes its head/sequence
    transpose after the attention phase.

    Requires N divisible by pf*pt.
    """
    p_from = mesh.shape[from_axis]
    p_to = mesh.shape[to_axis]
    n = x.shape[0]
    assert n % (p_from * p_to) == 0, (n, p_from, p_to)

    @partial(shard_map, mesh=mesh,
             in_specs=P(from_axis), out_specs=P(to_axis),
             check_vma=False)
    def _go(x_):
        # device (i on from, j on to) holds block i (replicated over
        # to_axis); it keeps its j-th chunk and gathers the j-th chunk
        # of every from-peer — together: global block j of the swapped
        # interleave
        j = jax.lax.axis_index(to_axis)
        c = x_.shape[0] // p_to
        mine = jax.lax.dynamic_slice_in_dim(x_, j * c, c, axis=0)
        return jax.lax.all_gather(mine, from_axis, axis=0, tiled=True)

    return _go(x)


# ---------------------------------------------------------------------------
# Regime 3: ring pass (rays and scene both sharded on one axis)
# ---------------------------------------------------------------------------

def nearest_mesh_hit_ring(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                          mesh: Mesh, axis: str = RAY_AXIS
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ring traversal of the mesh-triangle soup: ray shards stay resident,
    triangle shards rotate with ppermute; each step folds the running best
    (t, global index). Returns (t [N], global mesh-tri index [N] or -1).

    Communication pattern == ring attention's KV rotation; combine is min
    instead of softmax-accumulate (SURVEY.md §5.7 regime 3).
    """
    size = mesh.shape[axis]
    m_total = scene.meshes.count
    assert m_total % size == 0
    rows = m_total // size

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(axis)),
             out_specs=(P(axis), P(axis)), check_vma=False)
    def _go(mverts, mvalid, o_, d_):
        my = jax.lax.axis_index(axis)
        perm = [(i, (i + 1) % size) for i in range(size)]

        def step(carry, _):
            verts, valid, shard_id, best_t, best_i = carry
            t = isect.ray_triangles(o_, d_, verts, valid)
            i_loc = jnp.argmin(t, axis=1).astype(jnp.int32)
            # t[argmin] IS the min — reduction, not a per-lane gather
            t_loc = jnp.min(t, axis=1)
            gl = i_loc + shard_id * rows
            upd = t_loc < best_t
            best_t = jnp.where(upd, t_loc, best_t)
            best_i = jnp.where(upd, gl, best_i)
            # rotate the triangle shard (and its identity) around the ring
            verts = jax.lax.ppermute(verts, axis, perm)
            valid = jax.lax.ppermute(valid, axis, perm)
            shard_id = jax.lax.ppermute(shard_id, axis, perm)
            return (verts, valid, shard_id, best_t, best_i), None

        n_loc = o_.shape[0]
        init = (mverts, mvalid, my,
                jnp.full((n_loc,), jnp.inf, jnp.float32),
                jnp.full((n_loc,), -1, jnp.int32))
        (_, _, _, best_t, best_i), _ = jax.lax.scan(
            step, init, None, length=size)
        return best_t, best_i

    return _go(scene.meshes.verts, scene.meshes.valid, o, d)


def nearest_hit_ring(scene: Scene, o: jnp.ndarray, d: jnp.ndarray,
                     mesh: Mesh, axis: str = RAY_AXIS) -> Hit:
    """Regime 3 with FULL Hit semantics: rays and mesh triangles
    co-sharded on ``axis``; triangle shards (verts + normals + mesh ids
    + validity) rotate around the ring while each resident ray shard
    folds the running global best, then the replicated sphere/loose
    categories and scene-AABB gate fold in locally — a drop-in
    ``nearest_hit`` whose outputs are sharded over ``axis``.

    Memory: per device, rays N/p + triangles M/p — the regime for when
    NEITHER fits replicated (SURVEY.md §5.7 regime 3).
    """
    size = mesh.shape[axis]
    m_total = scene.meshes.count
    assert m_total % size == 0 and o.shape[0] % size == 0
    rows = m_total // size
    rest = _rest_scene(scene)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(axis), P(axis), P(axis), P(axis),
                       P(axis), P(axis)),
             out_specs=(P(axis),) * 5, check_vma=False)
    def _go(rest_, mverts, mnorm, mid, mvalid, o_, d_):
        my = jax.lax.axis_index(axis)
        perm = [(i, (i + 1) % size) for i in range(size)]
        n_loc = o_.shape[0]

        def step(carry, _):
            verts, norm, mids, valid, shard_id, best = carry
            best_t, best_i, best_mid, best_n = best
            t = isect.ray_triangles(o_, d_, verts, valid)
            i_loc = jnp.argmin(t, axis=1).astype(jnp.int32)
            # t[argmin] IS the min — reduction, not a per-lane gather
            t_loc = jnp.min(t, axis=1)
            upd = t_loc < best_t
            best_t = jnp.where(upd, t_loc, best_t)
            best_i = jnp.where(upd, i_loc + shard_id * rows, best_i)
            best_mid = jnp.where(upd, jnp.take(mids, i_loc), best_mid)
            best_n = jnp.where(upd[:, None],
                               jnp.take(norm, i_loc, axis=0), best_n)
            rot = lambda x: jax.lax.ppermute(x, axis, perm)
            return ((rot(verts), rot(norm), rot(mids), rot(valid),
                     rot(shard_id),
                     (best_t, best_i, best_mid, best_n)), None)

        init_best = (jnp.full((n_loc,), jnp.inf, jnp.float32),
                     jnp.full((n_loc,), -1, jnp.int32),
                     jnp.full((n_loc,), -1, jnp.int32),
                     jnp.zeros((n_loc, 3), jnp.float32))
        (_, _, _, _, _, best), _ = jax.lax.scan(
            step, (mverts, mnorm, mid, mvalid, my, init_best),
            None, length=size)
        t_m, gl, bmid, bn = best

        # scene-AABB gate applies to mesh candidates (Scene.cs:54)
        in_box = isect.ray_aabb(o_, d_, rest_.aabb_min[None, :],
                                rest_.aabb_max[None, :])
        t_m = jnp.where(in_box, t_m, jnp.inf)
        # replicated categories; mesh evaluated FIRST in the reference,
        # so equal-t mesh candidates keep the win (Scene.cs:94,107)
        hit_rest = isect.nearest_hit(rest_, o_, d_)
        mesh_wins = (t_m <= hit_rest.t) & jnp.isfinite(t_m)
        kind = jnp.where(mesh_wins, isect.KIND_MESH, hit_rest.kind)
        index = jnp.where(mesh_wins, gl, hit_rest.index)
        t = jnp.where(mesh_wins, t_m, hit_rest.t)
        mesh_index = jnp.where(mesh_wins, bmid, -1)
        return t, kind, index, mesh_index, bn

    t, kind, index, mesh_index, normal = _go(
        rest, scene.meshes.verts, scene.meshes.normals,
        scene.meshes.mesh_id, scene.meshes.valid, o, d)
    return Hit(t=t, kind=kind, index=index, mesh_index=mesh_index,
               mesh_n=normal)


def make_sharded_train_step(template: Scene, cam: Camera, rcfg: RenderConfig,
                            target: jnp.ndarray, mesh: Mesh,
                            param_names: Tuple[str, ...], tx,
                            bvh=None) -> Callable:
    """Distributed inverse-rendering step: rays sharded over dp, loss psum,
    scene-parameter grad all-reduce carried by shard_map's backward (XLA
    overlaps it with backward compute).

    Returns jitted ``step(params, opt_state, o, d, tgt) ->
    (params, opt_state, loss)`` where o/d/tgt are pre-sharded flat rays.
    ``bvh``: optional prebuilt mesh BVH, closed over and replicated —
    the config-5 shape (BVH + walk kernel under shard_map) rather than
    the brute-force fallback.
    """
    from unity_raytracer_tpu.fit import set_params

    rcfg = resolve_mode(template, rcfg)
    n_total = cam.width * cam.height

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
             out_specs=P(), check_vma=False)
    def sharded_loss(params, o_, d_, tgt_):
        scene = set_params(template, params)
        b = bvh
        if b is not None:
            # mesh-vertex gradients (PARAM_PATHS 'mesh_verts'): re-bind
            # the BVH epilogue verts to the current params — constant-
            # folds to a no-op when mesh verts are not optimized
            from unity_raytracer_tpu.ops.bvh import bind_verts
            b = bind_verts(b, scene)
        rad = trace_radiance(scene, o_, d_, rcfg, bvh=b) / 255.0
        sse = jnp.sum((rad - tgt_) ** 2)
        return jax.lax.psum(sse, RAY_AXIS) / (n_total * 3)

    @jax.jit
    def step(params, opt_state, o, d, tgt):
        loss, grads = jax.value_and_grad(
            lambda p: sharded_loss(p, o, d, tgt))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step
