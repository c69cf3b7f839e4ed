"""Multi-device tests on the virtual 8-device CPU mesh.

Distributed-correctness-as-race-detector (SURVEY.md §5.2): the same pixels
must come out regardless of device count or sharding regime.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from unity_raytracer_tpu.fit import get_params
from unity_raytracer_tpu.models.camera import generate_rays
from unity_raytracer_tpu.models.presets import three_spheres, mesh_scene
from unity_raytracer_tpu.ops import intersect as isect
from unity_raytracer_tpu.ops.render import render, resolve_mode, trace_radiance
from unity_raytracer_tpu.parallel import collectives
from unity_raytracer_tpu.parallel import mesh as meshmod
from unity_raytracer_tpu.parallel import shard as shardmod


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must fake 8 cpu devices"
    return meshmod.make_mesh((8, 1))


@pytest.fixture(scope="module")
def mesh42():
    return meshmod.make_mesh((4, 2))


def test_render_tiled_matches_single(mesh8):
    scene, cam, cfg = three_spheres(width=32, height=32)
    ref = np.asarray(render(scene, cam, cfg))
    out = np.asarray(shardmod.render_tiled(scene, cam, cfg, mesh8))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_render_auto_matches_single(mesh8):
    scene, cam, cfg = three_spheres(width=32, height=32)
    ref = np.asarray(render(scene, cam, cfg))
    out = np.asarray(shardmod.render_auto(scene, cam, cfg, mesh8))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_render_tiled_2d_mesh(mesh42):
    scene, cam, cfg = three_spheres(width=32, height=32)
    ref = np.asarray(render(scene, cam, cfg))
    out = np.asarray(shardmod.render_tiled(scene, cam, cfg, mesh42))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_scene_sharded_hit_matches(mesh42):
    # mesh triangles padded to a multiple of tp=2
    scene, cam, cfg = mesh_scene(100, width=16, height=16)
    m = scene.meshes.count
    assert m % 2 == 0
    o, d = generate_rays(cam)
    ref = isect.nearest_hit(scene, o, d)
    got = shardmod.scene_sharded_hit(scene, o, d, mesh42)
    np.testing.assert_array_equal(np.asarray(got.kind), np.asarray(ref.kind))
    hit = np.asarray(ref.kind) != isect.KIND_NONE
    np.testing.assert_allclose(np.asarray(got.t)[hit],
                               np.asarray(ref.t)[hit], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.index)[hit],
                                  np.asarray(ref.index)[hit])
    np.testing.assert_array_equal(np.asarray(got.mesh_index),
                                  np.asarray(ref.mesh_index))


def test_render_tiled_bvh_matches(mesh8):
    """Config-5 shape under shard_map: BVH walk (XLA loop) inside
    the tile-sharded renderer must match the single-device image."""
    from unity_raytracer_tpu.ops import bvh as bvhmod

    scene, cam, cfg = mesh_scene(100, width=16, height=16)
    cfg = resolve_mode(scene, cfg.with_(use_bvh=True, kernel="xla"))
    bvh = bvhmod.prepare_bvh(scene, cfg)
    ref = np.asarray(render(scene, cam, cfg, bvh=bvh))
    out = np.asarray(shardmod.render_tiled(scene, cam, cfg, mesh8,
                                           bvh=bvh))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_render_tiled_pallas_interpret_matches(mesh8):
    """The GPU walk kernel (Pallas interpreter on CPU) under shard_map,
    bounce chain (scan mode) — the flagship distributed path end to end
    — against the single-device XLA walk."""
    from unity_raytracer_tpu.ops import bvh as bvhmod

    scene, cam, cfg = mesh_scene(100, width=16, height=16)
    cfg = resolve_mode(scene, cfg.with_(use_bvh=True, kernel="interpret",
                                        max_bounces=1))
    assert cfg.mode == "scan"
    bvh = bvhmod.prepare_bvh(scene, cfg)
    ref = np.asarray(render(scene, cam, cfg.with_(kernel="xla"), bvh=bvh))
    out = np.asarray(shardmod.render_tiled(scene, cam, cfg, mesh8,
                                           bvh=bvh))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_render_tiled_mega_interpret_matches(mesh8):
    """The GPU walk kernel (Pallas interpreter on CPU) under shard_map
    on the TREE path (level-synchronous wavefront with fork compaction)
    against the single-device XLA walk."""
    from unity_raytracer_tpu.ops import bvh as bvhmod

    scene, cam, cfg = mesh_scene(100, width=16, height=16)
    cfg = cfg.with_(use_bvh=True, kernel="interpret", max_bounces=1,
                    mode="tree", block_size=4)
    bvh = bvhmod.prepare_bvh(scene, cfg)
    ref = np.asarray(render(scene, cam, cfg.with_(kernel="xla"), bvh=bvh))
    out = np.asarray(shardmod.render_tiled(scene, cam, cfg, mesh8,
                                           bvh=bvh))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_scene_sharded_non_replication(mesh42):
    """The TP regime's point: the [M]-row mesh arrays exist ONLY as
    shards. The replicated operand carries 1-row dummies and a placed
    scene holds M/tp rows per device."""
    scene, cam, cfg = mesh_scene(100, width=8, height=8)
    rest = shardmod._rest_scene(scene)
    assert rest.meshes.verts.shape == (1, 3, 3)
    assert rest.meshes.normals.shape == (1, 3)
    assert rest.meshes.valid.shape == (1,)
    placed = shardmod.shard_scene_mesh_tris(scene, mesh42)
    m = scene.meshes.count
    for s in placed.meshes.verts.addressable_shards:
        assert s.data.shape[0] == m // 2, s.data.shape


def test_scene_sharded_normal_carry(mesh42):
    """The winner shard carries its stored shading normal across the
    combine — shading needs no global [M] normal table."""
    scene, cam, cfg = mesh_scene(100, width=16, height=16)
    o, d = generate_rays(cam)
    got = shardmod.scene_sharded_hit(scene, o, d, mesh42)
    ref = isect.nearest_hit(scene, o, d)
    mesh_hit = np.asarray(ref.kind) == isect.KIND_MESH
    assert mesh_hit.any()
    want = np.asarray(scene.meshes.normals)[
        np.asarray(ref.index)[mesh_hit]]
    np.testing.assert_allclose(np.asarray(got.mesh_n)[mesh_hit], want,
                               rtol=1e-5, atol=1e-6)


def test_scene_sharded_hit_bvh_matches(mesh42):
    """Regime 2 production path: per-shard BVH traversal + combine must
    equal the single-device brute nearest hit."""
    scene, cam, cfg = mesh_scene(100, width=16, height=16)
    o, d = generate_rays(cam)
    ref = isect.nearest_hit(scene, o, d)
    sb = shardmod.build_shard_bvhs(scene, tp=2)
    got = shardmod.scene_sharded_hit_bvh(scene, o, d, mesh42, sb)
    np.testing.assert_array_equal(np.asarray(got.kind),
                                  np.asarray(ref.kind))
    hit = np.asarray(ref.kind) != isect.KIND_NONE
    np.testing.assert_allclose(np.asarray(got.t)[hit],
                               np.asarray(ref.t)[hit], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.index)[hit],
                                  np.asarray(ref.index)[hit])
    np.testing.assert_array_equal(np.asarray(got.mesh_index),
                                  np.asarray(ref.mesh_index))
    mesh_hit = np.asarray(ref.kind) == isect.KIND_MESH
    want = np.asarray(scene.meshes.normals)[
        np.asarray(ref.index)[mesh_hit]]
    np.testing.assert_allclose(np.asarray(got.mesh_n)[mesh_hit], want,
                               rtol=1e-4, atol=1e-5)


def test_ring_hit_matches(mesh8):
    scene, cam, cfg = mesh_scene(100, width=16, height=16)
    o, d = generate_rays(cam)
    n = o.shape[0]
    assert n % 8 == 0 and scene.meshes.count % 8 == 0, (n, scene.meshes.count)
    t_ref = isect.ray_triangles(o, d, scene.meshes.verts, scene.meshes.valid)
    i_ref = jnp.argmin(t_ref, axis=1)
    tmin_ref = np.asarray(jnp.min(t_ref, axis=1))
    t_got, i_got = shardmod.nearest_mesh_hit_ring(scene, o, d, mesh8)
    hit = np.isfinite(tmin_ref)
    np.testing.assert_allclose(np.asarray(t_got)[hit], tmin_ref[hit],
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(i_got)[hit],
                                  np.asarray(i_ref)[hit])
    assert (np.asarray(i_got)[~hit] == -1).all()


def test_nearest_hit_ring_full_semantics(mesh8):
    """Ring regime as a drop-in nearest_hit: kind/index/mesh_index/t and
    the carried shading normal all match the single-device result."""
    scene, cam, cfg = mesh_scene(100, width=16, height=16)
    o, d = generate_rays(cam)
    assert o.shape[0] % 8 == 0 and scene.meshes.count % 8 == 0
    ref = isect.nearest_hit(scene, o, d)
    got = shardmod.nearest_hit_ring(scene, o, d, mesh8)
    np.testing.assert_array_equal(np.asarray(got.kind),
                                  np.asarray(ref.kind))
    hit = np.asarray(ref.kind) != isect.KIND_NONE
    np.testing.assert_allclose(np.asarray(got.t)[hit],
                               np.asarray(ref.t)[hit], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.index)[hit],
                                  np.asarray(ref.index)[hit])
    np.testing.assert_array_equal(np.asarray(got.mesh_index),
                                  np.asarray(ref.mesh_index))
    mesh_hit = np.asarray(ref.kind) == isect.KIND_MESH
    want = np.asarray(scene.meshes.normals)[
        np.asarray(ref.index)[mesh_hit]]
    np.testing.assert_allclose(np.asarray(got.mesh_n)[mesh_hit], want,
                               rtol=1e-5, atol=1e-6)


def test_swap_shard_axes_involution(mesh42):
    """Ulysses reshard: declared block-interleave order, exact
    involution, and per-device shards actually live on the target axis."""
    n = 4 * 2 * 6
    x = jnp.arange(n * 3, dtype=jnp.float32).reshape(n, 3)
    y = shardmod.swap_shard_axes(x, mesh42, "dp", "tp")
    want = np.asarray(x).reshape(4, 2, -1, 3).swapaxes(0, 1).reshape(n, 3)
    np.testing.assert_array_equal(np.asarray(y), want)
    back = shardmod.swap_shard_axes(y, mesh42, "tp", "dp")
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_min_hit_combine_tie_break(mesh8):
    """Equal t on every device -> smallest packed key (category order) wins."""
    from functools import partial
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    t = jnp.ones((8, 4), jnp.float32)
    key = jnp.stack([jnp.full((4,), i, jnp.int32) + 1 for i in range(8)])

    @partial(shard_map, mesh=mesh8, in_specs=(P("dp"), P("dp")),
             out_specs=(P("dp"), P("dp")), check_vma=False)
    def go(t_, k_):
        tt, kk = collectives.min_hit_combine(t_[0], k_[0], "dp")
        return tt[None], kk[None]

    t_out, k_out = go(t, key)
    assert (np.asarray(k_out) == 1).all()


def test_sharded_train_step_matches_single_device(mesh8):
    """Grad psum correctness: one sharded Adam step == one local step."""
    scene, _, cfg = three_spheres(width=16, height=16)
    cfg = resolve_mode(scene, cfg.with_(max_bounces=0))
    from unity_raytracer_tpu.models.camera import Camera
    cam = Camera.from_fov(position=(0, 5, 6), look_at=(0, 2.5, 26),
                          fov_y_deg=40.0, width=16, height=16)
    target = render(scene, cam, cfg)
    o, d = generate_rays(cam)
    tgt_flat = target.reshape(-1, 3)

    params0 = get_params(scene, ("sphere_centers",))
    params0 = {k: v + 0.3 for k, v in params0.items()}
    tx = optax.adam(0.02)

    # single-device reference step
    from unity_raytracer_tpu.fit import set_params

    def loss_local(p):
        s = set_params(scene, p)
        rad = trace_radiance(s, o, d, cfg) / 255.0
        return jnp.sum((rad - tgt_flat) ** 2) / tgt_flat.size

    l_ref, g_ref = jax.value_and_grad(loss_local)(params0)
    st_ref = tx.init(params0)
    up_ref, _ = tx.update(g_ref, st_ref, params0)
    p_ref = optax.apply_updates(params0, up_ref)

    step = shardmod.make_sharded_train_step(
        scene, cam, cfg, tgt_flat, mesh8, ("sphere_centers",), tx)
    p_out, _, l_out = step(params0, tx.init(params0), o, d, tgt_flat)

    assert np.isclose(float(l_out), float(l_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p_out["sphere_centers"]),
                               np.asarray(p_ref["sphere_centers"]),
                               rtol=1e-4, atol=1e-5)


def test_sharded_fit_convergence_matches_single(mesh8):
    """Config-5 in miniature: a tile-sharded FIT — BVH + the walk
    kernel (interpreted) under shard_map + grad-psum Adam — run for
    N steps on 8 virtual devices; the loss TRAJECTORY must match the
    single-device loop step for step, and it must actually descend."""
    from unity_raytracer_tpu.fit import set_params
    from unity_raytracer_tpu.ops import bvh as bvhmod

    scene, cam, cfg = mesh_scene(100, width=16, height=16)
    cfg = resolve_mode(scene, cfg.with_(use_bvh=True, kernel="interpret",
                                        max_bounces=1))
    packed = bvhmod.prepare_bvh(scene, cfg)
    target = render(scene, cam, cfg, bvh=packed)
    o, d = generate_rays(cam)
    tgt_flat = target.reshape(-1, 3)
    names = ("sphere_centers", "sphere_diffuse")
    true_p = get_params(scene, names)
    start = {"sphere_centers": true_p["sphere_centers"] + 0.25,
             "sphere_diffuse": jnp.clip(true_p["sphere_diffuse"] + 0.1,
                                        0.0, 1.0)}
    tx = optax.adam(0.03)
    n_steps = 5

    # single-device reference loop (same loss formula as sharded_loss)
    def loss_local(p):
        s = set_params(scene, p)
        rad = trace_radiance(s, o, d, cfg, bvh=packed) / 255.0
        return jnp.sum((rad - tgt_flat) ** 2) / tgt_flat.size

    p_ref = dict(start)
    st_ref = tx.init(p_ref)
    losses_ref = []
    for _ in range(n_steps):
        l, g = jax.value_and_grad(loss_local)(p_ref)
        up, st_ref = tx.update(g, st_ref, p_ref)
        p_ref = optax.apply_updates(p_ref, up)
        losses_ref.append(float(l))

    step = shardmod.make_sharded_train_step(
        scene, cam, cfg, tgt_flat, mesh8, names, tx, bvh=packed)
    p_sh = dict(start)
    st_sh = tx.init(p_sh)
    losses_sh = []
    for _ in range(n_steps):
        p_sh, st_sh, l = step(p_sh, st_sh, o, d, tgt_flat)
        losses_sh.append(float(l))

    np.testing.assert_allclose(losses_sh, losses_ref, rtol=1e-4)
    assert losses_sh[-1] < losses_sh[0] * 0.9, losses_sh
    for k in names:
        np.testing.assert_allclose(np.asarray(p_sh[k]),
                                   np.asarray(p_ref[k]),
                                   rtol=1e-3, atol=1e-4)
