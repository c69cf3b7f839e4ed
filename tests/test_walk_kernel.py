"""The GPU BVH walk kernel (ops/pallas/walk.py) against the XLA walk.

On the CPU the kernel runs in the Pallas interpreter: the same kernel
body, so the same per-lane walk. Cases stay tiny (<= 256 rays, <= 500
triangles). The compiled kernel is checked on the card by the ``gpu``
tests at the end and by chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from unity_raytracer_tpu.models import meshgen
from unity_raytracer_tpu.ops import bvh as bvhmod
from unity_raytracer_tpu.ops.pallas import walk as wk

N_RAYS = 200       # not a multiple of the block
BLOCK = 64


def _icosphere(leaf):
    v, f = meshgen.icosphere(subdivisions=2, radius=2.0, center=(0, 0, 6))
    return bvhmod.build(v[f], leaf_size=leaf)


def _two_mesh(leaf):
    v1, f1 = meshgen.icosphere(subdivisions=2, radius=1.5, center=(-1, 0, 6))
    v2, f2 = meshgen.icosphere(subdivisions=1, radius=1.0,
                               center=(1.5, 0.5, 5))
    return bvhmod.build(np.concatenate([v1[f1], v2[f2]]), leaf_size=leaf)


def _padded(leaf):
    """A mesh table with invalid (padding) rows, as SceneBuilder pads."""
    v, f = meshgen.icosphere(subdivisions=1, radius=2.0, center=(0, 0, 6))
    tris = np.concatenate([v[f], np.zeros((48, 3, 3), np.float32)])
    valid = np.arange(tris.shape[0]) < f.shape[0]
    return bvhmod.build(tris, valid, leaf_size=leaf)


def _empty(leaf):
    return bvhmod.build(np.zeros((0, 3, 3), np.float32), leaf_size=leaf)


SCENES = {"icosphere": _icosphere, "two_mesh": _two_mesh,
          "padded": _padded, "empty": _empty, "all_miss": _icosphere}


def _rays(scene, query):
    rng = np.random.default_rng(7)
    o = rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.5
    aim = rng.normal(size=(N_RAYS, 3)) * 1.8 + np.array([0.0, 0.0, 6.0])
    if scene == "all_miss":  # pointing away from the mesh
        aim = -aim
    d = aim - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if query == "culled":  # a quarter of the lanes culled, a short t_max
        t_max = np.where(rng.random(N_RAYS) < 0.25, -1.0, 5.5)
    else:
        t_max = np.full(N_RAYS, np.inf)
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max, jnp.float32)


@pytest.mark.parametrize("leaf", [4, 8])
@pytest.mark.parametrize("query", ["nearest", "any_hit", "culled"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_walk_kernel_matches_xla_walk(scene, query, leaf):
    bvh = SCENES[scene](leaf)
    o, d, t_max = _rays(scene, query)
    any_hit = query == "any_hit"
    t_k, i_k = wk.walk(bvh, o, d, t_max, any_hit=any_hit, block=BLOCK,
                       interpret=True)
    t_x, i_x = bvhmod._walk_xla(bvh, o, d, t_max, any_hit=any_hit)
    assert t_k.shape == (N_RAYS,) and i_k.shape == (N_RAYS,)
    np.testing.assert_array_equal(np.asarray(i_k), np.asarray(i_x))
    # same walk; the leaf test's sums may round in another order
    np.testing.assert_allclose(np.asarray(t_k), np.asarray(t_x), rtol=1e-6)
    hits = np.asarray(i_x) >= 0
    if scene in ("empty", "all_miss"):
        assert not hits.any()
    elif query != "culled":
        assert hits.mean() > 0.2  # the rays actually reach the mesh
    if query == "culled":
        assert (np.asarray(i_k)[np.asarray(t_max) < 0] == -1).all()


def test_traverse_any_interpret_matches_traverse():
    """The routed kernel path returns what ``traverse`` returns: original
    prim ids, the differentiable t and the shading normal."""
    bvh = _two_mesh(4)
    o, d, _ = _rays("two_mesh", "nearest")
    t_k, p_k, n_k = bvhmod.traverse_any(bvh, o, d, kernel="interpret")
    t_x, p_x, n_x = bvhmod.traverse(bvh, o, d)
    np.testing.assert_array_equal(np.asarray(p_k), np.asarray(p_x))
    np.testing.assert_allclose(np.asarray(t_k), np.asarray(t_x), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(n_k), np.asarray(n_x))


def test_walk_kernel_gradient_rule():
    """Pallas has no autodiff: the walk runs on stop_gradient data and the
    epilogue re-derives t, so d t / d(origin) through the kernel route
    equals the XLA route's."""
    bvh = _icosphere(4)
    o, d, _ = _rays("icosphere", "nearest")

    def total_t(o_, kernel):
        t, _, _ = bvhmod.traverse_any(bvh, o_, d, kernel=kernel)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    g_k = jax.grad(total_t)(o, "interpret")
    g_x = jax.grad(total_t)(o, "xla")
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_x), rtol=1e-6)
    assert np.abs(np.asarray(g_x)).max() > 0


@pytest.mark.parametrize("block", [48, 100])
def test_walk_block_must_be_power_of_two(block):
    bvh = _icosphere(4)
    o, d, t_max = _rays("icosphere", "nearest")
    with pytest.raises(ValueError, match="power of two"):
        wk.walk(bvh, o, d, t_max, block=block, interpret=True)


def test_walk_leaf_size_limit():
    v, f = meshgen.icosphere(subdivisions=1, radius=1.0)
    bvh = bvhmod.build(v[f], leaf_size=16)
    with pytest.raises(ValueError, match="leaf_size"):
        wk.pack_nodes(bvh)


def test_pack_nodes_round_trip():
    """The packed rows decode back to the MeshBVH arrays they came from."""
    bvh = _two_mesh(8)
    rows = np.asarray(wk.pack_nodes(bvh)).reshape(-1, wk.NODE_ROW)
    np.testing.assert_array_equal(rows[:, 0:3], np.asarray(bvh.node_min))
    np.testing.assert_array_equal(rows[:, 3:6], np.asarray(bvh.node_max))
    ints = rows[:, 6:8].view(np.int32)
    np.testing.assert_array_equal(ints[:, 0], np.asarray(bvh.miss_next))
    leaf = np.asarray(bvh.first) >= 0
    assert (ints[~leaf, 1] == -1).all()
    np.testing.assert_array_equal(ints[leaf, 1] >> 4,
                                  np.asarray(bvh.first)[leaf])
    np.testing.assert_array_equal(ints[leaf, 1] & 15,
                                  np.asarray(bvh.count)[leaf])
    tris = np.asarray(wk.pack_tris(bvh)).reshape(-1, wk.TRI_ROW)
    v = np.asarray(bvh.tri_verts)
    np.testing.assert_array_equal(tris[:, 3:6], v[:, 1] - v[:, 0])


@pytest.mark.gpu
def test_walk_kernel_compiled_matches_xla_walk(gpu):
    """The compiled Triton kernel picks the same triangles as the XLA walk
    on the card (FMA contraction may flip a grazing lane)."""
    bvh = _two_mesh(4)
    rng = np.random.default_rng(3)
    n = 1 << 16
    o = jnp.asarray(rng.normal(size=(n, 3)) * 0.5, jnp.float32)
    d = rng.normal(size=(n, 3)) * 1.8 + np.array([0.0, 0.0, 6.0])
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    t_max = jnp.full((n,), jnp.inf, jnp.float32)
    for any_hit in (False, True):
        _, i_k = wk.walk(bvh, o, d, t_max, any_hit=any_hit)
        _, i_x = bvhmod._walk_xla(bvh, o, d, t_max, any_hit=any_hit)
        assert np.mean(np.asarray(i_k) == np.asarray(i_x)) >= 0.9999
