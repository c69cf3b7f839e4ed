"""Replay records (ops/replay.trace_records) built from the composed pieces:
shapes, hard facts equal to nearest_hit / the shadow queries, the soft
record equal to the minimum mesh-occluder distance, and the same records
through the interpreted GPU walk kernel."""

import numpy as np
import pytest

import jax.numpy as jnp

from unity_raytracer_tpu.models import meshgen
from unity_raytracer_tpu.models.camera import Camera, generate_rays_blocks
from unity_raytracer_tpu.models.scene import SceneBuilder, make_material
from unity_raytracer_tpu.ops import bvh as bvhmod
from unity_raytracer_tpu.ops import intersect as isect
from unity_raytracer_tpu.ops import replay as rp
from unity_raytracer_tpu.ops import shade as sh
from unity_raytracer_tpu.ops.render import trace_radiance
from unity_raytracer_tpu.utils.config import RenderConfig

CFG = RenderConfig(max_bounces=2, background=(0.04, 0.05, 0.07),
                   use_bvh=True, mode="scan", block_size=8)


@pytest.fixture(scope="module")
def setup():
    """Mesh between a mirror sphere and the lights: mesh, sphere and loose
    winners, mirror chains and mesh-occluded shadow rays at 16x16."""
    b = SceneBuilder()
    v, f = meshgen.icosphere(subdivisions=2, radius=1.6,
                             center=(1.5, 3.5, 6.0))
    b.add_mesh(v, f, make_material(diffuse=(0.7, 0.5, 0.2),
                                   ambient=(0.7, 0.5, 0.2), phong=10.0))
    b.add_sphere((-2.5, 1.5, 7), 1.5, make_material(
        diffuse=(0.2, 0.1, 0.1), ambient=(0.1, 0.1, 0.1),
        specular=(1, 1, 1), phong=200.0, mirror=(0.9, 0.9, 0.9),
        is_mirror=True))
    g = 30.0
    gmat = make_material(diffuse=(0.5, 0.5, 0.55),
                         ambient=(0.5, 0.5, 0.55), phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((5, 9, 3), 800.0)
    b.add_point_light((-6, 7, 10), 500.0)
    b.set_ambient((8, 8, 8))
    scene = b.build()
    cam = Camera.make(position=(0, 3, -4), forward=(0, -0.15, 1),
                      dist=1.0, half_h=0.8, half_v=0.8, width=16, height=16)
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = generate_rays_blocks(cam, CFG.block_size)
    return scene, bvh, o, d


@pytest.mark.parametrize("soft", [False, True])
def test_record_shapes(setup, soft):
    scene, bvh, o, d = setup
    acc, recs = rp.trace_records(scene, o, d, CFG, bvh, soft=soft)
    B, N, L = CFG.max_bounces + 1, o.shape[0], 2
    assert acc.shape == (N, 3)
    shapes = [(B, N), (B, N, 3), (B, N), (B, N)] + ([(B, N, L)] if soft
                                                    else [])
    assert [r.shape for r in recs] == shapes
    assert all(r.dtype == jnp.float32 for r in recs)


def test_records_radiance_equals_composed(setup):
    scene, bvh, o, d = setup
    acc, _ = rp.trace_records(scene, o, d, CFG, bvh)
    ref = trace_radiance(scene, o, d, CFG, bvh=bvh)
    np.testing.assert_allclose(np.asarray(acc), np.asarray(ref),
                               rtol=1e-5, atol=1e-4)


def test_hard_records_equal_nearest_hit_and_shadow_queries(setup):
    """Segment 0 of the records is the primary nearest_hit and the
    shadow-query occlusion of its hit points."""
    scene, bvh, o, d = setup
    _, (rt, rn, rmat, rocc) = rp.trace_records(scene, o, d, CFG, bvh)
    hit = isect.nearest_hit(scene, o, d, bvh=bvh)
    mask = np.asarray(hit.is_hit)
    t0 = np.asarray(rt[0])
    assert mask.any() and (~mask).any()
    np.testing.assert_array_equal(t0 >= 0, mask)
    np.testing.assert_allclose(t0[mask], np.asarray(hit.t)[mask], rtol=1e-5)
    S, T = scene.spheres.count, scene.triangles.count
    kind = np.asarray(hit.kind)
    idx = np.asarray(hit.index)
    comb = np.where(kind == isect.KIND_SPHERE, idx,
                    np.where(kind == isect.KIND_TRI, S + idx,
                             S + T + np.asarray(hit.mesh_index)))
    np.testing.assert_array_equal(np.asarray(rmat[0])[mask], comb[mask])
    assert (np.asarray(rmat[0])[mask] >= S + T).any()  # mesh winners

    p = o + d * jnp.where(hit.is_hit, hit.t, 1.0)[:, None]
    n, mats = sh.surface_attributes(scene, p, hit)
    np.testing.assert_allclose(np.asarray(rn[0])[mask],
                               np.asarray(n)[mask], atol=1e-4)
    q = sh.shadow_queries(scene, p, n, mats, bvh=bvh, mask=hit.is_hit)
    occ = np.asarray(q.need & (q.st * q.st < q.ldist_sq))
    bits = occ[:, 0] * 1 + occ[:, 1] * 2
    np.testing.assert_array_equal(np.asarray(rocc[0]), bits)
    assert bits.any()


def test_soft_record_is_min_mesh_occluder_distance(setup):
    """st[0] = per light, the nearest mesh triangle along the shadow ray
    below the light distance (brute force over the triangle soup), or
    the no-occluder value where none / where no ray was issued."""
    scene, bvh, o, d = setup
    _, recs = rp.trace_records(scene, o, d, CFG, bvh, soft=True)
    st = np.asarray(recs[4][0])
    hit = isect.nearest_hit(scene, o, d, bvh=bvh)
    p = o + d * jnp.where(hit.is_hit, hit.t, 1.0)[:, None]
    n, mats = sh.surface_attributes(scene, p, hit)
    q = sh.shadow_queries(scene, p, n, mats, bvh=bvh, mask=hit.is_hit,
                          any_hit=False)
    so = p + n * sh.SHADOW_EPS
    found = 0
    for l in range(2):
        t = np.asarray(isect.ray_triangles(
            so, q.ldir[:, l], scene.meshes.verts,
            scene.meshes.valid)).min(axis=1)
        ldist = np.sqrt(np.asarray(q.ldist_sq[:, l]))
        need = np.asarray(q.need[:, l])
        occluded = need & (t < ldist)
        np.testing.assert_allclose(st[occluded, l], t[occluded], rtol=1e-5)
        assert (st[~occluded, l] == np.float32(3.0e38)).all()
        found += occluded.sum()
    assert found > 0  # the scene really has mesh-occluded shadow rays


def test_records_through_interpreted_kernel_match(setup):
    scene, bvh, o, d = setup
    _, ra = rp.trace_records(scene, o, d, CFG, bvh, soft=True)
    _, rb = rp.trace_records(scene, o, d, CFG.with_(kernel="interpret"),
                             bvh, soft=True)
    for a, b in zip(ra, rb):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)
