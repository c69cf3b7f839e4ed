"""Record-replay backward (ops/replay.py): forward parity vs the
composed forward and gradient parity vs the composed differentiable path.

The replay freezes the discrete decisions (winner ids, occlusion bits)
and recomputes shading differentiably; at soft temps 0 the composed
path's gradients make exactly the same freeze (stop_gradient traversal,
fixed argmin winner), so grads must agree to fp noise. Runs the XLA walk
on CPU.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from unity_raytracer_tpu.models import meshgen
from unity_raytracer_tpu.models.camera import Camera, generate_rays_blocks
from unity_raytracer_tpu.models.scene import SceneBuilder, make_material
from unity_raytracer_tpu.ops import bvh as bvhmod
from unity_raytracer_tpu.ops import replay as rp
from unity_raytracer_tpu.ops.render import trace_radiance
from unity_raytracer_tpu.fit import get_params, set_params
from unity_raytracer_tpu.utils.config import RenderConfig


@pytest.fixture(scope="module")
def scene_cam():
    """Mirror sphere + mesh + loose ground tris + 2 lights: every record
    kind (sphere / loose / mesh winners, occluded + lit lights, mirror
    chain, misses) shows up in the 24x24 frame."""
    b = SceneBuilder()
    v, f = meshgen.icosphere(subdivisions=2, radius=2.0, center=(0, 2, 8))
    b.add_mesh(v, f, make_material(diffuse=(0.7, 0.5, 0.2),
                                   ambient=(0.7, 0.5, 0.2),
                                   specular=(0.6, 0.6, 0.6), phong=40.0))
    b.add_sphere((-3, 1.5, 6), 1.5, make_material(
        diffuse=(0.2, 0.1, 0.1), ambient=(0.1, 0.1, 0.1),
        specular=(1, 1, 1), phong=200.0, mirror=(0.9, 0.9, 0.9),
        is_mirror=True))
    b.add_sphere((2.5, 1.0, 4.5), 1.0, make_material(
        diffuse=(0.2, 0.6, 0.3), ambient=(0.2, 0.6, 0.3), phong=10.0))
    g = 30.0
    gmat = make_material(diffuse=(0.5, 0.5, 0.55),
                         ambient=(0.5, 0.5, 0.55), phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((5, 8, 0), 800.0)
    b.add_point_light((-6, 7, 10), 500.0)
    b.set_ambient((8, 8, 8))
    scene = b.build()
    cam = Camera.make(position=(0, 3, -4), forward=(0, -0.15, 1),
                      dist=1.0, half_h=0.8, half_v=0.8,
                      width=24, height=24)
    return scene, cam


CFG = RenderConfig(max_bounces=2, background=(0.04, 0.05, 0.07),
                   use_bvh=True, mode="scan", block_size=8)


def _rays(cam, cfg):
    return generate_rays_blocks(cam, cfg.block_size)


def test_replay_forward_matches_mega(scene_cam):
    scene, cam = scene_cam
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = _rays(cam, CFG)
    rad_ref = np.asarray(trace_radiance(scene, o, d, CFG, bvh=bvh))
    rad_rep = np.asarray(rp.trace_radiance_replay(scene, o, d, CFG, bvh))
    assert np.isfinite(rad_rep).all()
    np.testing.assert_allclose(rad_rep, rad_ref, rtol=2e-4, atol=2e-4)
    assert rad_ref.std() > 1.0  # scene actually shades something


def test_replay_grads_match_composed(scene_cam):
    """Grad parity vs jax.grad through the composed path (kernel='xla'
    BVH traversal + differentiable winner re-derivation) at temps 0,
    for the parameter classes the replay differentiates."""
    scene, cam = scene_cam
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = _rays(cam, CFG)
    names = ("sphere_centers", "sphere_radius_sq", "sphere_diffuse",
             "sphere_specular", "sphere_mirror", "tri_verts",
             "tri_diffuse", "light_positions", "light_intensities")
    params = get_params(scene, names)
    target = jax.lax.stop_gradient(trace_radiance(
        scene, o, d, CFG.with_(kernel="xla"), bvh=bvh)) * 0.9

    def composed_loss(p):
        s = set_params(scene, p)
        rad = trace_radiance(s, o, d, CFG.with_(kernel="xla"), bvh=bvh)
        return jnp.mean((rad - target) ** 2)

    loss_c, g_c = jax.value_and_grad(composed_loss)(params)
    loss_r, g_r = rp.replay_value_and_grad(
        scene, params, o, d, target, CFG, bvh)

    np.testing.assert_allclose(float(loss_r), float(loss_c),
                               rtol=1e-4, atol=1e-6)
    for k in names:
        a, b = np.asarray(g_r[k]), np.asarray(g_c[k])
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(
            a, b, rtol=5e-3, atol=5e-4 * scale,
            err_msg=f"grad mismatch for {k}")
        # classes that matter must have signal, not zeros
        if k in ("sphere_centers", "sphere_diffuse",
                 "light_intensities"):
            assert np.abs(b).max() > 0, k


def test_replay_records_shapes(scene_cam):
    scene, cam = scene_cam
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = _rays(cam, CFG)
    acc, (rt, rn, rmat, rocc) = rp.trace_records(
        scene, o, d, CFG, bvh)
    B, N = CFG.max_bounces + 1, o.shape[0]
    assert rt.shape == (B, N) and rn.shape == (B, N, 3)
    assert rmat.shape == (B, N) and rocc.shape == (B, N)
    # segment 0 must contain hits of all three kinds
    S = scene.spheres.count
    T = scene.triangles.count
    m0 = np.asarray(rmat[0])
    assert ((m0 >= 0) & (m0 < S)).any(), "no sphere winner recorded"
    assert ((m0 >= S) & (m0 < S + T)).any(), "no loose-tri winner"
    assert (m0 >= S + T).any(), "no mesh winner"
    # some light occluded somewhere (shadow bits exercised)
    assert (np.asarray(rocc) > 0).any()


def test_replay_shipped_knobs_with_light_cull(scene_cam):
    """Replay parity with fat leaves WITH light_cull active: the
    forward must match the composed forward (the records reflect the
    culled queries) and grads must match the composed path under the
    same gate."""
    scene, cam = scene_cam
    cfg = CFG.with_(bvh_leaf=8, light_cull=2.0)
    bvh = bvhmod.prepare_bvh(scene, cfg)
    assert bvh.leaf_size == 8
    o, d = _rays(cam, cfg)
    rad_ref = np.asarray(trace_radiance(scene, o, d, cfg, bvh=bvh))
    rad_rep = np.asarray(rp.trace_radiance_replay(scene, o, d, cfg, bvh))
    np.testing.assert_allclose(rad_rep, rad_ref, rtol=2e-4, atol=2e-4)

    names = ("sphere_centers", "sphere_diffuse", "light_intensities")
    params = get_params(scene, names)
    target = jax.lax.stop_gradient(trace_radiance(
        scene, o, d, cfg.with_(kernel="xla"), bvh=bvh)) * 0.9

    def composed_loss(p):
        s = set_params(scene, p)
        rad = trace_radiance(s, o, d, cfg.with_(kernel="xla"), bvh=bvh)
        return jnp.mean((rad - target) ** 2)

    loss_c, g_c = jax.value_and_grad(composed_loss)(params)
    loss_r, g_r = rp.replay_value_and_grad(
        scene, params, o, d, target, cfg, bvh)
    np.testing.assert_allclose(float(loss_r), float(loss_c),
                               rtol=1e-4, atol=1e-6)
    for k in names:
        a, b = np.asarray(g_r[k]), np.asarray(g_c[k])
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4 * scale,
                                   err_msg=f"grad mismatch for {k}")
        assert np.abs(b).max() > 0, k


def test_replay_live_prefix_exact(scene_cam):
    """The static live-segment prefix (in place of a
    dynamic cond skip, which keeps both branches' residuals) must reproduce the full replay
    EXACTLY when k = live_depth(records)."""
    scene, cam = scene_cam
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = _rays(cam, CFG)
    _, recs = rp.trace_records(scene, o, d, CFG,
                               bvh)
    k = rp.live_depth(recs)
    assert 1 <= k <= CFG.max_bounces + 1
    full = np.asarray(rp.replay_radiance(scene, o, d, recs, CFG))
    pref = np.asarray(rp.replay_radiance(scene, o, d, recs, CFG,
                                         live_segments=k))
    np.testing.assert_array_equal(pref, full)
    # an overlong prefix is also exact (extra segments are all-dead)
    over = np.asarray(rp.replay_radiance(scene, o, d, recs, CFG,
                                         live_segments=k + 1))
    np.testing.assert_array_equal(over, full)
