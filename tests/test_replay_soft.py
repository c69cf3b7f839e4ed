"""Soft record-replay (ops/replay.replay_radiance_soft): the fast
silhouette-fitting fwd+bwd path.

Claims under test (module docstring of replay_radiance_soft):
* forward VALUE == the hard forward image exactly (straight-through);
* gradients == the composed soft path wherever no MESH occluder sits in
  a soft band (sphere/loose terms are recomputed exactly; mesh facts are
  frozen) — proven on a scene whose mesh cannot occlude anything;
* on a mesh-shadowed scene the gradients are finite, nonzero, and the
  path drives a fit downhill.

Runs the XLA walk on CPU.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True, scope="module")
def _fresh_compiler_state():
    """Full-suite runs deterministically SIGSEGV inside XLA:CPU's
    backend_compile on this module's chunked-scan program (while the
    module alone is green) — a cumulative compiler-state condition, not
    a test bug; raising RLIMIT_STACK did not clear it (glibc sizes new
    pthread stacks at 8 MB under an unlimited rlimit). Dropping the
    session's accumulated executables/tracing caches before this
    module's big compiles removes the accumulation half of the
    trigger."""
    jax.clear_caches()
    yield

from unity_raytracer_tpu.models import meshgen
from unity_raytracer_tpu.models.camera import Camera, generate_rays_blocks
from unity_raytracer_tpu.models.scene import SceneBuilder, make_material
from unity_raytracer_tpu.ops import bvh as bvhmod
from unity_raytracer_tpu.ops import replay as rp
from unity_raytracer_tpu.ops.render import trace_radiance
from unity_raytracer_tpu.fit import get_params, set_params
from unity_raytracer_tpu.utils.config import DiffConfig, RenderConfig

SOFT = DiffConfig(soft_shadow_temp=1.0, soft_hit_temp=0.1,
                  straight_through=True)
CFG = RenderConfig(max_bounces=2, background=(0.04, 0.05, 0.07),
                   use_bvh=True, mode="scan", block_size=8,
                   diff=SOFT)


def _build(mesh_center):
    """Two spheres (one mirror) + ground + 2 lights + an icosphere mesh
    at ``mesh_center`` (mesh records need a mesh BVH)."""
    b = SceneBuilder()
    v, f = meshgen.icosphere(subdivisions=2, radius=2.0,
                             center=mesh_center)
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


@pytest.fixture(scope="module")
def shadowed():
    """Mesh at the scene center: real mesh hits AND mesh shadows."""
    return _build((0, 2, 8))


@pytest.fixture(scope="module")
def mesh_aside():
    """Mesh far off to the side: in the BVH but can never occlude a
    light or be hit — the frozen-mesh approximation is vacuous, so the
    soft replay must match the composed soft path EXACTLY."""
    return _build((60, 2, 60))


def _rays(cam):
    return generate_rays_blocks(cam, CFG.block_size)


def test_soft_forward_equals_hard_mega(shadowed):
    scene, cam = shadowed
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = _rays(cam)
    hard = np.asarray(trace_radiance(
        scene, o, d, CFG.with_(diff=DiffConfig()), bvh=bvh))
    soft = np.asarray(rp.trace_radiance_replay_soft(
        scene, o, d, CFG, bvh))
    assert np.isfinite(soft).all()
    np.testing.assert_allclose(soft, hard, rtol=2e-4, atol=2e-4)
    assert hard.std() > 1.0


def test_soft_grads_match_composed_no_mesh_shadow(mesh_aside):
    scene, cam = mesh_aside
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = _rays(cam)
    names = ("sphere_centers", "sphere_radius_sq", "sphere_diffuse",
             "light_positions", "light_intensities")
    params = get_params(scene, names)
    target = jax.lax.stop_gradient(trace_radiance(
        scene, o, d, CFG.with_(kernel="xla"), bvh=bvh)) * 0.9

    def composed_loss(p):
        s = set_params(scene, p)
        rad = trace_radiance(s, o, d, CFG.with_(kernel="xla"),
                             bvh=bvh)
        return jnp.mean((rad - target) ** 2)

    loss_c, g_c = jax.value_and_grad(composed_loss)(params)
    loss_r, g_r = rp.soft_replay_value_and_grad(
        scene, params, o, d, target, CFG, bvh)
    np.testing.assert_allclose(float(loss_r), float(loss_c),
                               rtol=1e-4, atol=1e-6)
    for k in names:
        a, b = np.asarray(g_r[k]), np.asarray(g_c[k])
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4 * scale,
                                   err_msg=f"soft grad mismatch for {k}")
        assert np.abs(b).max() > 0, k


def test_soft_grads_finite_and_descend(shadowed):
    """On the mesh-shadowed scene the frozen-mesh terms differ from
    composed by construction; the path must still be finite, carry
    silhouette signal, and reduce the loss over a few Adam-free SGD
    steps."""
    scene, cam = shadowed
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = _rays(cam)
    names = ("sphere_centers", "sphere_diffuse")
    true_p = get_params(scene, names)
    # perturbed start; target rendered at the TRUE params
    target = jax.lax.stop_gradient(rp.trace_radiance_replay_soft(
        scene, o, d, CFG, bvh))
    params = {
        "sphere_centers": true_p["sphere_centers"]
        + jnp.asarray([[0.3, -0.2, 0.3], [-0.2, 0.1, 0.2]], jnp.float32),
        "sphere_diffuse": jnp.clip(
            true_p["sphere_diffuse"] + 0.15, 0.0, 1.0),
    }
    import optax
    tx = optax.adam(0.03)
    opt_state = tx.init(params)
    losses = []
    for _ in range(25):
        loss, g = rp.soft_replay_value_and_grad(
            scene, params, o, d, target, CFG,
            bvh)
        for k in g:
            assert np.isfinite(np.asarray(g[k])).all(), k
        losses.append(float(loss))
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    assert losses[-1] < losses[0] * 0.5, losses


def test_soft_replay_chunked_matches_unchunked(shadowed):
    """chunk= bounds the replay working set (the 1080p OOM fix); the
    chunked scan-of-vjp loss/grads must equal the unchunked ones."""
    scene, cam = shadowed
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = _rays(cam)
    names = ("sphere_centers", "sphere_diffuse")
    params = get_params(scene, names)
    target = jax.lax.stop_gradient(rp.trace_radiance_replay_soft(
        scene, o, d, CFG, bvh))
    # chunked FORWARD matches too
    f_chunk = np.asarray(rp.trace_radiance_replay_soft(
        scene, o, d, CFG, bvh, chunk=128))
    np.testing.assert_allclose(f_chunk, np.asarray(target),
                               rtol=1e-6, atol=1e-6)
    l0, g0 = rp.soft_replay_value_and_grad(
        scene, params, o, d, target * 0.9, CFG,
        bvh)
    l1, g1 = rp.soft_replay_value_and_grad(
        scene, params, o, d, target * 0.9, CFG,
        bvh, chunk=128)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    for kk in names:
        np.testing.assert_allclose(np.asarray(g1[kk]),
                                   np.asarray(g0[kk]),
                                   rtol=1e-4, atol=1e-7, err_msg=kk)


def test_soft_forward_with_light_cull_matches_mega(shadowed):
    """light_cull under the SOFT record path: the culled min-mode
    records plus the replay's own cull gate must reproduce the culled
    hard forward image exactly (straight-through forward)."""
    scene, cam = shadowed
    cfg = CFG.with_(light_cull=2.0)
    bvh = bvhmod.prepare_bvh(scene, cfg)
    o, d = _rays(cam)
    hard = np.asarray(trace_radiance(
        scene, o, d, cfg.with_(diff=DiffConfig()), bvh=bvh))
    soft = np.asarray(rp.trace_radiance_replay_soft(
        scene, o, d, cfg, bvh))
    np.testing.assert_allclose(soft, hard, rtol=2e-4, atol=2e-4)
