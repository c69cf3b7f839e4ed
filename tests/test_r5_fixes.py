"""Correctness fixes:

* specular ``nh > 0`` gate consistency across the shading paths
  (0**0 == 1 leaked specular for phong==0 materials);
* tree_cap truncation surfaced as a plain array output;
* soft-replay mesh-shadow bias diagnostics with a quantified
  gradient-bias measurement on a mesh-shadowed scene;
* the fit live-prefix guard: a fit whose optimizer deepens a mirror
  chain past the static replay prefix must re-jit with a bigger prefix
  instead of silently truncating.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from unity_raytracer_tpu.fit import (FitConfig, fit, get_params,
                                     set_params)
from unity_raytracer_tpu.models import meshgen
from unity_raytracer_tpu.models.camera import Camera, generate_rays_blocks
from unity_raytracer_tpu.models.presets import cornell_box
from unity_raytracer_tpu.models.scene import SceneBuilder, make_material
from unity_raytracer_tpu.ops import bvh as bvhmod
from unity_raytracer_tpu.ops import replay as rp
from unity_raytracer_tpu.ops import shade as sh
from unity_raytracer_tpu.ops.render import (trace_radiance,
                                            trace_radiance_tree_stats)
from unity_raytracer_tpu.utils.config import DiffConfig, RenderConfig

SOFT = DiffConfig(soft_shadow_temp=1.0, soft_hit_temp=0.1,
                  straight_through=True)
CFG = RenderConfig(max_bounces=2, background=(0.04, 0.05, 0.07),
                   use_bvh=True, mode="scan", block_size=8,
                   diff=SOFT)


# ---------------------------------------------------------------------------
# specular nh > 0 gate
# ---------------------------------------------------------------------------

def _one_light_scene(light_pos, intensity=400.0):
    b = SceneBuilder()
    b.add_sphere((0, -50, 0), 1.0, make_material(diffuse=(1, 0, 0)))
    b.add_point_light(light_pos, intensity)
    b.set_ambient((0, 0, 0))
    return b.build()


def test_spec_gate_phong0_no_leak():
    """phong == 0 with specular > 0: a lane whose halfway vector is
    back-facing (nh == 0) must emit ZERO specular — 0**0 would give 1.
    The light is in front (ln > 0) so the lane is otherwise lit."""
    from unity_raytracer_tpu.models.scene import Materials

    # normal +y; viewer direction v well below the horizon makes
    # (l + v).n < 0 while l.n > 0
    p = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    v = jnp.asarray([[0.866, -0.5, 0.0]], jnp.float32)
    ldir = np.array([0.995, 0.0995, 0.0], np.float64)
    ldir /= np.linalg.norm(ldir)
    scene = _one_light_scene(tuple(10.0 * ldir))
    ln = float(np.dot(ldir, [0, 1, 0]))
    nh = np.dot(ldir + np.asarray(v[0]), [0, 1, 0])
    assert ln > 0 and nh < 0  # the crafted geometry

    mats = Materials(
        diffuse=jnp.zeros((1, 3)), ambient=jnp.zeros((1, 3)),
        mirror=jnp.zeros((1, 3)), specular=jnp.ones((1, 3)),
        phong=jnp.zeros((1,)), is_mirror=jnp.zeros((1,), bool),
        transparency=jnp.zeros((1, 3)), ior=jnp.ones((1,)),
        is_dielectric=jnp.zeros((1,), bool))
    out = np.asarray(sh.direct_lighting(scene, p, n, v, mats))
    np.testing.assert_allclose(out, 0.0, atol=1e-6)

    # soft-replay path: same lane through _soft_lighting with an
    # unoccluded mesh record
    st_rec = jnp.full((1, 1), 3.0e38, jnp.float32)
    cfg = CFG
    out_soft = np.asarray(rp._soft_lighting(scene, p, n, v, mats,
                                            st_rec, cfg))
    np.testing.assert_allclose(out_soft, 0.0, atol=1e-6)

    # hard-replay path: frozen occbits say unoccluded
    occ = jnp.zeros((1,), jnp.float32)
    mask = jnp.ones((1,), bool)
    out_replay = np.asarray(rp.replay_lighting(scene, p, n, v, mats,
                                               occ, mask))
    np.testing.assert_allclose(out_replay, 0.0, atol=1e-6)


def test_spec_gate_gradients_finite():
    """The double-where must keep d(nh**phong)/d(nh) = inf (phong < 1 at
    nh == 0) off masked lanes: gradients w.r.t. light position stay
    finite on the gated lane."""
    p = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    v = jnp.asarray([[0.866, -0.5, 0.0]], jnp.float32)
    from unity_raytracer_tpu.models.scene import Materials
    mats = Materials(
        diffuse=jnp.zeros((1, 3)), ambient=jnp.zeros((1, 3)),
        mirror=jnp.zeros((1, 3)), specular=jnp.ones((1, 3)),
        phong=jnp.full((1,), 0.5), is_mirror=jnp.zeros((1,), bool),
        transparency=jnp.zeros((1, 3)), ior=jnp.ones((1,)),
        is_dielectric=jnp.zeros((1,), bool))

    def f(lp):
        s = _one_light_scene((0, 0, 0))
        import dataclasses
        s = dataclasses.replace(
            s, lights=dataclasses.replace(s.lights, positions=lp))
        return jnp.sum(sh.direct_lighting(s, p, n, v, mats))

    lp0 = jnp.asarray([[9.95, 0.995, 0.0]], jnp.float32)
    g = np.asarray(jax.grad(f)(lp0))
    assert np.isfinite(g).all()


# ---------------------------------------------------------------------------
# tree_cap truncation counter
# ---------------------------------------------------------------------------

def test_tree_cap_truncation_counter_fires():
    """A full-screen dielectric (every primary lane forks into live
    reflect + refract children = 2x live lanes) at cap=1 MUST report
    dropped lanes through the plain-array stats output."""
    b = SceneBuilder()
    b.add_sphere((0, 0, 30), 20.0, make_material(
        specular=(0.6, 0.6, 0.6), phong=100.0,
        transparency=(0.95, 0.95, 0.95), ior=1.5, is_dielectric=True))
    g = 200.0
    gmat = make_material(diffuse=(0.5, 0.5, 0.55),
                         ambient=(0.5, 0.5, 0.55), phong=1.0)
    b.add_triangle((-g, -30, -g), (g, -30, -g), (g, -30, g), gmat)
    b.add_point_light((10, 40, 0), 5000.0)
    b.set_ambient((10, 10, 10))
    scene = b.build()
    cam = Camera.make(position=(0, 0, 0), forward=(0, 0, 1),
                      dist=1.0, half_h=0.2, half_v=0.2,
                      width=16, height=16)
    cfg = RenderConfig(max_bounces=3, mode="tree", tree_cap=1,
                       block_size=8)
    o, d = generate_rays_blocks(cam, cfg.block_size)
    rad, n_tr = trace_radiance_tree_stats(scene, o, d, cfg)
    assert np.isfinite(np.asarray(rad)).all()
    assert int(np.asarray(n_tr)) > 0


def test_tree_cap_truncation_counter_zero_on_cornell():
    """At the shipped cap the cornell compaction is lossless — the
    counter must be exactly zero."""
    scene, cam, cfg = cornell_box(width=24, height=24)
    o, d = generate_rays_blocks(cam, cfg.block_size)
    rad, n_tr = trace_radiance_tree_stats(scene, o, d,
                                          cfg.with_(mode="tree"))
    assert np.isfinite(np.asarray(rad)).all()
    assert int(np.asarray(n_tr)) == 0


# ---------------------------------------------------------------------------
# soft-replay mesh-shadow bias diagnostics
# ---------------------------------------------------------------------------

def _bias_scene(mesh_center):
    """A sphere whose silhouette/shadow interacts with an icosphere mesh
    placed at ``mesh_center`` (between sphere and light => mesh-occluded
    shadow rays, the biased regime)."""
    b = SceneBuilder()
    v, f = meshgen.icosphere(subdivisions=2, radius=1.6,
                             center=mesh_center)
    b.add_mesh(v, f, make_material(diffuse=(0.7, 0.5, 0.2),
                                   ambient=(0.7, 0.5, 0.2), phong=10.0))
    b.add_sphere((0.0, 1.2, 8.0), 1.2, make_material(
        diffuse=(0.2, 0.6, 0.3), ambient=(0.2, 0.6, 0.3), phong=10.0))
    g = 30.0
    gmat = make_material(diffuse=(0.5, 0.5, 0.55),
                         ambient=(0.5, 0.5, 0.55), phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((6, 9, 2), 900.0)
    b.set_ambient((8, 8, 8))
    scene = b.build()
    cam = Camera.make(position=(0, 2.5, -2), forward=(0, -0.1, 1),
                      dist=1.0, half_h=0.7, half_v=0.7,
                      width=24, height=24)
    return scene, cam


def test_bias_counter_fires_when_mesh_shadows():
    """Mesh between the sphere region and the light -> frozen
    mesh-occluder shadow terms exist and the counter is > 0."""
    scene, cam = _bias_scene((3.2, 5.0, 5.0))  # on the light path
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = generate_rays_blocks(cam, CFG.block_size)
    diag = rp.soft_replay_bias_counts(scene, o, d,
                                      CFG, bvh)
    assert int(diag["mesh_occ_frozen"]) > 0


def test_bias_counter_zero_when_mesh_aside():
    """Mesh far off to the side -> no mesh-occluded shadow rays, no
    proxy risk; both counters exactly zero."""
    scene, cam = _bias_scene((60.0, 2.0, 60.0))
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = generate_rays_blocks(cam, CFG.block_size)
    diag = rp.soft_replay_bias_counts(scene, o, d,
                                      CFG, bvh)
    assert int(diag["mesh_occ_frozen"]) == 0
    assert int(diag["proxy_mesh_risk"]) == 0


def test_bias_magnitude_quantified():
    """Quantify the gradient bias of the frozen mesh-occluder terms on
    the mesh-shadowed scene: soft-replay vs composed gradients for
    sphere_centers. The bias must be real (counter > 0) yet bounded —
    the replay still points downhill (positive cosine similarity)."""
    scene, cam = _bias_scene((3.2, 5.0, 5.0))
    bvh = bvhmod.prepare_bvh(scene, CFG)
    o, d = generate_rays_blocks(cam, CFG.block_size)
    names = ("sphere_centers",)
    params = get_params(scene, names)
    target = jax.lax.stop_gradient(trace_radiance(
        scene, o, d, CFG.with_(kernel="xla"), bvh=bvh)) * 0.9

    def composed_loss(p):
        s = set_params(scene, p)
        rad = trace_radiance(s, o, d, CFG.with_(kernel="xla"),
                             bvh=bvh)
        return jnp.mean((rad - target) ** 2)

    _, g_c = jax.value_and_grad(composed_loss)(params)
    _, g_r = rp.soft_replay_value_and_grad(
        scene, params, o, d, target, CFG, bvh)
    a = np.asarray(g_r["sphere_centers"]).ravel()
    b = np.asarray(g_c["sphere_centers"]).ravel()
    rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
    cos = float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b),
                            1e-12))
    # recorded bias magnitude: nonzero (the bias is real), direction
    # still descends. Bound is loose on purpose — it documents the
    # measured scale (~<30% relative on this crafted scene), not a
    # parity claim.
    assert np.isfinite(rel) and rel < 0.5, (rel, cos)
    assert cos > 0.7, (rel, cos)


# ---------------------------------------------------------------------------
# fit live-prefix guard
# ---------------------------------------------------------------------------

def test_fit_prefix_guard_bumps_and_rejits():
    """A mirror sphere steered INTO the reflection path mid-fit deepens
    the live bounce chain; the guard must detect it and grow the static
    replay prefix instead of silently truncating radiance."""
    b = SceneBuilder()
    v, f = meshgen.icosphere(subdivisions=2, radius=1.0,
                             center=(60.0, 2.0, 60.0))  # inert mesh
    b.add_mesh(v, f, make_material(diffuse=(0.7, 0.5, 0.2),
                                   ambient=(0.7, 0.5, 0.2), phong=10.0))
    # sphere A: mirror facing the camera — primary rays bounce back -z
    b.add_sphere((0.0, 0.0, 10.0), 3.0, make_material(
        diffuse=(0.1, 0.1, 0.1), ambient=(0.1, 0.1, 0.1),
        mirror=(0.9, 0.9, 0.9), is_mirror=True, phong=50.0,
        specular=(0.5, 0.5, 0.5)))
    # sphere B: mirror, starts far right of the reflected path
    b.add_sphere((30.0, 0.0, -10.0), 3.0, make_material(
        diffuse=(0.1, 0.1, 0.1), ambient=(0.1, 0.1, 0.1),
        mirror=(0.9, 0.9, 0.9), is_mirror=True, phong=50.0,
        specular=(0.5, 0.5, 0.5)))
    b.add_point_light((5, 8, 0), 800.0)
    b.set_ambient((8, 8, 8))
    scene = b.build()
    cam = Camera.make(position=(0, 0, 0), forward=(0, 0, 1),
                      dist=1.0, half_h=0.35, half_v=0.35,
                      width=16, height=16)
    cfg = CFG.with_(max_bounces=3)
    bvh = bvhmod.prepare_bvh(scene, cfg)
    target = trace_radiance(
        scene, *generate_rays_blocks(cam, cfg.block_size),
        cfg.with_(kernel="xla", diff=DiffConfig()), bvh=bvh)
    from unity_raytracer_tpu.utils.swizzle import unswizzle_image
    target_img = unswizzle_image(target, cam.width, cam.height,
                                 cfg.block_size) / 255.0

    # deterministic "optimizer": constant gradient pushes sphere B in
    # -x by ~lr per Adam step, into the reflected path after ~7 steps
    def steer(grads, params):
        del grads, params  # constant descent direction (B moves -x)
        return {"sphere_centers": jnp.asarray(
            [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], jnp.float32)}

    fcfg = FitConfig(param_names=("sphere_centers",), learning_rate=4.0,
                     steps=9, soft_shadow_temp=1.0, soft_hit_temp=0.1,
                     log_every=0, use_replay=True, prefix_guard_every=1)
    res = fit(scene, cam, cfg, target_img, fcfg, bvh=bvh,
              grad_transform=steer)
    # B ended up inside the reflected path
    assert float(res.params["sphere_centers"][1, 0]) < 5.0
    # initial topology: seg0 hits only -> prefix 2; once B enters the
    # reflected path the chain deepens and the guard must have bumped
    assert res.live_prefix is not None and res.live_prefix >= 3, \
        res.live_prefix
