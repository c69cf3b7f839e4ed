"""Inverse rendering beyond the toy corner: recover
a sphere center + diffuse in a BVH MESH scene at depth >= 1, through the
chunked-gradient step (rcfg.ray_chunk) with soft silhouette temps."""

import numpy as np


import jax.numpy as jnp

from unity_raytracer_tpu.fit import FitConfig, fit, get_params
from unity_raytracer_tpu.models import meshgen
from unity_raytracer_tpu.models.camera import Camera
from unity_raytracer_tpu.models.scene import SceneBuilder, make_material
from unity_raytracer_tpu.ops import bvh as bvhmod
from unity_raytracer_tpu.ops.render import render, resolve_mode
from unity_raytracer_tpu.utils.config import RenderConfig


def test_fit_mesh_bvh_depth1_chunked():
    b = SceneBuilder()
    v, f = meshgen.icosphere(subdivisions=2, radius=2.0, center=(0, 2, 10))
    b.add_mesh(v, f, make_material(diffuse=(0.7, 0.5, 0.2),
                                   ambient=(0.7, 0.5, 0.2), phong=20.0))
    b.add_sphere((-2.5, 1.2, 6.0), 1.2, make_material(
        diffuse=(0.2, 0.6, 0.3), ambient=(0.2, 0.6, 0.3), phong=10.0))
    g = 40.0
    gmat = make_material(diffuse=(0.5, 0.5, 0.55),
                         ambient=(0.5, 0.5, 0.55), phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((5, 10, 0), 3000.0)
    b.set_ambient((40, 40, 40))
    scene = b.build()
    cam = Camera.make(position=(0, 3, -2), forward=(0, -0.1, 1),
                      dist=1.0, half_h=0.7, half_v=0.7,
                      width=40, height=40)

    rcfg = resolve_mode(scene, RenderConfig(
        max_bounces=1, background=(0.04, 0.05, 0.07), use_bvh=True,
        kernel="xla", mode="scan", block_size=8, ray_chunk=512,
        remat=True))
    bvh = bvhmod.prepare_bvh(scene, rcfg)
    target = render(scene, cam, rcfg, bvh=bvh)
    true_p = get_params(scene, ("sphere_centers", "sphere_diffuse"))

    init = {
        "sphere_centers": true_p["sphere_centers"]
        + jnp.asarray([[0.3, -0.25, 0.3]], jnp.float32),
        "sphere_diffuse": jnp.clip(
            true_p["sphere_diffuse"]
            + jnp.asarray([[0.15, -0.1, 0.12]], jnp.float32), 0.0, 1.0),
    }
    err0 = float(np.abs(np.asarray(init["sphere_centers"])
                        - np.asarray(true_p["sphere_centers"])).max())

    fcfg = FitConfig(param_names=("sphere_centers", "sphere_diffuse"),
                     learning_rate=0.05, steps=80,
                     soft_shadow_temp=1.0, soft_hit_temp=0.1,
                     log_every=0)
    res = fit(scene, cam, rcfg, target, fcfg, init_params=init, bvh=bvh)

    err1 = float(np.abs(np.asarray(res.params["sphere_centers"])
                        - np.asarray(true_p["sphere_centers"])).max())
    assert res.losses[-1] < 0.35 * res.losses[0], (
        res.losses[0], res.losses[-1])
    assert err1 < 0.5 * err0, (err0, err1)
