"""Mesh-vertex gradients (fit.PARAM_PATHS 'mesh_verts') — the
one differentiable class that didn't exist before.

Mechanism under test (ops/bvh.bind_verts): the BVH's epilogue triangle
table is re-derived differentiably from the CURRENT scene mesh verts
(traversal decisions stay frozen on the baked arrays), with the tree
built conservative via cfg.bvh_pad so small deformations keep the
forward exact. FD-vs-autodiff on the composed XLA path, plus a small
deformation-recovery fit.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from unity_raytracer_tpu.fit import FitConfig, fit, get_params, set_params
from unity_raytracer_tpu.models import meshgen
from unity_raytracer_tpu.models.camera import Camera, generate_rays_blocks
from unity_raytracer_tpu.models.scene import SceneBuilder, make_material
from unity_raytracer_tpu.ops import bvh as bvhmod
from unity_raytracer_tpu.ops.render import render, trace_radiance
from unity_raytracer_tpu.utils.config import DiffConfig, RenderConfig

CFG = RenderConfig(max_bounces=1, background=(0.04, 0.05, 0.07),
                   use_bvh=True, mode="scan", kernel="xla",
                   block_size=8, bvh_pad=0.2)


def _scene():
    b = SceneBuilder()
    v, f = meshgen.icosphere(subdivisions=1, radius=2.0, center=(0, 2, 8))
    b.add_mesh(v, f, make_material(diffuse=(0.7, 0.5, 0.2),
                                   ambient=(0.7, 0.5, 0.2),
                                   specular=(0.4, 0.4, 0.4), phong=30.0))
    g = 30.0
    gmat = make_material(diffuse=(0.5, 0.5, 0.55),
                         ambient=(0.5, 0.5, 0.55), phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((5, 9, 2), 900.0)
    b.set_ambient((8, 8, 8))
    scene = b.build()
    cam = Camera.make(position=(0, 2.5, 2), forward=(0, -0.05, 1),
                      dist=1.0, half_h=0.5, half_v=0.5,
                      width=24, height=24)
    return scene, cam


def test_mesh_verts_fd_vs_autodiff():
    scene, cam = _scene()
    bvh = bvhmod.prepare_bvh(scene, CFG)
    assert bvh.flip is not None
    o, d = generate_rays_blocks(cam, CFG.block_size)

    def f(verts):
        s = dataclasses.replace(
            scene, meshes=dataclasses.replace(scene.meshes, verts=verts))
        b = bvhmod.bind_verts(bvh, s)
        rad = trace_radiance(s, o, d, CFG, bvh=b)
        return jnp.mean(rad)

    v0 = scene.meshes.verts
    g = np.asarray(jax.grad(f)(v0))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0, "no mesh-vertex gradient signal"

    fj = jax.jit(f)
    flat = np.asarray(v0).reshape(-1)
    gflat = g.reshape(-1)
    # probe the highest-|grad| components (hit triangles) + some randoms
    order = np.argsort(-np.abs(gflat))
    rng = np.random.default_rng(0)
    picks = list(order[:8]) + list(rng.choice(flat.shape[0], 4))
    eps = 2e-3  # well inside bvh_pad=0.2: tree stays conservative
    n_checked = 0
    for i in picks:
        delta = np.zeros_like(flat)
        delta[i] = eps
        xp = jnp.asarray((flat + delta).reshape(np.asarray(v0).shape))
        xm = jnp.asarray((flat - delta).reshape(np.asarray(v0).shape))
        fd = (float(fj(xp)) - float(fj(xm))) / (2 * eps)
        ad = float(gflat[i])
        if abs(fd) < 1e-6 and abs(ad) < 1e-6:
            continue
        n_checked += 1
        assert abs(fd - ad) <= 0.1 * max(abs(fd), abs(ad)) + 1e-4, \
            (i, fd, ad)
    assert n_checked >= 5


def test_mesh_verts_deformation_fit_recovers():
    """Dent a few camera-facing triangles (large, visible deformation),
    fit the verts back from the clean target image. A full-table random
    perturbation is ill-posed from one view (in-plane vertex moves are
    image-invisible), so the recovery check targets the dented rows."""
    import dataclasses as _dc

    scene, cam = _scene()
    cfg = CFG.with_(bvh_pad=0.5,
                    diff=DiffConfig(soft_shadow_temp=1.0,
                                    soft_hit_temp=0.05,
                                    straight_through=True))
    bvh = bvhmod.prepare_bvh(scene, cfg)
    target = render(scene, cam, cfg.with_(diff=DiffConfig()), bvh=bvh)

    true_v = np.asarray(scene.meshes.verts)
    valid = np.asarray(scene.meshes.valid)
    # camera-facing triangle rows: centroid in front, normal toward cam
    cent = true_v.mean(axis=1)
    to_cam = np.asarray([0, 2.5, 2]) - cent
    to_cam /= np.maximum(np.linalg.norm(to_cam, axis=1, keepdims=True),
                         1e-9)
    nrm = np.asarray(scene.meshes.normals)
    facing = np.argsort(-(nrm * to_cam).sum(axis=1) * valid)[:6]
    noise = np.zeros_like(true_v)
    # TILT each selected triangle: move only v0 along the face normal —
    # the face normal rotates, so diffuse/specular shading changes
    # smoothly (a whole-face translation along its own normal is nearly
    # image-invariant away from the hard silhouette)
    noise[facing, 0, :] = 0.35 * nrm[facing]
    init = {"mesh_verts": jnp.asarray(true_v + noise)}

    fcfg = FitConfig(param_names=("mesh_verts",), learning_rate=0.01,
                     steps=60, soft_shadow_temp=1.0, soft_hit_temp=0.05,
                     log_every=0)
    res = fit(scene, cam, cfg, target, fcfg, init_params=init, bvh=bvh)
    assert res.losses[-1] < res.losses[0] * 0.5, (
        res.losses[0], res.losses[-1])
    # recovery is measured on the OBSERVABLE: the dented faces' normals
    # (vertex positions are ambiguous — any vertex combination restoring
    # the face plane reproduces the image)

    def face_normals(v):
        n = -np.cross(v[:, 2] - v[:, 0], v[:, 1] - v[:, 0])
        return n / np.maximum(
            np.linalg.norm(n, axis=1, keepdims=True), 1e-12)

    n_true = face_normals(true_v[facing])
    n_init = face_normals(np.asarray(init["mesh_verts"])[facing])
    n_fit = face_normals(np.asarray(res.params["mesh_verts"])[facing])
    ang0 = (1.0 - (n_init * n_true).sum(axis=1)).mean()
    ang1 = (1.0 - (n_fit * n_true).sum(axis=1)).mean()
    assert ang1 < ang0 * 0.5, (ang0, ang1)
