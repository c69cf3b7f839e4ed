"""Named scene presets — the 5 baseline configs + the reference demo scene.

Each preset returns ``(scene, camera, render_config)``. The reference's
"config system" is its serialized demo scene
(Demo-RayTracing/RayTracing.unity) and prefab defaults (Prefabs/*.prefab);
`reference_demo` reconstructs that scene from the exact serialized values so
the framework renders the same world the reference did.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from unity_raytracer_tpu.models import meshgen
from unity_raytracer_tpu.models.camera import Camera
from unity_raytracer_tpu.models.scene import Scene, SceneBuilder, make_material
from unity_raytracer_tpu.utils.config import RenderConfig

Preset = Tuple[Scene, Camera, RenderConfig]


def reference_demo(width: int = 50, height: int = 50) -> Preset:
    """The reference's Demo-RayTracing scene, from its serialized values.

    Sources: RayTracing.unity prefab overrides (positions/rotations,
    material overrides) and Prefabs/*.prefab defaults — sphere r=10 diffuse
    (1,0,0) ambient (1,1,1) mirror (1,1,1) phong 20 with specular zeroed and
    IsMirror disabled by scene override; triangles with offsets
    (0,10,0)/(-10,-10,0)/(10,-10,0); rotated cube scaled (28.664,10,10);
    point light intensity 100000 at (5.79,0,0); ambient (15,15,15).
    Camera at origin, identity rotation (fwd +z); image plane 10 away,
    half-extents 20x10; MaxReflectionBounces 5, black background.
    """
    b = SceneBuilder()
    tri_mat = dict(ambient=(1, 1, 1), phong=0.0)
    offs = [np.array([0, 10, 0], np.float32),
            np.array([-10, -10, 0], np.float32),
            np.array([10, -10, 0], np.float32)]
    for pos, diffuse in [((14.16, 0, 21.45), (1, 0, 1)),
                         ((17.1, 0, 15), (0, 1, 0))]:
        p = np.asarray(pos, np.float32)
        b.add_triangle(p + offs[0], p + offs[1], p + offs[2],
                       make_material(diffuse=diffuse, **tri_mat))
    b.add_sphere((0, 0, 29.6), 10.0, make_material(
        diffuse=(1, 0, 0), ambient=(1, 1, 1), mirror=(1, 1, 1),
        specular=(0, 0, 0), phong=20.0, is_mirror=False))
    cube_q = np.array([-0.37513673, 0.13105033, 0.3026398, 0.8663183])
    cv, cf = meshgen.box_mesh(center=(-24.7, 0.0000015497656, 27.6),
                              size=(28.664, 10, 10), rotation=cube_q)
    b.add_mesh(cv, cf, make_material(diffuse=(0, 1, 1), phong=0.0))
    b.add_point_light((5.79, 0, 0), 100000.0)
    b.set_ambient((15, 15, 15))
    scene = b.build()
    cam = Camera.make(position=(0, 0, 0), forward=(0, 0, 1), up=(0, 1, 0),
                      dist=10.0, half_h=20.0, half_v=10.0,
                      width=width, height=height)
    cfg = RenderConfig(max_bounces=5, background=(0, 0, 0))
    return scene, cam, cfg


def three_spheres(width: int = 256, height: int = 256) -> Preset:
    """Baseline config 1: 3 spheres + ground plane, depth-1 Blinn-Phong +
    hard shadows."""
    b = SceneBuilder()
    b.add_sphere((-6, 2, 24), 2.0, make_material(
        diffuse=(0.9, 0.2, 0.2), ambient=(0.9, 0.2, 0.2),
        specular=(0.8, 0.8, 0.8), phong=50.0))
    b.add_sphere((0, 3, 30), 3.0, make_material(
        diffuse=(0.2, 0.9, 0.3), ambient=(0.2, 0.9, 0.3),
        specular=(0.9, 0.9, 0.9), phong=120.0,
        mirror=(0.6, 0.6, 0.6), is_mirror=True))
    b.add_sphere((6, 1.5, 22), 1.5, make_material(
        diffuse=(0.25, 0.35, 0.95), ambient=(0.25, 0.35, 0.95),
        specular=(0.7, 0.7, 0.7), phong=30.0))
    # ground plane = 2 large triangles at y = 0
    g = 60.0
    gmat = make_material(diffuse=(0.7, 0.7, 0.7), ambient=(0.7, 0.7, 0.7),
                         phong=1.0)
    # wound so the derived normal (cross(v2-v0, v1-v0)) points up (+y)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((10, 20, 10), 40000.0)
    b.add_point_light((-15, 12, 35), 18000.0)
    b.set_ambient((20, 20, 20))
    scene = b.build()
    cam = Camera.make(position=(0, 4, 0), forward=(0, -0.08, 1), up=(0, 1, 0),
                      dist=1.0, half_h=0.9, half_v=0.9 * height / width,
                      width=width, height=height)
    cfg = RenderConfig(max_bounces=1, background=(0.05, 0.06, 0.08))
    return scene, cam, cfg


def cornell_box(width: int = 512, height: int = 512) -> Preset:
    """Baseline config 2: Cornell box, 512x512, depth-4 reflection +
    refraction, brute-force intersection."""
    b = SceneBuilder()
    white = make_material(diffuse=(0.73, 0.73, 0.73),
                          ambient=(0.73, 0.73, 0.73), phong=1.0)
    red = make_material(diffuse=(0.65, 0.05, 0.05),
                        ambient=(0.65, 0.05, 0.05), phong=1.0)
    green = make_material(diffuse=(0.12, 0.45, 0.15),
                          ambient=(0.12, 0.45, 0.15), phong=1.0)
    # box: x in [-s,s], y in [0,2s], z in [lo,hi]; camera looks down +z.
    # Windings chosen so cross(v2-v0, v1-v0) is the inward normal (each
    # verified numerically in tests/test_presets.py).
    s = 10.0
    lo, hi = 0.0, 2 * s
    # floor (normal +y)
    b.add_triangle((-s, 0, lo), (s, 0, lo), (s, 0, hi), white)
    b.add_triangle((-s, 0, lo), (s, 0, hi), (-s, 0, hi), white)
    # ceiling (normal -y)
    b.add_triangle((-s, 2 * s, lo), (s, 2 * s, hi), (s, 2 * s, lo), white)
    b.add_triangle((-s, 2 * s, lo), (-s, 2 * s, hi), (s, 2 * s, hi), white)
    # back wall z=hi (normal -z)
    b.add_triangle((-s, 0, hi), (s, 0, hi), (s, 2 * s, hi), white)
    b.add_triangle((-s, 0, hi), (s, 2 * s, hi), (-s, 2 * s, hi), white)
    # left wall x=-s (normal +x)
    b.add_triangle((-s, 0, lo), (-s, 0, hi), (-s, 2 * s, hi), red)
    b.add_triangle((-s, 0, lo), (-s, 2 * s, hi), (-s, 2 * s, lo), red)
    # right wall x=+s (normal -x)
    b.add_triangle((s, 0, lo), (s, 2 * s, lo), (s, 2 * s, hi), green)
    b.add_triangle((s, 0, lo), (s, 2 * s, hi), (s, 0, hi), green)

    b.add_sphere((-4.0, 4.0, 13.0), 4.0, make_material(
        diffuse=(0.05, 0.05, 0.05), ambient=(0.05, 0.05, 0.05),
        specular=(1, 1, 1), phong=200.0, mirror=(0.9, 0.9, 0.9),
        is_mirror=True))
    b.add_sphere((4.5, 3.0, 9.0), 3.0, make_material(
        specular=(0.6, 0.6, 0.6), phong=300.0,
        transparency=(0.95, 0.95, 0.95), ior=1.5, is_dielectric=True))
    b.add_point_light((0, 2 * s - 1.0, 10.0), 2500.0)
    b.add_point_light((0, 2 * s - 1.5, 4.0), 1200.0)
    b.set_ambient((12, 12, 12))
    scene = b.build()
    cam = Camera.make(position=(0, s, -13.0), forward=(0, 0, 1), up=(0, 1, 0),
                      dist=1.0, half_h=0.42, half_v=0.42 * height / width,
                      width=width, height=height)
    # tree_cap=1: this scene's live fork lanes never exceed 1x the
    # primary count per level, so even the tightest cap is LOSSLESS
    # (truncation counter exactly 0 at full 512^2, identical image).
    cfg = RenderConfig(max_bounces=4, background=(0, 0, 0), tree_cap=1)
    return scene, cam, cfg


def mesh_scene(n_tris: int = 10240, width: int = 1024, height: int = 1024,
               use_bvh: bool = True) -> Preset:
    """Baseline config 3/5 geometry: icosphere mesh budgeted to ~n_tris
    triangles + mirror sphere + ground, multi-light shadows.

    n_tris ~ 10k: subdivisions=4 gives 5120; use two meshes. 100k: 81920 +
    20480 = 102400.
    """
    b = SceneBuilder()
    if n_tris >= 100_000:
        meshes = [(6, 6.0, (0, 6, 30)), (5, 3.0, (9, 3, 22))]
    elif n_tris >= 10_000:
        meshes = [(4, 6.0, (0, 6, 30)), (4, 3.0, (9, 3, 22))]
    else:
        meshes = [(3, 6.0, (0, 6, 30))]
    mats = [make_material(diffuse=(0.75, 0.55, 0.25),
                          ambient=(0.75, 0.55, 0.25),
                          specular=(0.6, 0.6, 0.6), phong=40.0),
            make_material(diffuse=(0.3, 0.5, 0.8), ambient=(0.3, 0.5, 0.8),
                          specular=(0.8, 0.8, 0.8), phong=90.0)]
    for (sub, rad, center), mat in zip(meshes, mats):
        v, f = meshgen.icosphere(subdivisions=sub, radius=rad, center=center)
        b.add_mesh(v, f, mat)
    b.add_sphere((-8, 4, 26), 4.0, make_material(
        diffuse=(0.1, 0.1, 0.1), ambient=(0.1, 0.1, 0.1),
        specular=(1, 1, 1), phong=200.0, mirror=(0.85, 0.85, 0.85),
        is_mirror=True))
    g = 80.0
    gmat = make_material(diffuse=(0.6, 0.6, 0.62), ambient=(0.6, 0.6, 0.62),
                         phong=1.0)
    b.add_triangle((-g, 0, -g), (g, 0, -g), (g, 0, g), gmat)
    b.add_triangle((-g, 0, -g), (g, 0, g), (-g, 0, g), gmat)
    b.add_point_light((15, 25, 5), 12000.0)
    b.add_point_light((-20, 18, 35), 6000.0)
    b.add_point_light((0, 30, 50), 8000.0)
    b.set_ambient((6, 6, 6))
    scene = b.build()
    cam = Camera.make(position=(0, 7, -2), forward=(0, -0.1, 1), up=(0, 1, 0),
                      dist=1.0, half_h=0.7, half_v=0.7 * height / width,
                      width=width, height=height)
    # bvh_bins=64: finer SAH candidate splits give a tighter tree (fewer
    # node visits per walk) for a slower build
    cfg = RenderConfig(max_bounces=4, background=(0.04, 0.05, 0.07),
                       use_bvh=use_bvh, bvh_bins=64)
    return scene, cam, cfg


def mesh10k(width: int = 1024, height: int = 1024) -> Preset:
    return mesh_scene(10240, width, height)


def mesh100k(width: int = 1920, height: int = 1080) -> Preset:
    """Baseline config 5 scene (flagship bench): ~100k tris at 1080p."""
    return mesh_scene(102400, width, height)


PRESETS = {
    "reference_demo": reference_demo,
    "three_spheres": three_spheres,
    "cornell_box": cornell_box,
    "mesh10k": mesh10k,
    "mesh100k": mesh100k,
}


def get_preset(name: str, **kw) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name](**kw)
