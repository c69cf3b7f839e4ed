"""Scalar NumPy oracle tracer — the executable spec of the reference semantics.

The reference (Unity C#) cannot be executed here, so this tiny, deliberately
naive per-pixel tracer transcribes its math exactly and serves as the
``allclose`` ground truth for the batched renderer. Every block cites the
reference behavior it mirrors. It is scalar, recursive and slow on purpose —
clarity over speed; use only on small images in tests.

Mirrored semantics (see SURVEY.md §2 / §7 "exact forward parity"):
* Moller-Trumbore with eps=1e-5, parallel/u/v/t rejects (Math/RMath.cs:29-73)
* sphere quadratic on pre-squared radius, smallest positive root
  (Math/RMath.cs:81-108)
* slab AABB test with tmin seeded 0 (Math/RMath.cs:12-26)
* nearest-hit with strict ``>`` update in order mesh-tris, spheres,
  loose-tris (Data/Objects/Scene.cs:43-122)
* Blinn-Phong: ambient + per-light shadowed diffuse/specular with 1/d^2
  falloff, specular cut when light is behind surface
  (RayTracingSetup.cs:304-455)
* mirror recursion with throughput MirrorReflectance and bounce cap
  (RayTracingSetup.cs:358-363)
* shadow epsilon 1e-4 (RayTracingSetup.cs:42), occlusion test
  hitDist^2 < lightDist^2 (RayTracingSetup.cs:337-345)
* radiance tracked on the reference's 0-255 "Rgb" scale; final pixel /255
  (Data/Shading/Rgb.cs:13)

Extension (not in the reference): dielectric refraction via Snell + Schlick
Fresnel with total-internal-reflection — the same semantics the JAX renderer
implements, so oracle parity covers config 2.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

EPS = 1e-5          # RMath.cs:9
SHADOW_EPS = 1e-4   # RayTracingSetup.cs:42
MISS = np.float32(np.finfo(np.float32).max)  # float.MaxValue miss distance


# --- plain-python scene mirror -------------------------------------------

@dataclass
class OMaterial:
    diffuse: np.ndarray
    ambient: np.ndarray
    mirror: np.ndarray
    specular: np.ndarray
    phong: float
    is_mirror: bool
    transparency: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    ior: float = 1.0
    is_dielectric: bool = False


@dataclass
class OSphere:
    center: np.ndarray
    radius_sq: float
    material: OMaterial


@dataclass
class OTriangle:
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    normal: np.ndarray
    material: OMaterial


@dataclass
class OMesh:
    triangles: List[OTriangle]
    aabb_min: np.ndarray
    aabb_max: np.ndarray
    material: OMaterial


@dataclass
class OPointLight:
    position: np.ndarray
    intensity: np.ndarray


@dataclass
class OScene:
    spheres: List[OSphere]
    triangles: List[OTriangle]
    meshes: List[OMesh]
    lights: List[OPointLight]
    ambient: np.ndarray
    aabb_min: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    aabb_max: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))

    def finalize(self) -> "OScene":
        """Scene AABB fold (Scene.cs:17-41)."""
        lo = np.full(3, np.inf, np.float32)
        hi = np.full(3, -np.inf, np.float32)
        for m in self.meshes:
            lo, hi = np.minimum(lo, m.aabb_min), np.maximum(hi, m.aabb_max)
        for t in self.triangles:
            for v in (t.v0, t.v1, t.v2):
                lo, hi = np.minimum(lo, v), np.maximum(hi, v)
        for s in self.spheres:
            r = np.sqrt(s.radius_sq)
            lo, hi = np.minimum(lo, s.center - r), np.maximum(hi, s.center + r)
        self.aabb_min, self.aabb_max = lo, hi
        return self


def from_scene(scene) -> OScene:
    """Convert a device Scene (models.scene.Scene) into the oracle mirror."""
    import numpy as _np

    def mat(m, i) -> OMaterial:
        return OMaterial(
            diffuse=_np.asarray(m.diffuse[i]), ambient=_np.asarray(m.ambient[i]),
            mirror=_np.asarray(m.mirror[i]), specular=_np.asarray(m.specular[i]),
            phong=float(m.phong[i]), is_mirror=bool(m.is_mirror[i]),
            transparency=_np.asarray(m.transparency[i]), ior=float(m.ior[i]),
            is_dielectric=bool(m.is_dielectric[i]))

    sp = [OSphere(_np.asarray(scene.spheres.centers[i]),
                  float(scene.spheres.radius_sq[i]), mat(scene.spheres.materials, i))
          for i in range(scene.spheres.count) if bool(scene.spheres.valid[i])]
    tr = [OTriangle(*[_np.asarray(scene.triangles.verts[i, k]) for k in range(3)],
                    _np.asarray(scene.triangles.normals[i]),
                    mat(scene.triangles.materials, i))
          for i in range(scene.triangles.count) if bool(scene.triangles.valid[i])]
    meshes: List[OMesh] = []
    mid = _np.asarray(scene.meshes.mesh_id)
    mvalid = _np.asarray(scene.meshes.valid)
    for k in range(scene.meshes.mesh_count):
        if not bool(scene.meshes.mesh_valid[k]):
            continue
        idx = _np.nonzero((mid == k) & mvalid)[0]
        mmat = mat(scene.meshes.mesh_materials, k)
        tris = [OTriangle(*[_np.asarray(scene.meshes.verts[i, v]) for v in range(3)],
                          _np.asarray(scene.meshes.normals[i]), mmat) for i in idx]
        meshes.append(OMesh(tris, _np.asarray(scene.meshes.mesh_aabb_min[k]),
                            _np.asarray(scene.meshes.mesh_aabb_max[k]), mmat))
    lights = [OPointLight(_np.asarray(scene.lights.positions[i]),
                          _np.asarray(scene.lights.intensities[i]))
              for i in range(scene.lights.positions.shape[0])
              if bool(scene.lights.valid[i])]
    return OScene(sp, tr, meshes, lights, _np.asarray(scene.lights.ambient)).finalize()


# --- intersection kernels (scalar) ---------------------------------------

def ray_aabb(o, d, lo, hi) -> bool:
    """Slab test, tmin seeded 0 so origin-inside-box hits (RMath.cs:12-26)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.float32(1.0) / d
    tmin, tmax = np.float32(0.0), np.float32(np.inf)
    for i in range(3):
        t1 = (lo[i] - o[i]) * inv[i]
        t2 = (hi[i] - o[i]) * inv[i]
        tmin = min(max(t1, tmin), max(t2, tmin))
        tmax = max(min(t1, tmax), min(t2, tmax))
    return tmin <= tmax


def ray_triangle(o, d, tri: OTriangle) -> Optional[float]:
    """Moller-Trumbore (RMath.cs:29-73). Returns t or None."""
    e1 = tri.v1 - tri.v0
    e2 = tri.v2 - tri.v0
    h = np.cross(d, e2)
    a = np.dot(e1, h)
    if -EPS < a < EPS:
        return None
    f = 1.0 / a
    s = o - tri.v0
    u = f * np.dot(s, h)
    if u < 0.0 or u > 1.0:
        return None
    q = np.cross(s, e1)
    v = f * np.dot(d, q)
    if v < 0.0 or u + v > 1.0:
        return None
    t = f * np.dot(e2, q)
    if t > EPS:
        return float(t)
    return None


def ray_sphere(o, d, s: OSphere) -> Optional[float]:
    """Half-b quadratic on pre-squared radius (RMath.cs:81-108)."""
    oc = o - s.center
    uoc = np.dot(d, oc)
    disc = uoc * uoc - (np.dot(oc, oc) - s.radius_sq)
    if disc < 0:
        return None
    sq = np.sqrt(disc)
    big = -uoc + sq
    if big < 0:
        return None
    small = -uoc - sq
    return float(big if small < 0 else small)


# hit id: (kind, index, mesh_index); kind in {"none","mesh","sphere","tri"}
def intersect(scene: OScene, o, d) -> Tuple[float, Tuple[str, int, int]]:
    """Nearest hit, strict ``>`` update, order mesh->sphere->loose
    (Scene.cs:43-122)."""
    best = MISS
    hit = ("none", -1, -1)
    if not ray_aabb(o, d, scene.aabb_min, scene.aabb_max):
        return float(best), hit
    for mi, mesh in enumerate(scene.meshes):
        if ray_aabb(o, d, mesh.aabb_min, mesh.aabb_max):
            for ti, tri in enumerate(mesh.triangles):
                t = ray_triangle(o, d, tri)
                if t is not None and best > t:
                    best, hit = t, ("mesh", ti, mi)
    for si, s in enumerate(scene.spheres):
        t = ray_sphere(o, d, s)
        if t is not None and best > t:
            best, hit = t, ("sphere", si, -1)
    for ti, tri in enumerate(scene.triangles):
        t = ray_triangle(o, d, tri)
        if t is not None and best > t:
            best, hit = t, ("tri", ti, -1)
    return float(best), hit


def _normal_and_material(scene: OScene, point, hit) -> Tuple[np.ndarray, OMaterial]:
    """Normal/material lookup by hit id (RayTracingSetup.cs:402-436)."""
    kind, idx, mi = hit
    if kind == "sphere":
        s = scene.spheres[idx]
        n = point - s.center
        return n / np.linalg.norm(n), s.material
    if kind == "tri":
        t = scene.triangles[idx]
        return t.normal, t.material
    if kind == "mesh":
        t = scene.meshes[mi].triangles[idx]
        return t.normal, t.material
    raise ValueError(kind)


# --- shading --------------------------------------------------------------

def _refract(d, n, eta) -> Optional[np.ndarray]:
    """Snell refraction of incident dir d about normal n (d into surface);
    returns None on total internal reflection. Extension — not in reference."""
    cos_i = -np.dot(d, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    if k < 0.0:
        return None
    return eta * d + (eta * cos_i - np.sqrt(k)) * n


def _schlick(cos_i, n1, n2) -> float:
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5


def shade(scene: OScene, o, d, bounce: int, max_bounces: int,
          background: np.ndarray) -> np.ndarray:
    """Recursive Whitted shade (RayTracingSetup.cs:304-366) on the 0-255
    radiance scale; ``background`` is given on the same scale (the reference
    wraps its 0-1 Color as Rgb by multiplying 255, Rgb.cs:17)."""
    t, hit = intersect(scene, o, d)
    if hit[0] == "none":
        return background.astype(np.float64).copy()

    p = o + d * t
    n, mat = _normal_and_material(scene, p, hit)
    v = (o - p)
    v = v / np.linalg.norm(v)  # direction to previous origin (= -d)

    color = mat.ambient * scene.ambient  # CalculateAmbient (:438-441)

    for light in scene.lights:
        lvec = light.position - p
        ldist_sq = float(np.dot(lvec, lvec))
        ldir = lvec / np.sqrt(ldist_sq)
        so = p + n * SHADOW_EPS
        st, shit = intersect(scene, so, ldir)
        if shit[0] != "none" and st * st < ldist_sq:
            continue  # occluded (:337-345)
        irr = light.intensity / ldist_sq  # 1/d^2 falloff (:350)
        ln = float(np.dot(ldir, n))
        color = color + mat.diffuse * max(0.0, ln) * irr  # diffuse (:443-455)
        # specular with behind-surface cut (angle > 90deg <=> ln < 0, :375-400)
        if ln >= 0.0:
            hv = ldir + v
            hv = hv / np.linalg.norm(hv)
            ch = max(0.0, float(np.dot(n, hv)))
            color = color + mat.specular * (ch ** mat.phong) * irr

    if bounce < max_bounces:
        if mat.is_mirror:
            ro = p + n * SHADOW_EPS
            rd = 2.0 * n * np.dot(v, n) - v  # Reflect (:368-373)
            color = color + mat.mirror * shade(scene, ro, rd, bounce + 1,
                                               max_bounces, background)
        if mat.is_dielectric:
            # Extension semantics (shared with the JAX renderer):
            entering = np.dot(d, n) < 0.0
            n_eff = n if entering else -n
            n1, n2 = (1.0, mat.ior) if entering else (mat.ior, 1.0)
            cos_i = -float(np.dot(d, n_eff))
            rdir = _refract(d, n_eff, n1 / n2)
            fres = 1.0 if rdir is None else _schlick(cos_i, n1, n2)
            # reflection branch weighted by Fresnel
            ro = p + n_eff * SHADOW_EPS
            rd = d - 2.0 * np.dot(d, n_eff) * n_eff
            color = color + fres * mat.transparency * shade(
                scene, ro, rd, bounce + 1, max_bounces, background)
            if rdir is not None:
                to = p - n_eff * SHADOW_EPS
                color = color + (1.0 - fres) * mat.transparency * shade(
                    scene, to, rdir, bounce + 1, max_bounces, background)
    return color


def render(scene: OScene, cam, max_bounces: int,
           background=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Render [H,W,3] on the display (0-1) scale: radiance/255 (Rgb.cs:13).

    ``cam`` is a models.camera.Camera; ray generation mirrors
    RayTracingSetup.cs:275-302 (pixel centers, top-left origin).
    """
    import numpy as _np
    pos = _np.asarray(cam.position)
    right = _np.asarray(cam.right)
    up = _np.asarray(cam.up)
    fwd = _np.asarray(cam.forward)
    center = pos + fwd * float(cam.dist)
    top_left = center - right * float(cam.half_h) + up * float(cam.half_v)
    w, h = cam.width, cam.height
    hlen, vlen = 2.0 * float(cam.half_h), 2.0 * float(cam.half_v)
    bg = _np.asarray(background, _np.float64) * 255.0  # Rgb(Color) scale

    img = _np.zeros((h, w, 3), _np.float64)
    for y in range(h):
        for x in range(w):
            pix = top_left + (x + 0.5) * hlen / w * right - up * ((y + 0.5) * vlen / h)
            d = pix - pos
            d = d / _np.linalg.norm(d)
            img[y, x] = shade(scene, pos.astype(_np.float64), d, 0, max_bounces, bg)
    return (img / 255.0).astype(_np.float32)
