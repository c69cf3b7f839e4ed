"""SoA scene representation (JAX pytrees).

Design notes (batched, not a port)
----------------------------------
The reference stores scenes as C# ``List<T>`` of AoS structs rebuilt from Unity
GameObjects every frame (reference: Data/Objects/SphereData.cs,
TriangleData.cs, MeshData.cs; Demo-RayTracing/RayTracingSetup.cs:120-128).
Here a scene is a frozen structure-of-arrays pytree with **static shapes**:
every primitive category is padded to a fixed capacity with a boolean validity
mask, so the whole render jits once and XLA sees only dense, tileable tensors.

Category model (mirrors the reference's data model so hit identity and
tie-break order can match exactly — reference Data/Objects/Scene.cs:64-115
checks mesh triangles, then spheres, then loose triangles):

* ``Spheres``     — centers [S,3], radius_sq [S] (pre-squared radius, like
                    reference Data/Objects/Sphere.cs:11), per-sphere material.
* ``Triangles``   — "loose" triangles: verts [T,3,3], per-tri normals and
                    materials (reference Data/Objects/TriangleData.cs).
* ``MeshSet``     — all mesh triangles of all meshes concatenated into one
                    flat array [M,3,3] with per-triangle ``mesh_id``; per-mesh
                    AABBs and materials are small side tables (reference
                    Data/Objects/Mesh.cs keeps a jagged per-mesh layout; a flat
                    layout is what vectorizes).

Materials are Blinn-Phong per the reference (Data/Shading/MaterialData.cs:7-15)
plus the dielectric extension (transparency/IOR) the baseline's config 2
requires — the reference has no refraction at all.

All geometry is float32: ray/primitive intersection is ill-conditioned in
bfloat16. There is no matrix product on the path for low precision to
speed up.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls):
    """Register a dataclass as a JAX pytree (all fields are children)."""
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


def _f32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.float32)


@_register
@dataclass(frozen=True)
class Materials:
    """Blinn-Phong material table, SoA over N primitives.

    Matches reference Data/Shading/MaterialData.cs:7-15, extended with a
    dielectric path (transparency / ior) for refraction support.
    """

    diffuse: jnp.ndarray        # [N,3] DiffuseReflectance
    ambient: jnp.ndarray        # [N,3] AmbientReflectance
    mirror: jnp.ndarray         # [N,3] MirrorReflectance
    specular: jnp.ndarray       # [N,3] SpecularReflectance
    phong: jnp.ndarray          # [N]   PhongExponent
    is_mirror: jnp.ndarray      # [N]   bool
    transparency: jnp.ndarray   # [N,3] dielectric transmittance (extension)
    ior: jnp.ndarray            # [N]   index of refraction (extension)
    is_dielectric: jnp.ndarray  # [N]   bool (extension)

    @staticmethod
    def zeros(n: int) -> "Materials":
        return Materials(
            diffuse=jnp.zeros((n, 3), jnp.float32),
            ambient=jnp.zeros((n, 3), jnp.float32),
            mirror=jnp.zeros((n, 3), jnp.float32),
            specular=jnp.zeros((n, 3), jnp.float32),
            phong=jnp.ones((n,), jnp.float32),
            is_mirror=jnp.zeros((n,), bool),
            transparency=jnp.zeros((n, 3), jnp.float32),
            ior=jnp.ones((n,), jnp.float32),
            is_dielectric=jnp.zeros((n,), bool),
        )

    def take(self, idx: jnp.ndarray) -> "Materials":
        """Gather material rows by index (idx of any shape)."""
        return jax.tree.map(lambda a: jnp.take(a, idx, axis=0), self)

    @property
    def count(self) -> int:
        return self.phong.shape[0]


@_register
@dataclass(frozen=True)
class Spheres:
    centers: jnp.ndarray     # [S,3]
    radius_sq: jnp.ndarray   # [S] pre-squared, reference Sphere.cs:11
    materials: Materials     # [S]
    valid: jnp.ndarray       # [S] bool; padding rows are False

    @property
    def count(self) -> int:
        return self.radius_sq.shape[0]


@_register
@dataclass(frozen=True)
class Triangles:
    """Loose triangles with explicit per-triangle shading normals.

    The reference derives the geometric normal as
    ``cross(v2-v0, v1-v0)/|.|`` (Data/Objects/Triangle.cs:18) and stores it per
    loose triangle (RayTracingSetup.cs:163-167); mesh baking negates it
    (SceneComponents/SceneMesh.cs:43). We store normals as data — builders
    apply whichever convention.
    """

    verts: jnp.ndarray       # [T,3,3] (vertex, xyz)
    normals: jnp.ndarray     # [T,3] shading normals (unit)
    materials: Materials     # [T]
    valid: jnp.ndarray       # [T] bool

    @property
    def count(self) -> int:
        return self.verts.shape[0]


@_register
@dataclass(frozen=True)
class MeshSet:
    """All mesh triangles concatenated; per-mesh side tables.

    Reference keeps a jagged ``List<Mesh>`` each with its own triangle array
    (Data/Objects/MeshData.cs, Mesh.cs) and brute-forces triangles behind a
    per-mesh AABB gate (Scene.cs:64-85). The flat layout here lets one batched
    kernel cover every mesh triangle; the per-mesh AABB gate becomes a mask.
    """

    verts: jnp.ndarray        # [M,3,3] all mesh triangles, concatenated
    normals: jnp.ndarray      # [M,3]
    mesh_id: jnp.ndarray      # [M] int32 — which mesh each triangle belongs to
    valid: jnp.ndarray        # [M] bool
    mesh_aabb_min: jnp.ndarray  # [K,3]
    mesh_aabb_max: jnp.ndarray  # [K,3]
    mesh_materials: Materials   # [K] one material per mesh (reference Mesh.cs:11)
    mesh_valid: jnp.ndarray     # [K] bool

    @property
    def count(self) -> int:
        return self.verts.shape[0]

    @property
    def mesh_count(self) -> int:
        return self.mesh_aabb_min.shape[0]


@_register
@dataclass(frozen=True)
class Lights:
    """Point lights + single ambient light.

    Reference: Data/Lights/PointLightData.cs (position, float3 intensity — the
    scene bridge broadcasts a scalar, ScenePointLight.cs:9-13) and
    AmbientLightData.cs. Falloff 1/d^2 is applied in the shader
    (RayTracingSetup.cs:350). Multiple ambient lights are an error in the
    reference (RayTracingSetup.cs:135-139); here the scene simply holds one.
    """

    positions: jnp.ndarray    # [L,3]
    intensities: jnp.ndarray  # [L,3]
    valid: jnp.ndarray        # [L] bool
    ambient: jnp.ndarray      # [3] ambient radiance


@_register
@dataclass(frozen=True)
class Scene:
    """Full scene: three primitive categories + lights + scene AABB.

    ``aabb_min/max`` mirror reference Scene.CalculateAABB (Scene.cs:17-41);
    the scene-level early-out (Scene.cs:54) is useless for batched primary
    rays (they all hit the scene box) but kept for shadow/secondary rays.
    """

    spheres: Spheres
    triangles: Triangles
    meshes: MeshSet
    lights: Lights
    aabb_min: jnp.ndarray  # [3]
    aabb_max: jnp.ndarray  # [3]

    @property
    def has_dielectrics(self) -> bool:
        """Static hint (computed on concrete scenes at build time)."""
        return bool(
            np.any(np.asarray(self.spheres.materials.is_dielectric))
            or np.any(np.asarray(self.triangles.materials.is_dielectric))
            or np.any(np.asarray(self.meshes.mesh_materials.is_dielectric))
        )


# ---------------------------------------------------------------------------
# Builder (host-side, numpy) — the replacement for the reference's per-frame
# FindObjectsOfType sweeps (RayTracingSetup.cs:120-169).
# ---------------------------------------------------------------------------

_MAT_DEFAULTS = dict(
    diffuse=(0.0, 0.0, 0.0),
    ambient=(0.0, 0.0, 0.0),
    mirror=(0.0, 0.0, 0.0),
    specular=(0.0, 0.0, 0.0),
    phong=1.0,
    is_mirror=False,
    transparency=(0.0, 0.0, 0.0),
    ior=1.0,
    is_dielectric=False,
)


def make_material(**kw) -> dict:
    """A material record; unspecified fields take reference-default zeros."""
    bad = set(kw) - set(_MAT_DEFAULTS)
    if bad:
        raise ValueError(f"unknown material fields: {bad}")
    out = dict(_MAT_DEFAULTS)
    out.update(kw)
    return out


def _mat_soa(records: Sequence[dict], pad_to: int) -> Materials:
    n = max(pad_to, 1)
    recs = list(records) + [dict(_MAT_DEFAULTS)] * (n - len(records))
    return Materials(
        diffuse=_f32([r["diffuse"] for r in recs]),
        ambient=_f32([r["ambient"] for r in recs]),
        mirror=_f32([r["mirror"] for r in recs]),
        specular=_f32([r["specular"] for r in recs]),
        phong=_f32([r["phong"] for r in recs]),
        is_mirror=jnp.asarray([bool(r["is_mirror"]) for r in recs], bool),
        transparency=_f32([r["transparency"] for r in recs]),
        ior=_f32([r["ior"] for r in recs]),
        is_dielectric=jnp.asarray([bool(r["is_dielectric"]) for r in recs], bool),
    )


def triangle_normal(v0, v1, v2) -> np.ndarray:
    """Reference normal convention: cross(v2-v0, v1-v0) normalized
    (Data/Objects/Triangle.cs:14-21)."""
    v = np.cross(np.asarray(v2, np.float32) - v0, np.asarray(v1, np.float32) - v0)
    return (v / np.linalg.norm(v)).astype(np.float32)


class SceneBuilder:
    """Accumulates primitives host-side, then freezes into a padded Scene.

    ``pad_*`` round capacities up so repeated builds of similar scenes reuse
    one compiled executable (static shapes = one XLA compilation).
    """

    def __init__(self):
        self._spheres: List[Tuple[np.ndarray, float]] = []
        self._sphere_mats: List[dict] = []
        self._tris: List[np.ndarray] = []          # [3,3]
        self._tri_normals: List[np.ndarray] = []
        self._tri_mats: List[dict] = []
        self._mesh_tris: List[np.ndarray] = []     # per mesh: [m,3,3]
        self._mesh_normals: List[np.ndarray] = []  # per mesh: [m,3]
        self._mesh_mats: List[dict] = []
        self._light_pos: List[np.ndarray] = []
        self._light_int: List[np.ndarray] = []
        self._ambient = np.zeros(3, np.float32)

    # -- primitives --------------------------------------------------------
    def add_sphere(self, center, radius: float, material: dict) -> "SceneBuilder":
        self._spheres.append((np.asarray(center, np.float32), float(radius) ** 2))
        self._sphere_mats.append(material)
        return self

    def add_triangle(self, v0, v1, v2, material: dict, normal=None) -> "SceneBuilder":
        tri = np.asarray([v0, v1, v2], np.float32)
        self._tris.append(tri)
        n = triangle_normal(v0, v1, v2) if normal is None else np.asarray(normal, np.float32)
        self._tri_normals.append(n)
        self._tri_mats.append(material)
        return self

    def add_mesh(self, verts: np.ndarray, faces: np.ndarray, material: dict,
                 flip_normals: bool = True) -> "SceneBuilder":
        """Add an indexed triangle mesh.

        ``flip_normals=True`` reproduces the reference mesh-baking convention
        of negating the derived triangle normal (SceneMesh.cs:43).
        """
        verts = np.asarray(verts, np.float32)
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        tris = verts[faces]  # [m,3,3]
        e1 = tris[:, 2] - tris[:, 0]
        e2 = tris[:, 1] - tris[:, 0]
        n = np.cross(e1, e2)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        if flip_normals:
            n = -n
        self._mesh_tris.append(tris.astype(np.float32))
        self._mesh_normals.append(n.astype(np.float32))
        self._mesh_mats.append(material)
        return self

    def add_point_light(self, position, intensity) -> "SceneBuilder":
        self._light_pos.append(np.asarray(position, np.float32))
        i = np.asarray(intensity, np.float32)
        if i.ndim == 0:  # scalar broadcast, as ScenePointLight.cs:9-13 does
            i = np.full(3, float(i), np.float32)
        self._light_int.append(i)
        return self

    def set_ambient(self, radiance) -> "SceneBuilder":
        self._ambient = np.asarray(radiance, np.float32)
        return self

    # -- freeze ------------------------------------------------------------
    def build(self, pad_spheres: int = 0, pad_triangles: int = 0,
              pad_mesh_tris: int = 0, pad_meshes: int = 0,
              pad_lights: int = 0) -> Scene:
        S = max(len(self._spheres), pad_spheres, 1)
        T = max(len(self._tris), pad_triangles, 1)
        K = max(len(self._mesh_tris), pad_meshes, 1)
        L = max(len(self._light_pos), pad_lights, 1)

        # Spheres
        sc = np.zeros((S, 3), np.float32)
        sr = np.full((S,), 1.0, np.float32)
        sv = np.zeros((S,), bool)
        for i, (c, r2) in enumerate(self._spheres):
            sc[i], sr[i], sv[i] = c, r2, True
        spheres = Spheres(
            centers=jnp.asarray(sc), radius_sq=jnp.asarray(sr),
            materials=_mat_soa(self._sphere_mats, S), valid=jnp.asarray(sv))

        # Loose triangles (degenerate padding tri at origin never hits: all
        # verts equal -> Moller-Trumbore determinant 0 -> parallel reject)
        tv = np.zeros((T, 3, 3), np.float32)
        tn = np.tile(np.array([0, 0, 1], np.float32), (T, 1))
        tvalid = np.zeros((T,), bool)
        for i, tri in enumerate(self._tris):
            tv[i], tn[i], tvalid[i] = tri, self._tri_normals[i], True
        triangles = Triangles(
            verts=jnp.asarray(tv), normals=jnp.asarray(tn),
            materials=_mat_soa(self._tri_mats, T), valid=jnp.asarray(tvalid))

        # Meshes: concatenate
        if self._mesh_tris:
            mv = np.concatenate(self._mesh_tris, axis=0)
            mn = np.concatenate(self._mesh_normals, axis=0)
            mid = np.concatenate([
                np.full(len(t), k, np.int32) for k, t in enumerate(self._mesh_tris)])
        else:
            mv = np.zeros((0, 3, 3), np.float32)
            mn = np.zeros((0, 3), np.float32)
            mid = np.zeros((0,), np.int32)
        M = max(mv.shape[0], pad_mesh_tris, 1)
        mvp = np.zeros((M, 3, 3), np.float32)
        mnp_ = np.tile(np.array([0, 0, 1], np.float32), (M, 1))
        midp = np.zeros((M,), np.int32)
        mvalid = np.zeros((M,), bool)
        mvp[: mv.shape[0]] = mv
        mnp_[: mn.shape[0]] = mn
        midp[: mid.shape[0]] = mid
        mvalid[: mv.shape[0]] = True

        amin = np.full((K, 3), np.inf, np.float32)
        amax = np.full((K, 3), -np.inf, np.float32)
        kvalid = np.zeros((K,), bool)
        for k, t in enumerate(self._mesh_tris):
            amin[k] = t.reshape(-1, 3).min(axis=0)
            amax[k] = t.reshape(-1, 3).max(axis=0)
            kvalid[k] = True
        meshes = MeshSet(
            verts=jnp.asarray(mvp), normals=jnp.asarray(mnp_),
            mesh_id=jnp.asarray(midp), valid=jnp.asarray(mvalid),
            mesh_aabb_min=jnp.asarray(amin), mesh_aabb_max=jnp.asarray(amax),
            mesh_materials=_mat_soa(self._mesh_mats, K),
            mesh_valid=jnp.asarray(kvalid))

        # Lights
        lp = np.zeros((L, 3), np.float32)
        li = np.zeros((L, 3), np.float32)
        lv = np.zeros((L,), bool)
        for i, p in enumerate(self._light_pos):
            lp[i], li[i], lv[i] = p, self._light_int[i], True
        lights = Lights(
            positions=jnp.asarray(lp), intensities=jnp.asarray(li),
            valid=jnp.asarray(lv), ambient=jnp.asarray(self._ambient))

        # Scene AABB over valid geometry (reference Scene.cs:17-41)
        pts = [mv.reshape(-1, 3)] if mv.size else []
        if self._tris:
            pts.append(np.stack(self._tris).reshape(-1, 3))
        for (c, r2) in self._spheres:
            r = np.sqrt(r2)
            pts.append((c - r)[None])
            pts.append((c + r)[None])
        if pts:
            allp = np.concatenate(pts, axis=0)
            aabb_min, aabb_max = allp.min(axis=0), allp.max(axis=0)
        else:
            aabb_min = np.full(3, np.float32(np.finfo(np.float32).max))
            aabb_max = np.full(3, np.float32(np.finfo(np.float32).min))

        return Scene(
            spheres=spheres, triangles=triangles, meshes=meshes, lights=lights,
            aabb_min=jnp.asarray(aabb_min, jnp.float32),
            aabb_max=jnp.asarray(aabb_max, jnp.float32))
