"""Kernel unit tests: analytic ray/sphere, ray/triangle, ray/AABB cases.

Ports the *intent* of the reference's single (defective) unit test
(Tests/RayTracerTests.cs:8-27 asserts a scalar distance against a point) —
correctly — plus the edge cases the reference's branches encode
(RMath.cs:39-43 parallel reject, :99-106 behind-origin roots, :15
origin-inside-AABB, :48-60 barycentric rejects).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from unity_raytracer_tpu import oracle
from unity_raytracer_tpu.ops import intersect as isect


def _o(*xs):
    return np.asarray(xs, np.float32)


class TestRaySphere:
    def test_case1_reference(self):
        # the reference test's scenario, with the assertion it meant to make:
        # ray +x from origin vs sphere at (300,0,0) r^2=1 hits at distance 299
        t = isect.ray_spheres(
            jnp.asarray([[0, 0, 0]], jnp.float32),
            jnp.asarray([[1, 0, 0]], jnp.float32),
            jnp.asarray([[300, 0, 0]], jnp.float32),
            jnp.asarray([1.0], jnp.float32))
        assert np.isclose(float(t[0, 0]), 299.0, atol=1e-3)

    def test_miss(self):
        t = isect.ray_spheres(
            jnp.asarray([[0, 0, 0]], jnp.float32),
            jnp.asarray([[0, 1, 0]], jnp.float32),
            jnp.asarray([[300, 0, 0]], jnp.float32),
            jnp.asarray([1.0], jnp.float32))
        assert np.isinf(float(t[0, 0]))

    def test_behind_origin(self):
        # sphere entirely behind the ray -> both roots negative -> miss
        t = isect.ray_spheres(
            jnp.asarray([[0, 0, 0]], jnp.float32),
            jnp.asarray([[1, 0, 0]], jnp.float32),
            jnp.asarray([[-10, 0, 0]], jnp.float32),
            jnp.asarray([1.0], jnp.float32))
        assert np.isinf(float(t[0, 0]))

    def test_inside_sphere_takes_far_root(self):
        # origin inside -> small root negative -> big root returned
        t = isect.ray_spheres(
            jnp.asarray([[0, 0, 0]], jnp.float32),
            jnp.asarray([[1, 0, 0]], jnp.float32),
            jnp.asarray([[0, 0, 0]], jnp.float32),
            jnp.asarray([4.0], jnp.float32))
        assert np.isclose(float(t[0, 0]), 2.0, atol=1e-6)

    def test_matches_oracle_random(self, rng):
        n, s = 64, 16
        o = rng.normal(size=(n, 3)).astype(np.float32) * 2
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        c = rng.normal(size=(s, 3)).astype(np.float32) * 3
        r2 = rng.uniform(0.25, 4.0, size=s).astype(np.float32)
        t = np.asarray(isect.ray_spheres(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(c), jnp.asarray(r2)))
        for i in range(n):
            for j in range(s):
                ref = oracle.ray_sphere(o[i], d[i],
                                        oracle.OSphere(c[j], float(r2[j]), None))
                if ref is None:
                    assert np.isinf(t[i, j]), (i, j)
                else:
                    assert np.isclose(t[i, j], ref, rtol=1e-4, atol=1e-4)


class TestRayTriangle:
    tri = np.asarray([[[0, 10, 0], [-10, -10, 0], [10, -10, 0]]], np.float32)

    def test_head_on(self):
        t = isect.ray_triangles(
            jnp.asarray([[0, 0, -5]], jnp.float32),
            jnp.asarray([[0, 0, 1]], jnp.float32),
            jnp.asarray(self.tri))
        assert np.isclose(float(t[0, 0]), 5.0, atol=1e-5)

    def test_parallel_reject(self):
        t = isect.ray_triangles(
            jnp.asarray([[0, 0, -5]], jnp.float32),
            jnp.asarray([[1, 0, 0]], jnp.float32),
            jnp.asarray(self.tri))
        assert np.isinf(float(t[0, 0]))

    def test_barycentric_reject(self):
        # aims past the corner -> u/v reject
        t = isect.ray_triangles(
            jnp.asarray([[50, 50, -5]], jnp.float32),
            jnp.asarray([[0, 0, 1]], jnp.float32),
            jnp.asarray(self.tri))
        assert np.isinf(float(t[0, 0]))

    def test_behind_reject(self):
        t = isect.ray_triangles(
            jnp.asarray([[0, 0, 5]], jnp.float32),
            jnp.asarray([[0, 0, 1]], jnp.float32),
            jnp.asarray(self.tri))
        assert np.isinf(float(t[0, 0]))

    def test_matches_oracle_random(self, rng):
        n, m = 64, 16
        o = rng.normal(size=(n, 3)).astype(np.float32) * 2
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        tris = rng.normal(size=(m, 3, 3)).astype(np.float32) * 3
        t = np.asarray(isect.ray_triangles(jnp.asarray(o), jnp.asarray(d),
                                           jnp.asarray(tris)))
        for i in range(n):
            for j in range(m):
                tri = oracle.OTriangle(tris[j, 0], tris[j, 1], tris[j, 2],
                                       None, None)
                ref = oracle.ray_triangle(o[i], d[i], tri)
                if ref is None:
                    assert np.isinf(t[i, j]), (i, j)
                else:
                    assert np.isclose(t[i, j], ref, rtol=1e-3, atol=1e-4)


class TestRayAABB:
    def test_origin_inside_hits(self):
        # tmin seeded 0 => origin inside the box intersects (RMath.cs:15)
        hit = isect.ray_aabb(
            jnp.asarray([0.0, 0, 0]), jnp.asarray([0.0, 0, 1]),
            jnp.asarray([-1.0, -1, -1]), jnp.asarray([1.0, 1, 1]))
        assert bool(hit)

    def test_miss_behind(self):
        hit = isect.ray_aabb(
            jnp.asarray([0.0, 0, 5]), jnp.asarray([0.0, 0, 1]),
            jnp.asarray([-1.0, -1, -1]), jnp.asarray([1.0, 1, 1]))
        assert not bool(hit)

    def test_axis_parallel_on_face(self):
        hit = isect.ray_aabb(
            jnp.asarray([0.0, 0, -5]), jnp.asarray([0.0, 0, 1]),
            jnp.asarray([-1.0, -1, -1]), jnp.asarray([1.0, 1, 1]))
        assert bool(hit)

    def test_matches_oracle_random(self, rng):
        n = 256
        o = rng.normal(size=(n, 3)).astype(np.float32) * 3
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        lo = rng.normal(size=(n, 3)).astype(np.float32) - 1
        hi = lo + rng.uniform(0.5, 3.0, size=(n, 3)).astype(np.float32)
        got = np.asarray(isect.ray_aabb(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(lo), jnp.asarray(hi)))
        for i in range(n):
            assert got[i] == oracle.ray_aabb(o[i], d[i], lo[i], hi[i]), i


class TestNearestHit:
    def test_category_order_and_identity(self):
        """Strict-> tie-break and category order match the oracle on the
        reference demo scene."""
        from unity_raytracer_tpu.models.presets import reference_demo
        from unity_raytracer_tpu.models.camera import generate_rays

        scene, cam, _ = reference_demo(width=24, height=24)
        osc = oracle.from_scene(scene)
        o, d = generate_rays(cam)
        hit = isect.nearest_hit(scene, o, d)
        o_np, d_np = np.asarray(o), np.asarray(d)
        kinds = {"none": 0, "mesh": 1, "sphere": 2, "tri": 3}
        for i in range(o_np.shape[0]):
            t_ref, (kind, idx, mi) = oracle.intersect(osc, o_np[i], d_np[i])
            assert int(hit.kind[i]) == kinds[kind], i
            if kind != "none":
                assert np.isclose(float(hit.t[i]), t_ref, rtol=1e-4), i
                if kind == "mesh":
                    # flat layout: oracle idx is per-mesh; mesh ids must agree
                    assert int(hit.mesh_index[i]) == mi, i
                else:
                    assert int(hit.index[i]) == idx, i
