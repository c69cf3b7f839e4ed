"""Platform routing (ops/backend.py), the compile-cache helper, the native
builder's build, and chip_smoke.py's contract on a machine without a GPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from unity_raytracer_tpu.models import meshgen
from unity_raytracer_tpu.ops import backend
from unity_raytracer_tpu.ops import bvh as bvhmod
from unity_raytracer_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the one backend decision
# ---------------------------------------------------------------------------

def test_cpu_picks_xla_walk():
    assert jax.default_backend() == "cpu"
    assert backend.walk_route("auto") == ("xla", False)


def test_gpu_picks_compiled_kernel(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.walk_route("auto") == ("walk", False)


@pytest.mark.parametrize("platform", ["metal", "neuron", "rocm_x"])
def test_unknown_platform_raises(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(backend.UnsupportedPlatformError, match=platform):
        backend.walk_route("auto")


@pytest.mark.parametrize("kernel,route", [("xla", ("xla", False)),
                                          ("interpret", ("walk", True))])
def test_explicit_kernels_ignore_platform(monkeypatch, kernel, route):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    assert backend.walk_route(kernel) == route


@pytest.mark.parametrize("kernel", ["pallas", "mega", "wide", "triton"])
def test_unknown_kernel_raises(kernel):
    with pytest.raises(ValueError, match="unknown kernel"):
        backend.walk_route(kernel)


def test_traverse_any_on_gpu_calls_compiled_kernel(monkeypatch):
    """A (monkeypatched) GPU platform sends traverse_any to the Pallas
    walk with interpret=False; the wrapper's result feeds the epilogue."""
    from unity_raytracer_tpu.ops.pallas import walk as wk

    v, f = meshgen.icosphere(subdivisions=1, radius=1.0, center=(0, 0, 4))
    bvh = bvhmod.build(v[f])
    o = jnp.zeros((8, 3), jnp.float32)
    d = jnp.zeros((8, 3), jnp.float32).at[:, 2].set(1.0)
    seen = {}

    def fake_walk(bvh_, o_, d_, t_max, any_hit=False, interpret=False,
                  **kw):
        seen.update(interpret=interpret, any_hit=any_hit)
        return bvhmod._walk_xla(bvh_, o_, d_, t_max, any_hit=any_hit)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(wk, "walk", fake_walk)
    t, prim, _ = bvhmod.traverse_any(bvh, o, d, any_hit=True)
    assert seen == {"interpret": False, "any_hit": True}
    assert np.isfinite(np.asarray(t)).all() and (np.asarray(prim) >= 0).all()


def _sources():
    files = [REPO / "bench.py", REPO / "chip_smoke.py",
             REPO / "__graft_entry__.py"]
    files += sorted((REPO / "unity_raytracer_tpu").rglob("*.py"))
    files += sorted((REPO / "tests").rglob("*.py"))
    return files


def test_no_module_imports_a_foreign_kernel_api():
    banned = ("pallas." + "t" + "pu", "plt" + "pu")
    hits = [str(p) for p in _sources()
            if any(b in p.read_text() for b in banned)]
    assert hits == []


def test_platform_read_only_in_backend_module():
    """No code path chooses a walk (or interpret mode) from the platform
    except ops/backend.py."""
    needle = "default_" + "backend()"
    hits = [str(p.relative_to(REPO)) for p in _sources()
            if p.parent.name != "tests" and needle in p.read_text()]
    assert hits == ["unity_raytracer_tpu/ops/backend.py"]


# ---------------------------------------------------------------------------
# compile cache placement
# ---------------------------------------------------------------------------

def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_default_is_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.cache_dir() == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


# ---------------------------------------------------------------------------
# native BVH builder: built from source into the ignored directory
# ---------------------------------------------------------------------------

def test_native_library_built_into_ignored_dir():
    assert bvhmod.NATIVE_SO.parent == REPO / "native" / "build"
    assert "native/build/" in (REPO / ".gitignore").read_text().split()
    if bvhmod._native_lib() is None:
        pytest.skip("no C++ toolchain")
    assert bvhmod.NATIVE_SO.exists()
    tracked = subprocess.run(["git", "ls-files", "native"], cwd=REPO,
                             capture_output=True, text=True).stdout.split()
    assert not any(t.endswith(".so") for t in tracked)


def test_native_makefile_builds_to_given_path(tmp_path):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    out = tmp_path / "libbvh.so"
    subprocess.run(["make", "-s", "-C", str(REPO / "native"), f"OUT={out}"],
                   check=True, capture_output=True, timeout=300)
    assert out.stat().st_size > 0


# ---------------------------------------------------------------------------
# chip_smoke.py contract
# ---------------------------------------------------------------------------

def test_chip_smoke_last_line_format():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = chip_smoke.last_line(dev)
    assert json.loads(line) == {"ok": True, "device": dev}
    assert "\n" not in line


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_fast_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
