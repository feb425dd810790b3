"""Entry-point contracts: the compile-cache rule, chip_smoke.py's refusal
to run without a GPU, and bench.py's exactness tolerance."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from pointcloud_render.raster.primitives import KIND_CAPSULE, KIND_DISC
from pointcloud_render.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # bench.py lives at the repository root


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, restore_cache_dir,
                                   tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    program sets no cache directory of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_in_the_checkout(monkeypatch,
                                                  restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repo, the script must fail and print no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _buffers():
    """A 300x400 reference with two disc winners split down the middle
    (one flipped pixel is 8.3e-6 of the image, inside the 1e-5 bound)."""
    idx = np.full((300, 400), 1, np.int32)
    idx[:, 200:] = 2
    depth = np.where(idx == 1, np.float32(2.0), np.float32(3.0))
    kind = np.array([KIND_CAPSULE, KIND_DISC, KIND_DISC], np.int32)
    return depth, idx, kind


@pytest.mark.parametrize("case,ok", [
    ("identical", True),
    ("edge_flip", True),
    ("interior_flip", False),
    ("disc_depth_ulp", False),
])
def test_bench_agreement_tolerance(case, ok):
    from bench import agreement

    d_ref, i_ref, kind = _buffers()
    d, i = d_ref.copy(), i_ref.copy()
    if case == "edge_flip":  # a pixel on the boundary changes owner
        i[2, 200], d[2, 200] = 1, 2.0
    elif case == "interior_flip":  # a pixel far from any boundary
        i[2, 100], d[2, 100] = 2, 3.0
    elif case == "disc_depth_ulp":
        d[0, 0] = np.nextafter(d[0, 0], np.float32(9))
    got, counts = agreement(d_ref, i_ref, d, i, kind)
    assert got == ok, counts
