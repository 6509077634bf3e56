"""Entry-point plumbing: where the compile cache lives, and that the
GPU smoke run refuses to report success anywhere but on a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from aligngraph2_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.compile_cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_is_active():
    """conftest enabled the cache through the helper, at its path."""
    import jax
    assert jax.config.jax_compilation_cache_dir == \
        compile_cache.compile_cache_dir()


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            pass
    return False


def test_chip_smoke_fails_without_gpu():
    res = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert res.returncode != 0
    assert not _has_ok_line(res.stdout)
    assert "phase device: FAILED" in res.stderr


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert res.returncode != 0
    assert not _has_ok_line(res.stdout)


@pytest.mark.parametrize("n,want_max", [(100, 4), (65536, 4)])
def test_noisy_copy_drift_is_bounded(n, want_max):
    """The smoke run's planted reads keep within four bases of their
    diagonal, so the static and adaptive bands see the same optimum."""
    import numpy as np
    from chip_smoke import noisy_copy
    rng = np.random.default_rng(n)
    src = rng.integers(0, 4, n).astype(np.uint8)
    out = noisy_copy(rng, src)
    assert abs(len(out) - n) <= want_max
    assert out.max() <= 3
