"""Entry-point plumbing: where the compile cache lives, and chip_smoke.py's
refusal to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax

from pebblesdr_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def _record_updates(monkeypatch):
    """Capture jax.config.update calls instead of changing this process's
    cache (a real update would send every later compile of the test
    worker into the cache directory)."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_cache_dir_follows_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.enable() == str(tmp_path)
    # the env var is JAX's own setting: enable() sets nothing in code
    assert calls == []


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    assert compile_cache.cache_dir() == str(REPO / ".jax_cache")
    assert compile_cache.enable() == str(REPO / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", str(REPO / ".jax_cache"))]


def test_cache_dir_is_fixed_across_calls(monkeypatch):
    """The path is part of the cache key: two calls (two runs) agree."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == compile_cache.cache_dir()
    assert Path(compile_cache.cache_dir()).is_absolute()


def test_chip_smoke_refuses_cpu_host():
    """On a host whose JAX finds no GPU the smoke exits non-zero and
    prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr
