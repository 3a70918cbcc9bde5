"""The persistent compilation cache sits at a fixed path: the one
JAX_COMPILATION_CACHE_DIR names, else <repo>/.jax_cache (git-ignored)."""
from pathlib import Path

import jax
import pytest

from flexpart_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_is_left_to_jax(monkeypatch, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert compile_cache.enable_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_repo_path(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(REPO / ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    # a second call (another entry point in the same process) agrees
    assert compile_cache.enable_compile_cache() == want
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
