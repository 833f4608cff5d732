"""gmpnp.utils.compile_cache.setup_compile_cache: where the persistent XLA
compile cache goes."""

import pathlib

import jax
import pytest

from gmpnp.utils.compile_cache import DEFAULT_CACHE_DIR, setup_compile_cache


@pytest.fixture
def cache_config():
    """Restore the session's cache dir after the test."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert setup_compile_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_configured_dir_kept(monkeypatch, tmp_path, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "cfg"))
    assert setup_compile_cache() == str(tmp_path / "cfg")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cfg")


def test_unset_uses_checkout_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    checkout = pathlib.Path(__file__).resolve().parents[1]
    assert DEFAULT_CACHE_DIR == checkout / ".jax_cache"
    assert setup_compile_cache() == str(checkout / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(checkout / ".jax_cache")
