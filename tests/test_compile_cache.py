"""The compilation-cache helper: the environment variable wins, otherwise one
fixed directory inside the checkout."""

import os

import jax

from mogasr.utils import compile_cache as CC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv(CC.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert CC.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # sets nothing


def test_default_is_fixed_dir_in_checkout(monkeypatch):
    monkeypatch.delenv(CC.ENV_VAR, raising=False)
    assert CC.cache_dir() == os.path.join(ROOT, ".jax_cache")
    assert not CC.cache_dir().startswith("/tmp")


def test_enable_sets_the_checkout_dir(monkeypatch):
    monkeypatch.delenv(CC.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert CC.enable_compile_cache() == CC.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == CC.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_is_gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
