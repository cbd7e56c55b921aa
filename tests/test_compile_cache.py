"""The persistent compile-cache helper shared by every entry point."""

import jax

from orbslam3_tpu.utils import compile_cache as cc


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_var_set_leaves_the_directory_to_jax(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    assert cc.setup_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_env_var_unset_uses_the_fixed_checkout_directory(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    assert cc.setup_compile_cache() == cc.DEFAULT_DIR
    assert calls["jax_compilation_cache_dir"] == cc.DEFAULT_DIR
    # a fixed path inside the checkout: the cache key includes it
    assert cc.DEFAULT_DIR == cc.setup_compile_cache()
    assert cc.DEFAULT_DIR.startswith(cc.REPO_ROOT)
