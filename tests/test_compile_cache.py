"""The compile-cache helper: the environment variable wins, else a fixed
directory inside the checkout."""

import jax

from cellularautomatons3d_tpu.utils import compile_cache


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_cache_dir_defaults_inside_checkout(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    root = compile_cache.DEFAULT_DIR.parent
    assert got == str(root / ".jax_cache")
    assert (root / "cellularautomatons3d_tpu").is_dir()
    assert calls == [("jax_compilation_cache_dir", got)]
