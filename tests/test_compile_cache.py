"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins untouched;
otherwise a fixed directory inside the checkout.  Every script goes
through it."""

import pathlib

import jax
import pytest

from raycastworlds_tpu.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_honoured(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir is None


def test_default_is_fixed_path_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_scripts_set_no_cache_dir_of_their_own():
    scripts = [ROOT / "bench.py", ROOT / "bench_ppo.py",
               ROOT / "bench_scaling.py", ROOT / "chip_smoke.py",
               *sorted((ROOT / "examples").glob("*.py"))]
    for path in scripts:
        text = path.read_text()
        assert "jax_compilation_cache_dir" not in text, path
        assert "jax_comp_cache" not in text, path
    for name in ("bench.py", "bench_ppo.py", "bench_scaling.py",
                 "chip_smoke.py", "examples/profile_step.py",
                 "examples/profile_ppo.py"):
        assert "enable_compile_cache()" in (ROOT / name).read_text(), name
