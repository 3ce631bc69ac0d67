"""Persistent compile cache location (utils/cache.py) and start-up
imports that the card's machine must not need."""

import os
import subprocess
import sys

import jax
import pytest

from bpt_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_wins_and_code_sets_none():
    assert cache.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None


def test_default_dir_is_fixed_inside_the_checkout():
    path = cache.compile_cache_dir({})
    assert path == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_uses_checkout_dir_without_env(monkeypatch, tmp_path,
                                              restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cache, "CHECKOUT_CACHE_DIR", str(tmp_path / "c"))
    cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    assert (tmp_path / "c").is_dir()


def test_enable_leaves_env_dir_alone(monkeypatch, tmp_path,
                                     restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "env"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.setattr(cache, "CHECKOUT_CACHE_DIR", str(tmp_path / "c"))
    cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "env")
    assert not (tmp_path / "c").exists()


def test_render_path_imports_without_yaml():
    """The built-in scene renders without PyYAML: only YAML scene files
    import the parser."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import bpt_tpu.scene.loader, bpt_tpu.render, bpt_tpu.models.render\n"
        "from bpt_tpu.scene.loader import load_scene_from_yaml\n"
        "try:\n"
        "    load_scene_from_yaml('scenes/cornell_box.yaml')\n"
        "except ImportError:\n"
        "    print('yaml needed only here')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert "yaml needed only here" in out.stdout
