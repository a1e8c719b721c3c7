"""The device policy and the compile-cache location (``mcpt.runtime``), and
the CLI's engine table (``tools/render.py``)."""

import os
import sys

import jax
import pytest

from mcpt import runtime
from mcpt.config import parse_config_text

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools import render  # noqa: E402


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_uses_env_dir(tmp_path, monkeypatch, restore_cache_dir):
    target = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    jax.config.update("jax_compilation_cache_dir", None)
    assert runtime.enable_compile_cache() == target
    assert os.path.isdir(target)
    # the variable is JAX's own: nothing in code overrides it
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_inside_checkout(monkeypatch,
                                                restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(repo, ".gitignore")) as f:
        assert "/.jax_cache/" in f.read().split()


@pytest.mark.parametrize("engine,n_tris,expect", [
    ("auto", 36, "mega"),
    ("auto", render.MEGA_MAX_TRIS + 1, "wavefront"),
    ("wavefront", 36, "wavefront"),
    ("bogus", 36, ValueError),
])
def test_engine_table(engine, n_tris, expect):
    if expect is ValueError:
        with pytest.raises(ValueError):
            render.pick_engine(engine, n_tris)
        with pytest.raises(ValueError, match="unknown engine"):
            parse_config_text('{"config": [{"engine": "%s"}]}' % engine)
    else:
        assert render.pick_engine(engine, n_tris) == expect


def test_megakernel_refuses_non_gpu_backend():
    """Without interpret=True a kernel must compile for the GPU; on any other
    backend it raises instead of quietly running the interpreter."""
    from mcpt.pallas import megakernel as mk
    from mcpt.render import camera as cm
    from mcpt.scene import build_scene
    from mcpt.scenes import cornell_box

    assert jax.default_backend() != "gpu"
    assert runtime.pallas_interpret(True) is True
    loaded, camcfg = cornell_box()
    scene, lights = build_scene(loaded)
    mega = mk.build_megascene(scene, lights)
    with pytest.raises(RuntimeError, match="compile only for the GPU"):
        mk.render_mega(mega, cm.make_camera(camcfg), 8, 8, spp=1, seed=0)
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()
