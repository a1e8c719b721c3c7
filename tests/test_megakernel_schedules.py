"""Megakernel lane scheduling on the CPU (Pallas interpreter): block
padding, the pixel/sample slicing hooks the mesh shards use, and the regen ≡
batch schedule contract."""

import dataclasses

import numpy as np
import pytest

from mcpt.pallas import megakernel as mk
from mcpt.render import camera as cm
from mcpt.scene import build_scene
from mcpt import scenes
from mcpt.scenes import cornell_box


def _setup(name, w, h, **kw):
    loaded, camcfg = getattr(scenes, name)(**kw)
    scene, lights = build_scene(loaded)
    cam = cm.make_camera(dataclasses.replace(camcfg, resolution=(w, h)))
    return scene, lights, cam


@pytest.fixture(scope="module")
def cbox_mega():
    loaded, camcfg = cornell_box()
    scene, lights = build_scene(loaded)
    return scene, lights, camcfg, mk.build_megascene(scene, lights)


@pytest.mark.parametrize("n", [mk.BLK - 1, mk.BLK, mk.BLK + 1])
def test_block_padding(cbox_mega, n):
    """Pixel counts around one block: the padded tail lanes must not leak
    into real pixels.  Rendering only the first image row (``pixel_count``)
    must reproduce that row of the whole image exactly (each pixel's RNG
    stream is global), and every value must be finite."""
    scene, lights, camcfg, mega = cbox_mega
    cam = cm.make_camera(dataclasses.replace(camcfg, resolution=(n, 2)))
    kw = dict(spp=3, seed=4, max_depth=3, nee=True, mis=True,
              interpret=True)
    full, _ = mk.render_mega(mega, cam, n, 2, **kw)
    row, _ = mk.render_mega(mega, cam, n, 2, pixel_count=n, **kw)
    full, row = np.asarray(full), np.asarray(row)
    assert full.shape == (2 * n, 3) and row.shape == (n, 3)
    assert np.isfinite(full).all() and full.sum() > 0.0
    np.testing.assert_array_equal(row, full[:n])


def test_pixel_slices_sum_to_whole(cbox_mega):
    """``pixel_base``/``pixel_count`` slices (the pixels-axis sharding hook)
    tile the image: their concatenation is the whole render, bit for bit."""
    scene, lights, camcfg, mega = cbox_mega
    w, h = 20, 15
    cam = cm.make_camera(dataclasses.replace(camcfg, resolution=(w, h)))
    kw = dict(spp=4, seed=6, max_depth=4, nee=True, mis=True, rr=True,
              interpret=True)
    full, segs = mk.render_mega(mega, cam, w, h, **kw)
    cuts = [0, 77, 200, w * h]
    parts = [mk.render_mega(mega, cam, w, h, pixel_base=a, pixel_count=b - a,
                            **kw) for a, b in zip(cuts[:-1], cuts[1:])]
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(p[0]) for p in parts]), np.asarray(full))
    assert sum(float(p[1]) for p in parts) == float(segs)


def test_sample_slices_sum_to_whole(cbox_mega):
    """``sample_base`` (the samples-axis sharding hook): samples [0, 2) plus
    samples [2, 6) of the same seed equal the 6-sample render up to f32
    summation order."""
    scene, lights, camcfg, mega = cbox_mega
    w = h = 16
    cam = cm.make_camera(dataclasses.replace(camcfg, resolution=(w, h)))
    kw = dict(seed=8, max_depth=4, nee=True, mis=True, interpret=True)
    full, segs = mk.render_mega(mega, cam, w, h, spp=6, **kw)
    a, sa = mk.render_mega(mega, cam, w, h, spp=2, sample_base=0, **kw)
    b, sb = mk.render_mega(mega, cam, w, h, spp=4, sample_base=2, **kw)
    np.testing.assert_allclose(np.asarray(a) + np.asarray(b),
                               np.asarray(full), rtol=1e-5, atol=1e-6)
    assert float(sa) + float(sb) == float(segs)


def test_regen_matches_batch_furnace():
    """Path regeneration and the batch schedule assign the same RNG stream
    to each (sample, pixel): on the furnace they agree exactly."""
    scene, lights, cam = _setup("furnace_sphere", 12, 12, subdiv=1)
    mega = mk.build_megascene(scene, lights)
    kw = dict(spp=6, seed=2, max_depth=6, interpret=True)
    r_b, s_b = mk.render_mega(mega, cam, 12, 12, schedule="batch", **kw)
    r_r, s_r = mk.render_mega(mega, cam, 12, 12, schedule="regen", **kw)
    np.testing.assert_array_equal(np.asarray(r_b), np.asarray(r_r))
    assert float(s_b) == float(s_r)
