"""Card-only tests: the Triton megakernel compiled for the GPU, at the block
width it runs with, against the XLA wavefront reference and the furnace
oracle.  They skip without a GPU; run them with ``pytest -m gpu``.

Tolerances: the furnace identity is exact in f32 (1e-5).  The cross-engine
checks compare image means of two independent estimators (different RNG,
intersector and code path) at 1024 spp: the mean's own noise is ~0.1% on
cbox, so 1% (docs/VALIDATION.md §2b) bounds any bias; veach's glossy
highlights make it noisier, hence 2%.  Sums on the card run in another order
than on the CPU (atomics in the wavefront's scatter-add), so nothing here is
bit-exact.
"""

import dataclasses

import numpy as np
import pytest

from mcpt.pallas import megakernel as mk
from mcpt.render import camera as cm
from mcpt.render import integrator as integ
from mcpt.scene import build_scene
from mcpt import scenes

pytestmark = pytest.mark.gpu


def _setup(name, w, h, **kw):
    loaded, camcfg = getattr(scenes, name)(**kw)
    scene, lights = build_scene(loaded)
    cam = cm.make_camera(dataclasses.replace(camcfg, resolution=(w, h)))
    return scene, lights, cam


def test_compiled_megakernel_furnace_exact(gpu):
    scene, lights, cam = _setup("furnace_sphere", 128, 128)
    mega = mk.build_megascene(scene, lights)
    assert mega.n_tris > mk.CULL_MIN_TRIS  # the chunk-culled tier
    rad, segs = mk.render_mega(mega, cam, 128, 128, spp=8, seed=0,
                               max_depth=8)
    img = np.asarray(rad).reshape(128, 128, 3) / 8
    np.testing.assert_allclose(img[64, 64], 0.5, atol=1e-5)
    np.testing.assert_allclose(img[1, 1], 1.0, atol=1e-5)
    assert float(segs) > 0


@pytest.mark.parametrize("name,w,h,depth,nee,tol", [
    ("cornell_box", 128, 128, 16, False, 0.01),
    ("cornell_box", 128, 128, 16, True, 0.01),
    ("veach_mis", 192, 128, 8, True, 0.02),
])
def test_compiled_megakernel_matches_wavefront(gpu, name, w, h, depth, nee,
                                               tol):
    scene, lights, cam = _setup(name, w, h)
    mega = mk.build_megascene(scene, lights)
    spp = 1024
    rad, _ = mk.render_mega(mega, cam, w, h, spp=spp, seed=3,
                            max_depth=depth, nee=nee, mis=nee)
    m_mega = float(np.asarray(rad).mean()) / spp
    opts = integ.RenderOptions(max_depth=depth, nee=nee, mis=nee,
                               method="brute")
    fb = integ.render(scene, lights, cam, w, h, opts, spp=spp, seed=4,
                      spp_per_step=64)
    m_wave = float(np.asarray(fb.mean).mean())
    assert abs(m_mega - m_wave) <= tol * m_wave, (m_mega, m_wave)


def test_compiled_megakernel_schedules_agree(gpu):
    """regen and batch share RNG streams; compiled, they agree to f32
    round-off (the two loop forms order the NEE arithmetic differently)."""
    scene, lights, cam = _setup("cornell_box", 256, 256)
    mega = mk.build_megascene(scene, lights)
    kw = dict(spp=4, seed=9, max_depth=8, nee=True, mis=True)
    r_b, s_b = mk.render_mega(mega, cam, 256, 256, schedule="batch", **kw)
    r_r, s_r = mk.render_mega(mega, cam, 256, 256, schedule="regen", **kw)
    r_b, r_r = np.asarray(r_b), np.asarray(r_r)
    # a lane whose path flips on a last-bit difference changes its pixel
    # wholesale; allow that in a handful of pixels, not in the image
    bad = ~np.isclose(r_b, r_r, rtol=1e-4, atol=1e-4)
    assert bad.any(axis=-1).mean() < 1e-3
    assert abs(r_b.mean() - r_r.mean()) <= 1e-3 * r_b.mean()
