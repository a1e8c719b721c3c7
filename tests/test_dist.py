"""Multi-device sharded rendering on the virtual 8-CPU mesh (SURVEY §4: test
multi-node without a cluster).  The sharded result must agree with single-device
rendering in expectation, and the furnace identity must hold exactly per shard."""

import jax
import numpy as np
import pytest

from mcpt import dist
from mcpt.render import camera as cm
from mcpt.render import integrator as integ
from mcpt.render.integrator import RenderOptions
from mcpt.scene import build_scene
from mcpt.scenes import furnace_sphere, quad_light_plane


@pytest.fixture(scope="module")
def furnace():
    loaded, camcfg = furnace_sphere(albedo=0.5, emission=1.0, subdiv=2)
    scene, lights = build_scene(loaded)
    return scene, lights, cm.make_camera(camcfg)


def test_devices_available():
    assert len(jax.devices()) == 8, jax.devices()


@pytest.mark.parametrize("shape", [(1, 8), (8, 1), (2, 4), (4, 2)])
def test_mesh_shapes(shape):
    mesh = dist.make_mesh(samples=shape[0], pixels=shape[1])
    assert mesh.shape == {"samples": shape[0], "pixels": shape[1]}


def test_furnace_sharded_exact(furnace):
    """The zero-variance furnace scene must give the exact analytic answer
    through the full sharded path (psum over samples, pixel slicing)."""
    scene, lights, cam = furnace
    mesh = dist.make_mesh(samples=2, pixels=4)
    opts = RenderOptions(max_depth=8, method="bvh")
    w = h = 20  # 400 pixels: not divisible by 4 → exercises padding
    rad = dist.render_batch_sharded(
        scene, lights, cam, w, h, jax.random.key(0), opts, spp=4, mesh=mesh
    )
    img = np.asarray(rad).reshape(h, w, 3) / 4.0
    np.testing.assert_allclose(img[h // 2, w // 2], 0.5, atol=1e-5)
    np.testing.assert_allclose(img[1, 1], 1.0, atol=1e-5)


def test_sharded_matches_single_device():
    loaded, camcfg = quad_light_plane()
    scene, lights = build_scene(loaded)
    cam = cm.make_camera(camcfg)
    opts = RenderOptions(max_depth=3, method="brute", nee=True, mis=True)
    w = h = 24
    spp = 32
    mesh = dist.make_mesh(samples=4, pixels=2)
    fb_sh = dist.render_sharded(
        scene, lights, cam, w, h, opts, spp=spp, mesh=mesh, seed=0,
        spp_per_step=spp,
    )
    fb_1 = integ.render(
        scene, lights, cam, w, h, opts, spp=spp, seed=1, spp_per_step=spp
    )
    m_sh = np.asarray(fb_sh.mean).mean()
    m_1 = np.asarray(fb_1.mean).mean()
    assert float(fb_sh.count[0]) == spp
    assert abs(m_sh - m_1) < 0.05 * max(m_1, 1e-3)


def test_mega_sharded_furnace_exact(furnace):
    """The fused Pallas kernel under shard_map: furnace identity must survive
    sample-axis DP + psum (kernel runs in the Pallas interpreter on the CPU
    mesh),
    and the sharded render must be stream-exact against one device (same
    seed, global sample indices via ``sample_base``) AND invariant to the
    mesh shape — only f32 sum order may differ."""
    from mcpt.pallas import megakernel as mk

    scene, lights, cam = furnace
    mega = mk.build_megascene(scene, lights)
    res = 16

    rad, segs = dist.render_mega_sharded(
        mega, cam, res, res, spp=8, mesh=dist.make_mesh(samples=4, pixels=2),
        seed=0, max_depth=6, interpret=True,
    )
    img = np.asarray(rad).reshape(res, res, 3) / 8
    np.testing.assert_allclose(img[res // 2, res // 2], 0.5, atol=1e-5)
    np.testing.assert_allclose(img[0, 0], 1.0, atol=1e-5)
    assert float(segs) > 0.0

    # stream-exact vs one device (same seed, same (sample, pixel) streams)
    rad_1, segs_1 = mk.render_mega(
        mega, cam, res, res, spp=8, seed=0, max_depth=6, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(rad), np.asarray(rad_1),
                               rtol=1e-5, atol=1e-6)
    assert float(segs) == float(segs_1)

    # mesh-shape invariance: 8×1 (pure sample DP) ≡ 2×4
    rad_b, _ = dist.render_mega_sharded(
        mega, cam, res, res, spp=8, mesh=dist.make_mesh(samples=8, pixels=1),
        seed=0, max_depth=6, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(rad), np.asarray(rad_b),
                               rtol=1e-5, atol=1e-6)


def test_sharded_deterministic(furnace):
    scene, lights, cam = furnace
    mesh = dist.make_mesh(samples=2, pixels=4)
    opts = RenderOptions(max_depth=4, method="bvh")
    a = dist.render_batch_sharded(
        scene, lights, cam, 16, 16, jax.random.key(3), opts, spp=2, mesh=mesh
    )
    b = dist.render_batch_sharded(
        scene, lights, cam, 16, 16, jax.random.key(3), opts, spp=2, mesh=mesh
    )
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
