"""Integrator physics tests against closed-form oracles + estimator consistency.

These are the golden tests the reference never had (SURVEY §4): the furnace
identity validates the full pipeline analytically, and the plain-BSDF / NEE /
NEE+MIS estimators must agree on the same transport integral.
"""

import jax
import numpy as np
import pytest

from mcpt.render import camera as cm
from mcpt.render import integrator as integ
from mcpt.render.integrator import RenderOptions
from mcpt.scene import build_scene
from mcpt.scenes import cornell_box, furnace_sphere, quad_light_plane


@pytest.fixture(scope="module")
def furnace():
    loaded, camcfg = furnace_sphere(albedo=0.5, emission=1.0, subdiv=2)
    scene, lights = build_scene(loaded)
    return scene, lights, cm.make_camera(camcfg)


@pytest.fixture(scope="module")
def quadlight():
    loaded, camcfg = quad_light_plane()
    scene, lights = build_scene(loaded)
    return scene, lights, cm.make_camera(camcfg)


def _img(scene, lights, cam, res, opts, spp, seed=0):
    fb = integ.render(
        scene, lights, cam, res, res, opts, spp=spp, seed=seed,
        spp_per_step=spp,
    )
    return integ.framebuffer_image(fb, res, res)


def test_furnace_identity(furnace):
    """Convex diffuse body in a uniform emissive enclosure: every camera path
    hitting the body returns exactly albedo·E; background exactly E."""
    scene, lights, cam = furnace
    opts = RenderOptions(max_depth=8, method="bvh")
    img = _img(scene, lights, cam, 32, opts, spp=2)
    center = img[16, 16]
    corner = img[1, 1]
    np.testing.assert_allclose(center, 0.5, atol=1e-5)
    np.testing.assert_allclose(corner, 1.0, atol=1e-5)


def test_furnace_with_nee_rr(furnace):
    """NEE + RR must preserve the furnace identity in expectation."""
    scene, lights, cam = furnace
    opts = RenderOptions(
        max_depth=8, method="bvh", nee=True, mis=True, russian_roulette=True,
        rr_start_depth=2,
    )
    img = _img(scene, lights, cam, 16, opts, spp=64)
    # all pixels view either the sphere (0.5) or background (1.0); the image
    # mean must match the mean of the analytic per-pixel values
    opts_ref = RenderOptions(max_depth=8, method="bvh")
    ref = _img(scene, lights, cam, 16, opts_ref, spp=2)
    assert abs(img.mean() - ref.mean()) < 0.01


def test_resort_preserves_estimator(furnace):
    """Inter-bounce ray re-sorting (Morton/octant lax.sort with dead rays
    keyed last, original order restored after the loop) is a pure pool
    permutation: the furnace identity must hold exactly and pixels must land
    back in their own slots."""
    scene, lights, cam = furnace
    opts = RenderOptions(max_depth=8, method="bvh", resort=True)
    img = _img(scene, lights, cam, 32, opts, spp=2)
    np.testing.assert_allclose(img[16, 16], 0.5, atol=1e-5)
    np.testing.assert_allclose(img[1, 1], 1.0, atol=1e-5)


@pytest.mark.slow
def test_estimator_agreement(quadlight):
    """Plain BSDF sampling at depth d+1 covers the same path space as NEE at
    depth d; all three estimators must agree within MC error."""
    scene, lights, cam = quadlight
    res = 32
    plain = _img(
        scene, lights, cam, res,
        RenderOptions(max_depth=3, method="brute"), spp=512, seed=1,
    )
    nee = _img(
        scene, lights, cam, res,
        RenderOptions(max_depth=2, method="brute", nee=True), spp=64, seed=2,
    )
    mis = _img(
        scene, lights, cam, res,
        RenderOptions(max_depth=2, method="brute", nee=True, mis=True),
        spp=64, seed=3,
    )
    assert abs(plain.mean() - nee.mean()) < 0.01 * max(1.0, plain.mean())
    assert abs(nee.mean() - mis.mean()) < 0.005


def test_depth_cut(quadlight):
    """max_depth=1 sees only direct camera→light hits (shade.cl:199-202
    semantics: the continuation ray of the last bounce is killed)."""
    scene, lights, cam = quadlight
    img = _img(
        scene, lights, cam, 32,
        RenderOptions(max_depth=1, method="brute", jitter=False),
        spp=8, seed=0,
    )
    # pixels seeing the light directly read its emission; nothing else lights up
    vals = np.unique(np.round(img[..., 0], 3))
    assert set(vals).issubset({0.0, 4.0})


@pytest.mark.slow
def test_loop_modes_agree(quadlight):
    """fori / while / unroll lowerings of the bounce loop are the same program."""
    scene, lights, cam = quadlight
    imgs = {}
    for loop in ("fori", "while", "unroll"):
        opts = RenderOptions(max_depth=3, method="brute", nee=True, loop=loop)
        imgs[loop] = _img(scene, lights, cam, 16, opts, spp=4, seed=5)
    np.testing.assert_allclose(imgs["fori"], imgs["while"], atol=1e-6)
    np.testing.assert_allclose(imgs["fori"], imgs["unroll"], atol=1e-6)


def test_render_batch_matches_loop(quadlight):
    """spp-batched rendering must equal the host-loop accumulation in
    expectation and produce the right sample count."""
    scene, lights, cam = quadlight
    opts = RenderOptions(max_depth=2, method="brute", nee=True)
    fb1 = integ.render(scene, lights, cam, 16, 16, opts, spp=8, seed=7,
                       spp_per_step=1)
    fb8 = integ.render(scene, lights, cam, 16, 16, opts, spp=8, seed=7,
                       spp_per_step=8)
    assert float(fb1.count[0]) == 8.0 and float(fb8.count[0]) == 8.0
    # different sample keys → agree statistically, not exactly
    m1 = np.asarray(fb1.mean).mean()
    m8 = np.asarray(fb8.mean).mean()
    assert abs(m1 - m8) < 0.05 * max(m1, 1e-3)


def test_checkpoint_resume(quadlight):
    """Accumulation is resumable: render(4)+render(4 more) ≡ render(8)."""
    scene, lights, cam = quadlight
    opts = RenderOptions(max_depth=2, method="brute")
    fb_a = integ.render(scene, lights, cam, 16, 16, opts, spp=4, seed=11)
    fb_ab = integ.render(scene, lights, cam, 16, 16, opts, spp=4, seed=11,
                         fb=fb_a)
    fb_full = integ.render(scene, lights, cam, 16, 16, opts, spp=8, seed=11)
    np.testing.assert_allclose(
        np.asarray(fb_ab.sum), np.asarray(fb_full.sum), rtol=1e-5, atol=1e-6
    )


def test_boxfield_large_scene():
    """Large-BVH wavefront path end-to-end (the diningroom-class stand-in)."""
    from mcpt.scenes import boxfield

    loaded, camcfg = boxfield(400, seed=1)
    scene, lights = build_scene(loaded)
    assert scene.n_tris > 4000
    import dataclasses

    camcfg = dataclasses.replace(camcfg, resolution=(24, 16))
    cam = cm.make_camera(camcfg)
    opts = RenderOptions(max_depth=3, method="bvh", nee=True, mis=True)
    rad = integ.render_sample(scene, lights, cam, 24, 16, jax.random.key(0),
                              opts)
    img = np.asarray(rad).reshape(16, 24, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01  # lit by the sky quad
    # BVH path must agree with brute force on this scene
    opts_b = RenderOptions(max_depth=3, method="brute", nee=True, mis=True)
    rad_b = integ.render_sample(scene, lights, cam, 24, 16, jax.random.key(0),
                                opts_b)
    np.testing.assert_allclose(np.asarray(rad), np.asarray(rad_b),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.slow
def test_boxfield_deep_traversal():
    """Deeper BVH + deeper bounces than the toy case: 24k tris, depth 8, with
    resort on — BVH path must agree with brute force ray for ray."""
    import dataclasses

    from mcpt.scenes import boxfield

    loaded, camcfg = boxfield(2000, seed=3)
    scene, lights = build_scene(loaded)
    assert scene.n_tris > 20000
    camcfg = dataclasses.replace(camcfg, resolution=(16, 12))
    cam = cm.make_camera(camcfg)
    opts = RenderOptions(max_depth=8, method="bvh", nee=True, mis=True,
                         resort=True)
    rad = integ.render_sample(scene, lights, cam, 16, 12, jax.random.key(2),
                              opts)
    img = np.asarray(rad).reshape(12, 16, 3)
    assert np.isfinite(img).all() and img.mean() > 0.01
    # brute agreement is exact only without resort (resort re-assigns the
    # positional RNG draws); check the no-resort BVH path exactly and the
    # resorted one statistically
    opts_nr = opts._replace(resort=False)
    rad_nr = integ.render_sample(scene, lights, cam, 16, 12, jax.random.key(2),
                                 opts_nr)
    opts_b = opts_nr._replace(method="brute")
    rad_b = integ.render_sample(scene, lights, cam, 16, 12, jax.random.key(2),
                                opts_b)
    np.testing.assert_allclose(np.asarray(rad_nr), np.asarray(rad_b),
                               rtol=1e-3, atol=1e-4)
    assert abs(img.mean() - np.asarray(rad_b).mean()) < 0.35 * img.mean()


def test_diningroom_scene():
    """The procedural dining-room interior (the reference's third workload
    stand-in): builds at full scale, and a tiny-tessellation variant renders
    through the BVH path in agreement with brute force, with interior GI
    actually transporting light (no black image, lamps visible)."""
    import dataclasses

    from mcpt.scenes import diningroom

    loaded, _ = diningroom()
    assert loaded.verts.shape[0] > 80000  # ~100k-tri default build
    loaded, camcfg = diningroom(tess=4)
    scene, lights = build_scene(loaded)
    assert int(lights.count) == 4  # two ceiling panels, 2 tris each
    w, h = 16, 9
    camcfg = dataclasses.replace(camcfg, resolution=(w, h))
    cam = cm.make_camera(camcfg)
    opts = RenderOptions(max_depth=4, method="bvh", nee=True, mis=True)
    rad = integ.render_sample(scene, lights, cam, w, h, jax.random.key(1),
                              opts)
    img = np.asarray(rad).reshape(h, w, 3)
    assert np.isfinite(img).all() and img.mean() > 0.02
    rad_b = integ.render_sample(scene, lights, cam, w, h, jax.random.key(1),
                                opts._replace(method="brute"))
    np.testing.assert_allclose(np.asarray(rad), np.asarray(rad_b),
                               rtol=1e-3, atol=1e-4)


def test_cornell_box_sanity():
    loaded, camcfg = cornell_box()
    scene, lights = build_scene(loaded)
    import dataclasses

    camcfg = dataclasses.replace(camcfg, resolution=(32, 32))
    cam = cm.make_camera(camcfg)
    opts = RenderOptions(max_depth=4, method="brute", nee=True, mis=True)
    img = _img(scene, lights, cam, 32, opts, spp=8)
    assert img.mean() > 0.05  # lit
    mid = 16
    # red wall on screen-left, blue on screen-right (reference orientation)
    left = img[mid, 2]
    right = img[mid, 29]
    assert left[0] > 2 * left[2], left
    assert right[2] > 2 * right[0], right


def test_ortho_furnace_identity():
    """Orthographic camera through the furnace: parallel rays through the body
    still see exactly albedo·E (center) and E (background) — validates the
    ortho origin-sweep path end-to-end (reference cameraType 1)."""
    import dataclasses

    from mcpt.scenes import furnace_sphere

    loaded, camcfg = furnace_sphere(albedo=0.5, emission=1.0, subdiv=2)
    camcfg = dataclasses.replace(
        camcfg, fov=0.0, ortho_height=4.0, resolution=(32, 32)
    )
    scene, lights = build_scene(loaded)
    cam = cm.make_camera(camcfg)
    opts = RenderOptions(max_depth=8, method="bvh")
    img = _img(scene, lights, cam, 32, opts, spp=2)
    np.testing.assert_allclose(img[16, 16], 0.5, atol=1e-5)
    np.testing.assert_allclose(img[1, 1], 1.0, atol=1e-5)


@pytest.mark.parametrize("coarse_bits", [3, 6, 9])
def test_sort_key_dead_last_nonnegative(coarse_bits):
    """The resort key is a non-negative int32 (a negative key would sort
    first), dead rays get the 0x7FFFFFFF sentinel above every live key, and
    the resort moves them to the end of the pool."""
    import jax.numpy as jnp

    from mcpt.types import RayPool

    rng = np.random.default_rng(coarse_bits)
    n = 512
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.uniform(size=n) > 0.3
    pool = RayPool(
        origin=jnp.asarray(rng.uniform(-5, 5, (n, 3)).astype(np.float32)),
        direction=jnp.asarray(d),
        throughput=jnp.ones((n, 3), jnp.float32),
        radiance=jnp.zeros((n, 3), jnp.float32),
        pixel=jnp.arange(n, dtype=jnp.int32),
        alive=jnp.asarray(alive),
        inside=jnp.zeros((n,), bool),
    )
    lo, inv = jnp.full(3, -5.0), jnp.full(3, 0.1)
    key = np.asarray(integ._sort_key(pool, lo, inv, coarse_bits))
    assert key.dtype == np.int32 and (key >= 0).all()
    assert (key[~alive] == 0x7FFFFFFF).all()
    assert (key[alive] < 0x7FFFFFFF).all()
    sorted_pool, *_ = integ._resort_pool(
        pool, jnp.zeros(n, bool), jnp.zeros(n), jnp.arange(n), lo, inv,
        coarse_bits)
    s_alive = np.asarray(sorted_pool.alive)
    n_live = int(alive.sum())
    assert s_alive[:n_live].all() and not s_alive[n_live:].any()
