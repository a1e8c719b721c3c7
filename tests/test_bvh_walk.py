"""The XLA BVH walk (``traverse.intersect_bvh`` / ``occluded``) against brute
force on a procedural large-scene stand-in (``boxfield``): the large-scene
intersector of the wavefront engine."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcpt.render import camera as cm
from mcpt.render import integrator as integ
from mcpt.render import traverse
from mcpt.scene import build_scene
from mcpt.scenes import boxfield


@pytest.fixture(scope="module")
def field():
    loaded, camcfg = boxfield(60, seed=2)
    scene, lights = build_scene(loaded)
    assert scene.n_tris > 512  # "auto" resolves to the BVH walk
    rng = np.random.default_rng(0)
    # rays from above the field toward it, plus grazing ones between boxes
    o = np.concatenate([
        rng.uniform([-100, 5, -100], [100, 40, 100], (384, 3)),
        rng.uniform([-100, 0.2, -100], [100, 2, 100], (128, 3)),
    ]).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d[:384, 1] = -np.abs(d[:384, 1])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return scene, lights, camcfg, jnp.asarray(o), jnp.asarray(d)


def test_intersect_bvh_matches_brute_boxfield(field):
    scene, _, _, o, d = field
    assert traverse.resolve_method(scene) == "bvh"
    hv = traverse.intersect_bvh(scene.bvh, scene.geom, o, d)
    hb = traverse.intersect_brute(scene.geom, o, d)
    tv, tb = np.asarray(hv.t), np.asarray(hb.t)
    assert ((np.asarray(hv.tri) >= 0) == (np.asarray(hb.tri) >= 0)).all()
    hit = np.isfinite(tb)
    assert hit.mean() > 0.3
    np.testing.assert_allclose(tv[hit], tb[hit], rtol=1e-4, atol=1e-4)


def test_occluded_matches_brute_boxfield(field):
    scene, _, _, o, d = field
    t_max = jnp.full((o.shape[0],), 30.0, jnp.float32)
    ob = np.asarray(traverse.occluded(scene, o, d, t_max, method="bvh"))
    obr = np.asarray(traverse.occluded(scene, o, d, t_max, method="brute"))
    np.testing.assert_array_equal(ob, obr)
    assert 0.0 < ob.mean() < 1.0


def test_active_mask_bvh_boxfield(field):
    """Inactive rays report no hit; active ones are unaffected by the mask."""
    scene, _, _, o, d = field
    active = jnp.asarray(np.arange(o.shape[0]) % 3 == 0)
    full = traverse.intersect_bvh(scene.bvh, scene.geom, o, d)
    part = traverse.intersect_bvh(scene.bvh, scene.geom, o, d, active=active)
    a = np.asarray(active)
    assert (np.asarray(part.tri)[~a] == -1).all()
    np.testing.assert_array_equal(np.asarray(part.tri)[a],
                                  np.asarray(full.tri)[a])


def test_render_batch_bvh_matches_brute_boxfield(field):
    """Same RNG keys, same pool order: the two intersectors give the same
    render up to f32 round-off."""
    scene, lights, camcfg, _, _ = field
    w, h = 16, 12
    cam = cm.make_camera(dataclasses.replace(camcfg, resolution=(w, h)))
    opts = integ.RenderOptions(max_depth=3, nee=True, mis=True, method="bvh")
    rad = integ.render_batch(scene, lights, cam, w, h, jax.random.key(3),
                             opts, spp=2)
    rad_b = integ.render_batch(scene, lights, cam, w, h, jax.random.key(3),
                               opts._replace(method="brute"), spp=2)
    assert np.asarray(rad).mean() > 0.0
    np.testing.assert_allclose(np.asarray(rad), np.asarray(rad_b),
                               rtol=1e-3, atol=1e-4)
