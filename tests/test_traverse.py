"""Traversal correctness: Möller–Trumbore unit cases + BVH ≡ brute force."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcpt.bvh import lbvh
from mcpt.render import traverse
from mcpt.types import Geometry, Scene
from mcpt import types as T
from test_lbvh import random_tris


def test_moller_trumbore_basic():
    v0 = jnp.array([0.0, 0, 0])
    v1 = jnp.array([1.0, 0, 0])
    v2 = jnp.array([0.0, 1, 0])
    o = jnp.array([0.2, 0.2, -1.0])
    d = jnp.array([0.0, 0, 1.0])
    t, hit = traverse.moller_trumbore(o, d, v0, v1, v2)
    assert bool(hit) and float(t) == pytest.approx(1.0)
    # outside barycentric range
    o2 = jnp.array([0.9, 0.9, -1.0])
    t2, hit2 = traverse.moller_trumbore(o2, d, v0, v1, v2)
    assert not bool(hit2) and np.isinf(float(t2))
    # backface is accepted (reference semantics, objdef.h:178-221)
    o3 = jnp.array([0.2, 0.2, 1.0])
    t3, hit3 = traverse.moller_trumbore(o3, -d, v0, v1, v2)
    assert bool(hit3)
    # parallel ray misses
    t4, hit4 = traverse.moller_trumbore(
        jnp.array([0.0, 0, 1.0]), jnp.array([1.0, 0, 0]), v0, v1, v2
    )
    assert not bool(hit4)


def _rand_rays(r, seed, scale=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-scale, scale, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("n,r", [(33, 256), (500, 128)])
def test_bvh_matches_brute(n, r):
    verts = random_tris(n, seed=n)
    geom = T.geometry_from_verts(verts, np.zeros(n, np.int32))
    bvh = lbvh.build_lbvh(geom.verts)
    o, d = _rand_rays(r, seed=r)
    hb = traverse.intersect_brute(geom, o, d)
    hv = traverse.intersect_bvh(bvh, geom, o, d)
    tb, tv = np.asarray(hb.t), np.asarray(hv.t)
    ib, iv = np.asarray(hb.tri), np.asarray(hv.tri)
    # identical triangle unless two hits are within float noise of each other
    close = np.isclose(
        np.where(np.isfinite(tb), tb, 0), np.where(np.isfinite(tv), tv, 0),
        rtol=1e-4, atol=1e-5,
    )
    assert close.all(), f"t mismatch on {np.count_nonzero(~close)} rays"
    same_hitness = (ib >= 0) == (iv >= 0)
    assert same_hitness.all()


@pytest.mark.parametrize("n,r", [(36, 512), (700, 128)])
def test_wald_matches_brute(n, r):
    """The precomputed-transform intersector is the same hit function as
    Möller–Trumbore up to float rounding (incl. multi-chunk scan path)."""
    from mcpt.scene import build_wald

    verts = random_tris(n, seed=n + 1)
    geom = T.geometry_from_verts(verts, np.zeros(n, np.int32))
    wald = build_wald(verts)
    o, d = _rand_rays(r, seed=r + 3)
    hb = traverse.intersect_brute(geom, o, d)
    hw = traverse.intersect_wald(wald, geom, o, d, chunk=512)
    tb, tw = np.asarray(hb.t), np.asarray(hw.t)
    close = np.isclose(
        np.where(np.isfinite(tb), tb, 0), np.where(np.isfinite(tw), tw, 0),
        rtol=1e-3, atol=1e-4,
    )
    assert close.all(), f"t mismatch on {np.count_nonzero(~close)} rays"
    assert ((np.asarray(hb.tri) >= 0) == (np.asarray(hw.tri) >= 0)).all()


def test_wald_degenerate_triangle():
    from mcpt.scene import build_wald

    verts = np.zeros((2, 3, 3), np.float32)
    verts[0] = [[0, 0, 1], [1, 0, 1], [0, 1, 1]]
    verts[1] = [[5, 5, 5], [5, 5, 5], [5, 5, 5]]  # degenerate
    geom = T.geometry_from_verts(verts, np.zeros(2, np.int32))
    wald = build_wald(verts)
    o = jnp.array([[0.2, 0.2, 0.0], [5.0, 5.0, 0.0]])
    d = jnp.array([[0.0, 0, 1.0], [0.0, 0, 1.0]])
    h = traverse.intersect_wald(wald, geom, o, d)
    assert int(h.tri[0]) == 0 and float(h.t[0]) == pytest.approx(1.0)
    assert int(h.tri[1]) == -1  # degenerate triangle never hits


def test_active_mask_skips_rays():
    n = 20
    verts = random_tris(n, seed=1)
    geom = T.geometry_from_verts(verts, np.zeros(n, np.int32))
    bvh = lbvh.build_lbvh(geom.verts)
    o, d = _rand_rays(64, seed=9)
    active = jnp.zeros((64,), bool)
    h = traverse.intersect_bvh(bvh, geom, o, d, active=active)
    assert (np.asarray(h.tri) == -1).all()


def test_occluded():
    # a single wall between origin and target
    verts = np.array(
        [[[-5, -5, 1], [5, -5, 1], [5, 5, 1]], [[-5, -5, 1], [5, 5, 1], [-5, 5, 1]]],
        np.float32,
    )
    geom = T.geometry_from_verts(verts, np.zeros(2, np.int32))
    bvh = lbvh.build_lbvh(geom.verts)
    from mcpt.scene import Lights
    from mcpt.types import Materials

    mats = T.materials_from_numpy([1], [[0.5] * 3], [[0] * 3], [[0] * 3], [0], [1])
    scene = Scene(geom=geom, materials=mats, bvh=bvh, eps=jnp.float32(1e-4))
    o = jnp.array([[0.0, 0, 0], [0.0, 0, 0], [8.0, 0, 0]])
    d = jnp.array([[0.0, 0, 1.0], [0.0, 0, -1.0], [0.0, 0, 1.0]])
    t_max = jnp.array([5.0, 5.0, 5.0])
    occ = np.asarray(traverse.occluded(scene, o, d, t_max, method="bvh"))
    assert occ.tolist() == [True, False, False]  # wall blocks only ray 0


def test_slab_axis_aligned_ray():
    """Rays with zero direction components must not produce NaN verdicts."""
    n = 10
    verts = random_tris(n, seed=2)
    geom = T.geometry_from_verts(verts, np.zeros(n, np.int32))
    bvh = lbvh.build_lbvh(geom.verts)
    o = jnp.array([[0.0, 0, -100.0]] * 4)
    d = jnp.array([[0.0, 0, 1.0], [0.0, 1.0, 0], [1.0, 0, 0], [0.0, 0, -1.0]])
    hv = traverse.intersect_bvh(bvh, geom, o, d)
    hb = traverse.intersect_brute(geom, o, d)
    assert ((np.asarray(hv.tri) >= 0) == (np.asarray(hb.tri) >= 0)).all()
