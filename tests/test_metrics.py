"""BVH quality metrics + treelet optimizer tests (reference C13/C15 semantics)."""

import numpy as np
import pytest

from mcpt.bvh import lbvh, metrics, treelet
from mcpt import types as T
from test_lbvh import random_tris


def _build(verts):
    import jax.numpy as jnp

    return lbvh.build_lbvh(jnp.asarray(verts))


def test_clip_area_full_inside():
    tris = np.array([[[0.1, 0.1, 0.5], [0.9, 0.1, 0.5], [0.1, 0.9, 0.5]]])
    a = metrics._clip_areas(tris, np.zeros((1, 3)), np.ones((1, 3)))
    np.testing.assert_allclose(a, 0.32, rtol=1e-6)


def test_clip_area_half():
    # unit right triangle in z=0.5 plane, box covering x ≤ 0.25 half-space slice
    tris = np.array([[[0.0, 0.0, 0.5], [1.0, 0.0, 0.5], [0.0, 1.0, 0.5]]])
    bbmin = np.array([[0.0, 0.0, 0.0]])
    bbmax = np.array([[0.25, 1.0, 1.0]])
    a = metrics._clip_areas(tris, bbmin, bbmax)
    # trapezoid: ∫0^.25 (1-x) dx = 0.25 - 0.03125
    np.testing.assert_allclose(a, 0.25 - 0.03125, rtol=1e-6)


def test_clip_area_disjoint():
    tris = np.array([[[0.0, 0.0, 0.5], [1.0, 0.0, 0.5], [0.0, 1.0, 0.5]]])
    a = metrics._clip_areas(tris, np.full((1, 3), 2.0), np.full((1, 3), 3.0))
    assert a[0] == 0.0


def test_sah_positive_and_scalefree():
    verts = random_tris(64, seed=1)
    bvh = _build(verts)
    s1 = metrics.sah(bvh)
    s2 = metrics.sah(_build(verts * 10.0))
    assert s1 > 1.0
    assert abs(s1 - s2) < 1e-3 * s1  # SAH is scale-invariant


def test_epo_zero_for_separated_scene():
    # triangles spread far apart along x: sibling boxes never overlap
    base = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    verts = np.concatenate([base + np.array([i * 100.0, 0, 0]) for i in range(16)])
    bvh = _build(verts)
    assert metrics.epo(bvh, verts) == pytest.approx(0.0, abs=1e-9)


def test_epo_positive_for_overlapping_scene():
    verts = random_tris(64, seed=3, scale=1.0)  # heavily overlapping boxes
    bvh = _build(verts)
    e = metrics.epo(bvh, verts)
    assert e > 0.0


def test_lcv_runs():
    from mcpt.config import CameraConfig
    from mcpt.render import camera as cm

    verts = random_tris(128, seed=5)
    bvh = _build(verts)
    cam = cm.make_camera(
        CameraConfig(position=(0, 0, 40), lookat=(0, 0, 0), up=(0, 1, 0),
                     fov=45, resolution=(32, 32))
    )
    v = metrics.lcv(bvh, cam, 32, 32)
    assert v >= 0.0 and np.isfinite(v)


@pytest.mark.parametrize("n", [16, 100, 333])
def test_treelet_improves_sah_and_stays_valid(n):
    verts = random_tris(n, seed=n, scale=3.0)
    bvh = _build(verts)
    s0 = metrics.sah(bvh)
    opt = treelet.optimize_treelets(bvh)
    s1 = metrics.sah(opt)
    assert s1 <= s0 + 1e-4, (s0, s1)
    res = lbvh.validate_bvh(opt, verts)
    assert res["ok"], res["errors"][:5]


def test_treelet_same_hits():
    """Restructuring must not change closest-hit results."""
    import jax.numpy as jnp

    from mcpt.render import traverse

    verts = random_tris(80, seed=11)
    geom = T.geometry_from_verts(verts, np.zeros(80, np.int32))
    bvh = _build(verts)
    opt = treelet.optimize_treelets(bvh)
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(-12, 12, (128, 3)).astype(np.float32))
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    h0 = traverse.intersect_bvh(bvh, geom, o, d)
    h1 = traverse.intersect_bvh(opt, geom, o, d)
    np.testing.assert_allclose(
        np.where(np.isfinite(h0.t), h0.t, 0),
        np.where(np.isfinite(h1.t), h1.t, 0),
        rtol=1e-5, atol=1e-6,
    )


def test_epo_native_matches_python():
    """The parallel C++ EPO walk must agree with the numpy reference."""
    import pytest

    from mcpt import native
    from mcpt.bvh import lbvh as lbvh_mod
    from mcpt.bvh.metrics import epo
    from mcpt.scenes import boxfield

    if not native.available():
        pytest.skip("native library unavailable")
    import jax.numpy as jnp

    loaded, _ = boxfield(200)
    bvh = lbvh_mod.build_lbvh(jnp.asarray(loaded.verts))
    e_py = epo(bvh, loaded.verts, use_native="never")
    e_cc = epo(bvh, loaded.verts, use_native="always")
    assert abs(e_py - e_cc) < 1e-6 * max(e_py, 1.0)


def test_epo_jitted_walk_matches_bruteforce():
    """The jitted EPO walk (``use_native="never"``; ``device`` picks its JAX
    platform, the CPU here) against a direct sum over every (leaf,
    non-ancestor node) pair, ancestors found by walking parent links."""
    verts = random_tris(24, seed=5, scale=2.0)
    bvh = _build(verts)
    left = np.asarray(bvh.left)
    parent = np.asarray(bvh.parent)
    bbmin, bbmax = np.asarray(bvh.bbmin), np.asarray(bvh.bbmax)
    n = verts.shape[0]
    leaf_base = n - 1
    tris, nodes = [], []
    for leaf in range(leaf_base, 2 * n - 1):
        anc, node = set(), leaf
        while node >= 0:
            anc.add(node)
            node = parent[node]
        others = [k for k in range(2 * n - 1) if k not in anc]
        tris += [left[leaf]] * len(others)
        nodes += others
    nodes = np.asarray(nodes)
    areas = metrics._clip_areas(verts[np.asarray(tris)], bbmin[nodes],
                                bbmax[nodes])
    w = np.where(nodes >= leaf_base, metrics.C_TRI, metrics.C_INN)
    ref = float((w * areas).sum()) / float(metrics.tri_area(verts).sum())
    e = metrics.epo(bvh, verts, use_native="never", device="cpu")
    assert ref > 0.0
    assert e == pytest.approx(ref, rel=1e-6)
