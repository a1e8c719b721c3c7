"""Device-resident LBVH builder (Morton + Karras-2012 parallel topology).

The reference builds its HLBVH on the host CPU (``BVH/hlbvh.cpp:92-200``): PBRT-style
radix sort (``:27-63``) and a *sequential work-queue* construction of the Karras
topology (``:165-188``).  Here the whole build runs on-device inside one jit:

- 10-bit centroid quantization → 30-bit Morton codes — same math as
  ``hlbvh.cpp:118-136`` (×1024 quantization, 3-way bit expansion);
- ``jnp.argsort`` replaces the radix sort;
- the topology uses Karras's *parallel* per-node formulation (each internal node
  finds its range/split independently, O(N) total) instead of the reference's CPU
  queue — duplicate Morton codes are tie-broken by concatenating the sorted
  position as low-order key bits, so prefix deltas are over (morton, position)
  64-bit keys evaluated with ``lax.clz`` on two int32 words;
- AABB refit replaces the reference's recursion (``hlbvh.cpp:64-76``) with a
  fixed-depth bottom-up sweep (radix-trie depth over 62-bit keys ≤ 62 levels).

Output layout follows the reference contract exactly (``hlbvh.cpp:164-193``):
``2N-1`` nodes, internals ``[0, N-2]``, leaves ``[N-1, 2N-2]``, root 0, leaf
``left == right == triangle id``, parent of root = -1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mcpt.types import BVH

_MAX_PASSES = 64  # ≥ radix-trie depth over (30-bit morton, 32-bit position) keys


def expand_bits_10(v):
    """Spread the low 10 bits of v to every 3rd bit (``hlbvh.cpp:12-20`` math)."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton30(centroids_unit):
    """(N, 3) coordinates in [0, 1) → 30-bit Morton codes (``hlbvh.cpp:118-136``)."""
    q = jnp.clip((centroids_unit * 1024.0), 0.0, 1023.0).astype(jnp.uint32)
    return (
        (expand_bits_10(q[:, 0]) << 2)
        | (expand_bits_10(q[:, 1]) << 1)
        | expand_bits_10(q[:, 2])
    ).astype(jnp.int32)


def _delta_fn(hi, lo, n):
    """δ(i, j) = common-prefix length of 64-bit keys (hi‖lo); -1 out of range."""

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        js = jnp.clip(j, 0, n - 1)
        hx = jnp.bitwise_xor(hi[i], hi[js])
        lx = jnp.bitwise_xor(lo[i], lo[js])
        d = jnp.where(
            hx != 0,
            jax.lax.clz(hx),
            32 + jnp.where(lx != 0, jax.lax.clz(lx), 32),
        )
        return jnp.where(valid, d, -1)

    return delta


@jax.jit
def build_lbvh(verts: jnp.ndarray) -> BVH:
    """verts (N, 3, 3) → flattened BVH (layout contract in module docstring)."""
    return build_lbvh_boxes(jnp.min(verts, axis=1), jnp.max(verts, axis=1))


@jax.jit
def build_lbvh_boxes(tri_min: jnp.ndarray, tri_max: jnp.ndarray) -> BVH:
    """Karras LBVH over N arbitrary AABBs (leaves may be triangles, clusters,
    or whole instances — the builder only sees boxes).  Same layout contract as
    ``build_lbvh``; leaf ``left == right`` = input box index."""
    n = tri_min.shape[0]
    if n == 1:
        return BVH(
            bbmin=tri_min[:1],
            bbmax=tri_max[:1],
            left=jnp.zeros((1,), jnp.int32),
            right=jnp.zeros((1,), jnp.int32),
            parent=jnp.full((1,), -1, jnp.int32),
        )

    centroid = 0.5 * (tri_min + tri_max)
    cmin = jnp.min(centroid, axis=0)
    cmax = jnp.max(centroid, axis=0)
    extent = jnp.maximum(cmax - cmin, 1e-20)
    codes = morton30((centroid - cmin) / extent)

    order = jnp.argsort(codes, stable=True).astype(jnp.int32)  # sorted tri ids
    hi = codes[order]
    lo = jnp.arange(n, dtype=jnp.int32)  # sorted position as unique tiebreak
    delta = _delta_fn(hi, lo, n)

    i = jnp.arange(n - 1, dtype=jnp.int32)

    # --- Karras range + split, vectorized over all internal nodes ---
    d = jnp.where(delta(i, i + 1) >= delta(i, i - 1), 1, -1).astype(jnp.int32)
    delta_min = delta(i, i - d)

    # upper bound by doubling (with a per-lane stop flag)
    lmax = jnp.full((n - 1,), 2, jnp.int32)
    n_doubling = max(2, (n - 1).bit_length() + 1)

    def dbl_body(_, lmax):
        grow = delta(i, i + lmax * d) > delta_min
        return jnp.where(grow, lmax * 2, lmax)

    # monotone: once δ(i, i+lmax·d) ≤ δmin, larger lmax also fails (prefix length
    # to farther keys can only be ≤), so re-checking per pass is safe.
    lmax = jax.lax.fori_loop(0, n_doubling, dbl_body, lmax)

    # binary search the exact range length l
    def bs_body(s, l):
        t = lmax >> s
        cand = l + t
        ok = (t >= 1) & (delta(i, i + cand * d) > delta_min)
        return jnp.where(ok, cand, l)

    l = jax.lax.fori_loop(1, n_doubling + 1, bs_body, jnp.zeros((n - 1,), jnp.int32))
    j = i + l * d
    delta_node = delta(i, j)

    # split search: largest s with δ(i, i + (s+t)·d) > δ_node
    def split_body(k, s):
        t = (l + (1 << k) - 1) >> k  # ceil(l / 2^k)
        cand = s + t
        ok = (t >= 1) & (delta(i, i + cand * d) > delta_node)
        return jnp.where(ok, cand, s)

    s = jax.lax.fori_loop(
        1, n_doubling + 1, split_body, jnp.zeros((n - 1,), jnp.int32)
    )
    gamma = i + s * d + jnp.minimum(d, 0)

    lo_range = jnp.minimum(i, j)
    hi_range = jnp.maximum(i, j)
    leaf_base = n - 1
    left_child = jnp.where(lo_range == gamma, leaf_base + gamma, gamma)
    right_child = jnp.where(hi_range == gamma + 1, leaf_base + gamma + 1, gamma + 1)

    # --- assemble node arrays ---
    tri_ids = order  # leaf p (node leaf_base+p) holds triangle order[p]
    left = jnp.concatenate([left_child, tri_ids])
    right = jnp.concatenate([right_child, tri_ids])

    parent = jnp.full((2 * n - 1,), -1, jnp.int32)
    parent = parent.at[left_child].set(i)
    parent = parent.at[right_child].set(i)

    # --- bottom-up AABB refit, fixed-depth passes ---
    leaf_min = tri_min[order]
    leaf_max = tri_max[order]
    bbmin = jnp.concatenate([jnp.full((n - 1, 3), jnp.inf, jnp.float32), leaf_min])
    bbmax = jnp.concatenate([jnp.full((n - 1, 3), -jnp.inf, jnp.float32), leaf_max])

    def refit_body(_, bb):
        bbmin, bbmax = bb
        new_min = jnp.minimum(bbmin[left_child], bbmin[right_child])
        new_max = jnp.maximum(bbmax[left_child], bbmax[right_child])
        bbmin = bbmin.at[:leaf_base].set(new_min)
        bbmax = bbmax.at[:leaf_base].set(new_max)
        return bbmin, bbmax

    n_passes = min(_MAX_PASSES, n)
    bbmin, bbmax = jax.lax.fori_loop(0, n_passes, refit_body, (bbmin, bbmax))

    return BVH(bbmin=bbmin, bbmax=bbmax, left=left, right=right, parent=parent)


def validate_bvh(bvh: BVH, verts) -> dict:
    """Host-side structural invariants (used by tests): parent/child consistency,
    leaf coverage (each triangle in exactly one leaf), AABB containment."""
    import numpy as np

    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    parent = np.asarray(bvh.parent)
    bbmin = np.asarray(bvh.bbmin)
    bbmax = np.asarray(bvh.bbmax)
    v = np.asarray(verts)
    n = bvh.n_tris
    errors = []

    if n > 1:
        leaf_tris = left[n - 1 :]
        if not np.array_equal(np.sort(leaf_tris), np.arange(n)):
            errors.append("leaf coverage: not a permutation of triangle ids")
        if not np.array_equal(left[n - 1 :], right[n - 1 :]):
            errors.append("leaf encoding: left != right")
        for k in range(n - 1):
            for c in (left[k], right[k]):
                if parent[c] != k:
                    errors.append(f"parent[{c}] = {parent[c]} != {k}")
                    break
        if parent[0] != -1:
            errors.append("root parent != -1")
        # AABB containment
        for k in range(n - 1):
            for c in (left[k], right[k]):
                if (bbmin[k] > bbmin[c] + 1e-5).any() or (
                    bbmax[k] < bbmax[c] - 1e-5
                ).any():
                    errors.append(f"AABB of node {k} does not contain child {c}")
                    break
        # leaf AABBs contain their triangles
        lt = left[n - 1 :]
        tmin = v[lt].min(axis=1)
        tmax = v[lt].max(axis=1)
        if (np.abs(bbmin[n - 1 :] - tmin) > 1e-5).any() or (
            np.abs(bbmax[n - 1 :] - tmax) > 1e-5
        ).any():
            errors.append("leaf AABB mismatch with triangle bounds")
    return {"ok": not errors, "errors": errors}
