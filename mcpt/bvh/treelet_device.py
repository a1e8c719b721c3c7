"""Device-side treelet SAH restructuring — the ``treeletGPU`` builder (C16).

Data-parallel re-design of the reference's warp-cooperative treelet kernel
(``kernels/treeletBVH.cl:230-531``).  The reference serializes bottom-up via
atomic ready-flags, one warp per treelet, with ``__constant`` popcount tables
driving the subset DP (``treeletBVH.cl:193-228``).  Neither atomics nor
per-warp divergence map to whole-array JAX ops, so the schedule is re-architected as
**level-synchronous batched rounds**:

- internal nodes are grouped by their height in the *initial* tree (equal
  height ⇒ disjoint subtrees ⇒ every treelet in a round is independent — the
  ready-flag ordering without the atomics);
- each round optimizes a fixed-size batch of treelet roots as ONE dense
  tensor program: greedy 7-leaf expansion, subset AABBs by low-bit
  recurrence, the 2^7-subset DP evaluated level-by-popcount with
  precomputed partition index tables (the vectorized analogue of the
  kernel's popcount tables), and an iterative stack-based reconstruction —
  all (batch, ...)-shaped gathers/scatters, no data-dependent control flow;
- batches are padded to a single static size so the whole optimizer is ONE
  XLA compilation reused across every round and scene.

Only full 7-leaf treelets are processed (a root has one exactly when its
subtree holds ≥ 7 leaves — a host-static property, since restructuring never
changes subtree leaf *sets*).  Roots of complete subtrees with < 7 leaves are
skipped; the reference GPU kernel documents unresolved bugs for exactly those
(``treeletBVH.cpp:84``), and the measured SAH gap vs. the any-size CPU
optimizer is small (tests assert the tolerance).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mcpt.bvh.metrics import C_INN, C_TRI
from mcpt.bvh.treelet import MAX_LEAVES, _node_heights
from mcpt.types import BVH

TN = MAX_LEAVES  # 7
FULL = (1 << TN) - 1
BATCH = 1024  # treelet roots per device call (one static compile)


def _dp_tables():
    """Per popcount level k: subsets of size k and their canonical partitions,
    padded to a rectangle (width = 2^(k-1) - 1)."""
    levels = []
    for k in range(2, TN + 1):
        subsets = [s for s in range(1, FULL + 1) if bin(s).count("1") == k]
        width = (1 << (k - 1)) - 1
        ptab = np.zeros((len(subsets), width), np.int32)
        for i, s in enumerate(subsets):
            ps = []
            p = (s - 1) & s
            while p:
                if p < (s ^ p):
                    ps.append(p)
                p = (p - 1) & s
            assert len(ps) == width, (s, len(ps), width)
            ptab[i] = ps
        levels.append((np.asarray(subsets, np.int32), ptab))
    return levels


_LEVELS = _dp_tables()

# low-bit decomposition for the subset-AABB recurrence
_LOWBIT = np.asarray([s & (-s) for s in range(FULL + 1)], np.int32)
_LOWPOS = np.asarray(
    [(s & (-s)).bit_length() - 1 if s else 0 for s in range(FULL + 1)],
    np.int32,
)


@functools.partial(jax.jit, static_argnames=("n_nodes",), donate_argnums=(0, 1, 2, 3, 4, 5))
def _optimize_batch(bbmin, bbmax, left, right, parent, cost, roots, valid,
                    n_nodes):
    """Optimize one batch of 7-leaf treelet roots in place (functionally)."""
    n = (n_nodes + 1) // 2
    leaf_base = n - 1
    r_ = jnp.arange(BATCH)

    def area(bmin, bmax):
        d = jnp.maximum(bmax - bmin, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    # --- greedy expansion to 7 treelet leaves (treeletBVH.cpp:42-91) ---
    leaves = jnp.zeros((BATCH, TN), jnp.int32)
    leaves = leaves.at[:, 0].set(left[roots])
    leaves = leaves.at[:, 1].set(right[roots])
    opened = jnp.zeros((BATCH, TN - 2), jnp.int32)
    for step in range(TN - 2):
        count = 2 + step
        la = area(bbmin[leaves], bbmax[leaves])  # (B, 7)
        cand = (leaves < leaf_base) & (jnp.arange(TN)[None, :] < count)
        la = jnp.where(cand, la, -jnp.inf)
        pick = jnp.argmax(la, axis=1)
        x = leaves[r_, pick]
        opened = opened.at[:, step].set(x)
        leaves = leaves.at[r_, pick].set(left[x])
        leaves = leaves.at[:, count].set(right[x])

    lmin = bbmin[leaves]  # (B, 7, 3)
    lmax = bbmax[leaves]
    lcost = cost[leaves]  # (B, 7)

    # --- subset AABBs + areas, low-bit recurrence (B, 128, 3) ---
    smin = jnp.full((BATCH, FULL + 1, 3), jnp.inf, jnp.float32)
    smax = jnp.full((BATCH, FULL + 1, 3), -jnp.inf, jnp.float32)
    for s in range(1, FULL + 1):
        bit = int(_LOWPOS[s])
        rest = s ^ int(_LOWBIT[s])
        mn = jnp.minimum(smin[:, rest], lmin[:, bit]) if rest else lmin[:, bit]
        mx = jnp.maximum(smax[:, rest], lmax[:, bit]) if rest else lmax[:, bit]
        smin = smin.at[:, s].set(mn)
        smax = smax.at[:, s].set(mx)
    s_area = area(smin, smax)  # (B, 128)

    # --- subset DP in popcount order (treeletBVH.cpp:123-208) ---
    csub = jnp.full((BATCH, FULL + 1), jnp.inf, jnp.float32)
    for i in range(TN):
        csub = csub.at[:, 1 << i].set(lcost[:, i])
    part = jnp.zeros((BATCH, FULL + 1), jnp.int32)
    for subsets, ptab in _LEVELS:
        ss = jnp.asarray(subsets)  # (S,)
        pp = jnp.asarray(ptab)  # (S, W)
        qq = ss[:, None] ^ pp
        cand = csub[:, pp] + csub[:, qq]  # (B, S, W)
        best = jnp.min(cand, axis=2)
        arg = jnp.argmin(cand, axis=2)
        csub = csub.at[:, ss].set(best + C_INN * s_area[:, ss])
        part = part.at[:, ss].set(jnp.take_along_axis(
            pp[None].repeat(BATCH, 0), arg[:, :, None], axis=2
        )[:, :, 0])

    improved = valid & (csub[:, FULL] < cost[roots] - 1e-5)

    # --- reconstruction: iterative subset stack, fixed 6 splits ---
    # node-id pool in pop order: r first (rebuilt root IS r, so ancestors'
    # links/AABBs stay valid), then the opened internals
    pool = jnp.concatenate([roots[:, None], opened], axis=1)  # (B, 6)
    sstack = jnp.zeros((BATCH, TN), jnp.int32).at[:, 0].set(FULL)
    nstack = jnp.zeros((BATCH, TN), jnp.int32).at[:, 0].set(roots)
    sp = jnp.ones((BATCH,), jnp.int32)
    next_pool = jnp.ones((BATCH,), jnp.int32)

    upd_nid = jnp.zeros((BATCH, TN - 1), jnp.int32)
    upd_s = jnp.zeros((BATCH, TN - 1), jnp.int32)
    upd_l = jnp.zeros((BATCH, TN - 1), jnp.int32)
    upd_r = jnp.zeros((BATCH, TN - 1), jnp.int32)

    def bitpos(sub):
        # sub is a power of two ≤ 64: exact in f32
        return jnp.round(jnp.log2(jnp.maximum(sub, 1).astype(jnp.float32))
                         ).astype(jnp.int32)

    for step in range(TN - 1):
        sp = sp - 1
        s = sstack[r_, sp]
        nid = nstack[r_, sp]
        p = part[r_, s]
        q = s ^ p
        children = []
        for sub in (q, p):  # push q first so p (left) pops first, like the CPU
            single = (sub & (sub - 1)) == 0
            leaf_id = leaves[r_, jnp.clip(bitpos(sub), 0, TN - 1)]
            new_nid = pool[r_, jnp.clip(next_pool, 0, TN - 2)]
            child = jnp.where(single, leaf_id, new_nid)
            children.append(child)
            sl = jnp.clip(sp, 0, TN - 1)
            sstack = sstack.at[r_, sl].set(jnp.where(single, sstack[r_, sl],
                                                     sub))
            nstack = nstack.at[r_, sl].set(jnp.where(single, nstack[r_, sl],
                                                     new_nid))
            grow = (~single).astype(jnp.int32)
            sp = sp + grow
            next_pool = next_pool + grow
        ch_q, ch_p = children
        upd_nid = upd_nid.at[:, step].set(nid)
        upd_s = upd_s.at[:, step].set(s)
        upd_l = upd_l.at[:, step].set(ch_p)
        upd_r = upd_r.at[:, step].set(ch_q)

    # --- apply (dropped scatters for non-improved / padded roots) ---
    tgt = jnp.where(improved[:, None], upd_nid, n_nodes)  # drop sentinel
    flat = tgt.reshape(-1)
    flat_s = upd_s.reshape(-1)
    flat_l = upd_l.reshape(-1)
    flat_r = upd_r.reshape(-1)
    bi = r_[:, None].repeat(TN - 1, 1).reshape(-1)

    left = left.at[flat].set(flat_l, mode="drop")
    right = right.at[flat].set(flat_r, mode="drop")
    parent = parent.at[jnp.where(improved[bi], flat_l, n_nodes)].set(
        flat, mode="drop"
    )
    parent = parent.at[jnp.where(improved[bi], flat_r, n_nodes)].set(
        flat, mode="drop"
    )
    bbmin = bbmin.at[flat].set(smin[bi, flat_s], mode="drop")
    bbmax = bbmax.at[flat].set(smax[bi, flat_s], mode="drop")
    cost = cost.at[flat].set(csub[bi, flat_s], mode="drop")
    return bbmin, bbmax, left, right, parent, cost


def optimize_treelets_device(bvh: BVH, verbose: bool = False) -> BVH:
    """Accelerator-side treelet optimization; same contract as
    ``treelet.optimize_treelets``.  Prints build time like the reference
    (``BVH/treeletBVH.cpp:437``) when ``verbose``."""
    import time

    t0 = time.time()
    left_h = np.asarray(bvh.left)
    right_h = np.asarray(bvh.right)
    n_nodes = left_h.shape[0]
    n = (n_nodes + 1) // 2
    if n < 8:
        return bvh
    leaf_base = n - 1

    # host-static schedule: initial heights (ordering) + subtree leaf counts
    # (7-leaf eligibility) — both invariant under treelet restructuring
    heights = _node_heights(left_h, right_h, leaf_base, n_nodes)
    counts = np.ones(n_nodes, np.int64)
    for v in np.argsort(heights[:leaf_base], kind="stable"):
        counts[v] = counts[left_h[v]] + counts[right_h[v]]
    eligible = counts[:leaf_base] >= TN

    # explicit copies: the batched calls donate their operands (in-place
    # buffer reuse round to round), which must never consume caller arrays
    bbmin = jnp.array(bvh.bbmin, jnp.float32, copy=True)
    bbmax = jnp.array(bvh.bbmax, jnp.float32, copy=True)
    left = jnp.array(bvh.left, jnp.int32, copy=True)
    right = jnp.array(bvh.right, jnp.int32, copy=True)
    parent = jnp.array(bvh.parent, jnp.int32, copy=True)

    # initial subtree SAH costs (bottom-up, host — once)
    bmn = np.asarray(bvh.bbmin, np.float64)
    bmx = np.asarray(bvh.bbmax, np.float64)
    d = np.maximum(bmx - bmn, 0.0)
    a = 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])
    cost_h = np.zeros(n_nodes, np.float64)
    cost_h[leaf_base:] = C_TRI * a[leaf_base:]
    for v in np.argsort(heights[:leaf_base], kind="stable"):
        cost_h[v] = C_INN * a[v] + cost_h[left_h[v]] + cost_h[right_h[v]]
    cost = jnp.asarray(cost_h, jnp.float32)

    n_rounds = 0
    for h in range(1, int(heights[:leaf_base].max()) + 1):
        roots_h = np.nonzero((heights[:leaf_base] == h) & eligible)[0]
        for lo in range(0, len(roots_h), BATCH):
            chunk = roots_h[lo : lo + BATCH]
            valid = np.zeros(BATCH, bool)
            valid[: len(chunk)] = True
            padded = np.full(BATCH, chunk[0], np.int32)
            padded[: len(chunk)] = chunk
            bbmin, bbmax, left, right, parent, cost = _optimize_batch(
                bbmin, bbmax, left, right, parent, cost,
                jnp.asarray(padded), jnp.asarray(valid), n_nodes,
            )
            n_rounds += 1
    jax.block_until_ready(left)
    if verbose:
        print(
            f"treeletGPU build time: {(time.time() - t0) * 1e3:.1f} ms "
            f"({n_rounds} batched rounds on {jax.default_backend()})"
        )
    return BVH(bbmin=bbmin, bbmax=bbmax, left=left, right=right,
               parent=parent)
