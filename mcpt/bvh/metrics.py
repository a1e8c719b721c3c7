"""BVH construction-quality metrics: SAH, EPO, LCV.

The JAX port of the reference's research harness (``bvhtest.cpp`` +
``kernels/EPO.cl``), with identical metric *definitions* so numbers are
comparable:

- **SAH** (``bvhtest.cpp:104-115``): ``(Σ_internal Cinn·A(n) + Σ_leaf
  Ctri·A(n)) / A(root)`` with the reference's constants Cinn=1.2, Ctri=1
  (``auxiliary.h:9-11``).  One vectorized reduction here.
- **EPO** — Expected Projected Overlap (Aila et al. 2013; ``bvhtest.cpp:
  221-284``): for every leaf triangle, the surface area of the triangle clipped
  against every *non-ancestor* node's AABB, weighted Cinn/Ctri, normalized by
  total triangle area.  The reference walks one leaf at a time on the CPU (and
  one work-item per leaf on GPU, ``EPO.cl:133-197``); here all leaves traverse
  simultaneously as a batched stack walk, with a vectorized Sutherland–Hodgman
  clip over the whole (leaf, node) frontier per step.
- **LCV** — Leaf-Count Variation (``bvhtest.cpp:324-444``): the standard
  deviation of the number of leaf AABBs hit along primary camera rays (pixel
  centers, the reference's aspect-free test ray generator,
  ``bvhtest.cpp:413-424``).
"""

from __future__ import annotations

import functools
import math

import numpy as np

C_INN = 1.2  # internal-node traversal cost (auxiliary.h:9-11)
C_TRI = 1.0  # triangle-intersection cost
C_LEAF = 0.0


def _area(bbmin, bbmax):
    d = np.maximum(bbmax - bbmin, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])


def sah(bvh) -> float:
    """Surface-area-heuristic cost (reference definition, ``bvhtest.cpp:104-115``)."""
    bbmin = np.asarray(bvh.bbmin)
    bbmax = np.asarray(bvh.bbmax)
    n_nodes = bbmin.shape[0]
    n_internal = n_nodes // 2  # == N-1 for 2N-1 nodes
    areas = _area(bbmin, bbmax)
    total = C_INN * areas[:n_internal].sum() + C_TRI * areas[n_internal:].sum()
    return float(total / max(areas[0], 1e-30))


# ---------------------------------------------------------------------------
# EPO
# ---------------------------------------------------------------------------


_CLIP_CAP = 10  # ≤ 3 + 6 vertices survive 6 plane clips; one spare


def _clip_areas_jnp(tris, bmin, bmax):
    """Vectorized Sutherland–Hodgman: area of each triangle clipped to its
    AABB — tris (P, 3, 3), bmin/bmax (P, 3) → (P,).  Pure jnp (jit-safe),
    shaped for a single CPU core: the polygon buffer *grows* one slot per
    plane (3→9, a box clip adds ≤1 vertex per plane) instead of a fixed
    worst-case cap, and there is no vertex-count bookkeeping — slots past the
    polygon's end duplicate its first vertex, which the shoelace sum ignores.
    Each plane's output ring is built with gathers keyed by an emission-rank
    computation (output slot → source edge).  Same plane order and
    crossing-parameter formula as the native walk (``mcpt_native.cpp``
    clip_area ≙ reference ``ROUNDTR``, ``bvhtest.cpp:141-178``)."""
    import jax.numpy as jnp

    verts = tris  # (m, cap, 3); trailing slots duplicate a ring point
    for axis in range(3):
        for side in range(2):  # 0: keep ≥ bbmin, 1: keep ≤ bbmax
            cap = verts.shape[1]
            ocap = min(cap + 1, 9)
            bound = (bmin if side == 0 else bmax)[:, axis]
            sgn = 1.0 if side == 0 else -1.0
            da = sgn * (verts[:, :, axis] - bound[:, None])  # signed distance
            # ring successor: slot s+1 cyclically (trailing duplicates keep
            # this exact — the successor of the last slot is ring point 0)
            v_next = jnp.concatenate([verts[:, 1:], verts[:, :1]], axis=1)
            db = jnp.concatenate([da[:, 1:], da[:, :1]], axis=1)
            in_a = da >= 0.0
            keep = in_a  # edge emits its own vertex
            crossing = in_a ^ (db >= 0.0)  # …plus the plane crossing
            t = da / jnp.where(da == db, 1.0, da - db)
            cross_pt = verts + t[..., None] * (v_next - verts)

            emit = keep.astype(jnp.int32) + crossing.astype(jnp.int32)
            starts = jnp.cumsum(emit, axis=1) - emit
            ends = starts + emit
            total = ends[:, -1]
            # output slot s ← edge e(s) = #{j : ends[j] ≤ s} (the unique edge
            # with starts[e] ≤ s < ends[e] while s < total)
            s_vals = jnp.arange(ocap)
            e = jnp.sum(
                (ends[:, None, :] <= s_vals[None, :, None]).astype(jnp.int32),
                axis=2,
            )
            e = jnp.minimum(e, cap - 1)
            start_e = jnp.take_along_axis(starts, e, axis=1)
            keep_e = jnp.take_along_axis(keep, e, axis=1)
            crossing_e = jnp.take_along_axis(crossing, e, axis=1)
            vert_e = jnp.take_along_axis(verts, e[..., None], axis=1)
            cross_e = jnp.take_along_axis(cross_pt, e[..., None], axis=1)
            is_vertex = keep_e & ((s_vals[None, :] == start_e) | ~crossing_e)
            pick = jnp.where(is_vertex[..., None], vert_e, cross_e)
            # slots past the end duplicate the first output point (keeps the
            # ring closed; zero shoelace contribution)
            out_valid = s_vals[None, :] < total[:, None]
            verts = jnp.where(out_valid[..., None], pick, pick[:, 0:1])

    # polygon area via the fan cross-product sum (planar polygon in 3D)
    v_next = jnp.concatenate([verts[:, 1:], verts[:, :1]], axis=1)
    v0 = verts[:, :1]
    cr = jnp.cross(verts - v0, v_next - v0)
    tot = cr.sum(axis=1)
    return 0.5 * jnp.sqrt(jnp.sum(tot * tot, axis=-1))


def _clip_areas(tris: np.ndarray, bbmin: np.ndarray, bbmax: np.ndarray):
    """Numpy facade over ``_clip_areas_jnp`` (f64, CPU) for host callers."""
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(), jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(
            _clip_areas_jnp(
                jnp.asarray(tris, jnp.float64),
                jnp.asarray(bbmin, jnp.float64),
                jnp.asarray(bbmax, jnp.float64),
            )
        )


def tri_area(verts: np.ndarray) -> np.ndarray:
    v = np.asarray(verts, np.float64).reshape(-1, 3, 3)
    return 0.5 * np.linalg.norm(
        np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1
    )


def epo(bvh, verts, chunk: int = 2048, use_native: str = "auto",
        device: str = "cpu") -> float:
    """Expected Projected Overlap (reference semantics, ``bvhtest.cpp:221-284``).

    Dispatches to the parallel C++ walk (``mcpt/native``, seconds for a
    100k-tri scene — the counterpart of the reference's GPU EPO kernel,
    ``kernels/EPO.cl:133-197``) when available.  ``device`` names the JAX
    platform of the jitted fallback: ``"gpu"`` runs its walk segments AND
    clip batches on the card (f32 clips, like the reference's ``EPO.cl``;
    the CPU path clips in f64), the default ``"cpu"`` keeps the diagnostic on
    the host, where the native walk takes ~2 s for 108k tris.  The fallback is
    jitted and
    two-phase: (1) a batched *walk* — ``chunk`` lanes traverse the tree in
    lock-step, refilled from a host work queue every ``_EPO_SEG_STEPS`` steps
    so total cost is ∝ Σ pops / chunk, emitting every live (leaf, node)
    overlap pair; (2) dense batched Sutherland–Hodgman *clips* (f64) over
    exactly those pairs.  The walk descends on AABB overlap instead of the
    reference's clip-area test — a conservative superset whose extra subtrees
    contribute exactly 0 (a child's clip region ⊆ its parent's), so the sum is
    identical while the walk needs no geometry.  The overlap test itself runs
    in f32 like the native/reference walk.  Ancestor nodes are excluded via
    subtree leaf-ranges (Karras internal nodes cover contiguous sorted-leaf
    ranges, so ancestry is an interval test).
    """
    if use_native != "never" and device == "cpu":
        try:
            from mcpt import native

            if native.available():
                return native.epo_native(
                    np.asarray(verts, np.float32).reshape(-1, 9),
                    np.asarray(bvh.bbmin), np.asarray(bvh.bbmax),
                    np.asarray(bvh.left), np.asarray(bvh.right),
                    C_INN, C_TRI,
                )
        except Exception:
            if use_native == "always":
                raise
    import jax

    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    v = np.asarray(verts, np.float64).reshape(-1, 3, 3)
    n = (left.shape[0] + 1) // 2
    if n == 1:
        return 0.0
    leaf_base = n - 1

    # subtree leaf ranges (position space 0..N-1)
    lo = np.zeros(2 * n - 1, np.int64)
    hi = np.zeros(2 * n - 1, np.int64)
    lo[leaf_base:] = np.arange(n)
    hi[leaf_base:] = np.arange(n)
    # bottom-up: iterate until fixed (tree depth ≤ 64 for tie-broken Morton keys)
    internal = np.arange(leaf_base)
    for _ in range(64):
        new_lo = np.minimum(lo[left[internal]], lo[right[internal]])
        new_hi = np.maximum(hi[left[internal]], hi[right[internal]])
        if (new_lo == lo[:leaf_base]).all() and (new_hi == hi[:leaf_base]).all():
            break
        lo[:leaf_base] = new_lo
        hi[:leaf_base] = new_hi

    tri_of_leaf = left[leaf_base:]
    tmin = v.min(axis=1)
    tmax = v.max(axis=1)
    tri_n = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])  # unnormalized

    # exact DFS stack bound: popping a node pushes its 2 children, so the
    # stack never exceeds tree depth + 1 — size the lane stacks to that
    # (the one-hot stack ops cost ∝ cap, so a tight cap is walk speed)
    depth_max = 0
    frontier = np.array([0], np.int64)
    while frontier.size:
        frontier = frontier[frontier < leaf_base]
        if not frontier.size:
            break
        frontier = np.concatenate([left[frontier], right[frontier]])
        depth_max += 1
    stack_cap = min(max(depth_max + 2, 8), 4096)

    m = min(chunk, n)
    gmin32 = tmin.astype(np.float32)
    gmax32 = tmax.astype(np.float32)
    # feed the queue biggest-AABB-first: scene-spanning triangles walk the
    # whole tree serially (one lane, ~n_nodes pops) — starting them at t=0
    # overlaps their long walks with everyone else's instead of leaving them
    # as a lock-step tail
    ext = (tmax - tmin)[tri_of_leaf]
    queue = np.argsort(
        -(ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
          + ext[:, 2] * ext[:, 0])
    ).astype(np.int64)
    pair_nodes: list = []
    pair_tris: list = []
    tri_area64 = tri_area(verts)
    contained_epo = 0.0
    dev = jax.devices(device)[0]
    with jax.default_device(dev):
        import jax.numpy as jnp

        tree = (
            jnp.asarray(bvh.bbmin, jnp.float32),
            jnp.asarray(bvh.bbmax, jnp.float32),
            jnp.asarray(left, jnp.int32),
            jnp.asarray(right, jnp.int32),
            jnp.asarray(lo, jnp.int32),
            jnp.asarray(hi, jnp.int32),
        )
        # lane state (host mirrors; refilled from the queue between segments)
        stack = np.zeros((m, stack_cap), np.int32)
        sp = np.zeros(m, np.int32)
        pos = np.zeros(m, np.int32)
        gmin = np.zeros((m, 3), np.float32)
        gmax = np.zeros((m, 3), np.float32)
        lane_tri = np.zeros(m, np.int64)
        nrm = np.zeros((m, 3), np.float32)
        nv0 = np.zeros((m, 3), np.float32)
        next_leaf = 0
        seg = _get_epo_segment_jit(stack_cap)
        while True:
            done = sp == 0
            take = min(int(done.sum()), n - next_leaf)
            if take:
                slots = np.nonzero(done)[0][:take]
                new = queue[next_leaf : next_leaf + take]
                tri = tri_of_leaf[new]
                pos[slots] = new
                lane_tri[slots] = tri
                gmin[slots] = gmin32[tri]
                gmax[slots] = gmax32[tri]
                nrm[slots] = tri_n[tri]
                nv0[slots] = v[tri, 0]
                stack[slots, 0] = 0  # root pushed
                sp[slots] = 1
                next_leaf += take
            if sp.max(initial=0) == 0 and next_leaf >= n:
                break
            out = seg(
                *tree, jnp.asarray(stack), jnp.asarray(sp),
                jnp.asarray(pos), jnp.asarray(gmin), jnp.asarray(gmax),
                jnp.asarray(nrm), jnp.asarray(nv0),
            )
            # np.array (copy): asarray of a jax array is a read-only view
            stack, sp = np.array(out[0]), np.array(out[1])
            code = np.asarray(out[3])
            step_i, lane_i = np.nonzero(code)
            if len(lane_i):
                cc = code[step_i, lane_i]
                full = cc == 2
                nd_full = np.asarray(out[2])[step_i[full], lane_i[full]]
                w_full = np.where(nd_full >= leaf_base, C_TRI, C_INN)
                contained_epo += float(
                    (w_full * tri_area64[lane_tri[lane_i[full]]]).sum()
                )
                part = ~full
                if part.any():
                    pair_nodes.append(
                        np.asarray(out[2])[step_i[part], lane_i[part]]
                    )
                    pair_tris.append(lane_tri[lane_i[part]])

    total_epo = contained_epo
    if pair_nodes:
        import contextlib

        nodes_all = np.concatenate(pair_nodes)
        tris_all = np.concatenate(pair_tris)
        # CPU clips in f64 (exact to 2e-13 vs native); accelerator clips in
        # f32 like the reference's GPU kernel (EPO.cl is float throughout)
        fdt = np.float64 if device == "cpu" else np.float32
        x64 = jax.enable_x64() if device == "cpu" else contextlib.nullcontext()
        bbmin_f = np.asarray(bvh.bbmin, fdt)
        bbmax_f = np.asarray(bvh.bbmax, fdt)
        w_all = np.where(nodes_all >= leaf_base, C_TRI, C_INN)
        bs = 16384
        with x64, jax.default_device(dev):
            import jax.numpy as jnp

            clip = _get_clip_batch_jit()
            for i in range(0, len(nodes_all), bs):
                nd = nodes_all[i : i + bs]
                pad = bs - len(nd)
                geo = np.zeros((bs, 3, 3), fdt)
                geo[: len(nd)] = v[tris_all[i : i + bs]]
                bmn = np.zeros((bs, 3), fdt)
                bmx = np.zeros((bs, 3), fdt)
                bmn[: len(nd)] = bbmin_f[nd]
                bmx[: len(nd)] = bbmax_f[nd]
                w = np.zeros(bs, fdt)
                w[: len(nd)] = w_all[i : i + bs]
                total_epo += float(
                    clip(jnp.asarray(geo), jnp.asarray(bmn),
                         jnp.asarray(bmx), jnp.asarray(w))
                )

    total_area = float(tri_area(verts).sum())
    return total_epo / max(total_area, 1e-30)


_EPO_SEG_STEPS = 512


def _epo_segment(stack_cap, bbmin, bbmax, left, right, lo, hi, stack, sp,
                 pos, gmin, gmax, nrm, nv0):
    """Up to ``_EPO_SEG_STEPS`` steps of the batched EPO walk (see ``epo``):
    every live lane pops one node per step.  Pure traversal — f32 AABB
    overlap tests and one-hot stack ops (XLA CPU scatters serialize; the
    dense select is ~100× cheaper).  Returns the advanced (stack, sp) plus
    the per-step (node, need) emission buffers for the host's clip phase."""
    import jax
    import jax.numpy as jnp

    n_nodes = left.shape[0]
    leaf_base = (n_nodes + 1) // 2 - 1
    m = pos.shape[0]
    scol = jnp.arange(stack_cap)[None, :]  # (1, S)

    def cond(st):
        return (st[0] < _EPO_SEG_STEPS) & jnp.any(st[2] > 0)

    def body(st):
        it, stack, sp, nodes_out, need_out = st
        live = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.sum(jnp.where(scol == top[:, None], stack, 0), axis=1)
        node = jnp.where(live, node, 0)
        sp = sp - live.astype(jnp.int32)

        is_anc = (lo[node] <= pos) & (pos <= hi[node])
        bmn = bbmin[node]
        bmx = bbmax[node]
        overlap = jnp.all((gmin <= bmx) & (gmax >= bmn), axis=1)
        # triangle-plane vs box prefilter: a box strictly on one side of the
        # leaf triangle's plane clips to zero area, and so does its whole
        # subtree (child boxes ⊆ parent box) — prune it.  Small conservative
        # margin absorbs the f32 rounding.
        # sd = n·(c − v0), translated BEFORE multiplying: the n·c − n·v0
        # form cancels catastrophically in f32 for boxes touching the plane
        # far from the origin (cost: a 0.5% EPO deficit on boxfield)
        sd = jnp.sum(nrm * (0.5 * (bmn + bmx) - nv0), axis=1)
        rd = 0.5 * jnp.sum(jnp.abs(nrm) * (bmx - bmn), axis=1)
        overlap = overlap & (jnp.abs(sd) <= rd + 1e-4 * (rd + jnp.abs(sd)))
        need = live & overlap & ~is_anc
        # emission code 2: the node box CONTAINS the triangle's AABB, so the
        # clip is the full triangle — the host adds w·area(tri) directly and
        # skips the Sutherland–Hodgman batch for these pairs entirely
        contained = jnp.all((gmin >= bmn) & (gmax <= bmx), axis=1)
        code = jnp.where(
            need, jnp.where(contained, jnp.int8(2), jnp.int8(1)), jnp.int8(0)
        )
        nodes_out = jax.lax.dynamic_update_slice(
            nodes_out, node[None, :], (it, 0)
        )
        need_out = jax.lax.dynamic_update_slice(
            need_out, code[None, :], (it, 0)
        )

        # descend: ancestors always; non-ancestors on AABB overlap (a
        # conservative form of the reference's positive-clip rule,
        # bvhtest.cpp:222-244 — extra subtrees clip to zero area)
        descend = live & (node < leaf_base) & (is_anc | overlap)
        for ch in (right, left):
            slot = jnp.minimum(sp, stack_cap - 1)
            stack = jnp.where(
                (scol == slot[:, None]) & descend[:, None],
                ch[node][:, None], stack,
            )
            sp = sp + descend.astype(jnp.int32)
        return it + 1, stack, sp, nodes_out, need_out

    init = (
        jnp.int32(0), stack, sp,
        jnp.zeros((_EPO_SEG_STEPS, m), jnp.int32),
        jnp.zeros((_EPO_SEG_STEPS, m), jnp.int8),
    )
    out = jax.lax.while_loop(cond, body, init)
    return out[1], out[2], out[3], out[4]


def _clip_batch(geo, bmn, bmx, w):
    """Σ w·clip_area over one dense batch of (leaf-triangle, node-box) pairs."""
    import jax.numpy as jnp

    return jnp.sum(_clip_areas_jnp(geo, bmn, bmx) * w)


@functools.lru_cache(maxsize=1)
def _get_clip_batch_jit():
    import jax

    return jax.jit(_clip_batch)


@functools.lru_cache(maxsize=4)
def _get_epo_segment_jit(stack_cap):
    import functools as ft

    import jax

    return jax.jit(ft.partial(_epo_segment, stack_cap))



# ---------------------------------------------------------------------------
# LCV
# ---------------------------------------------------------------------------


def lcv(bvh, camera, width: int, height: int) -> float:
    """σ of leaf-AABB hit counts along primary rays (``bvhtest.cpp:324-444``).

    Rays use the reference's LCV generator: pixel centers, NO aspect scaling
    (``bvhtest.cpp:413-424`` — unlike the render ray generator)."""
    import jax
    import jax.numpy as jnp

    bbmin = jnp.asarray(bvh.bbmin)
    bbmax = jnp.asarray(bvh.bbmax)
    left = jnp.asarray(bvh.left)
    right = jnp.asarray(bvh.right)
    n = (left.shape[0] + 1) // 2
    leaf_base = n - 1

    i = (jnp.arange(width * height) % width).astype(jnp.float32)
    j = (jnp.arange(width * height) // width).astype(jnp.float32)
    t1 = (i + 0.5) / width - 0.5
    t2 = (j + 0.5) / height - 0.5
    fwd, rgt, up = camera.forward, camera.right, camera.up
    dist = 0.5 / camera.half_height  # = 0.5 / tan(fov/2)
    d = dist * fwd[None] + t1[:, None] * rgt[None] + t2[:, None] * up[None]
    o = jnp.broadcast_to(camera.position, d.shape)

    tiny = 1e-30
    inv = 1.0 / jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)
    r = d.shape[0]
    arange = jnp.arange(r)

    def slab_hit(node, t_eps=0.001):
        t0 = (bbmin[node] - o) * inv
        t1_ = (bbmax[node] - o) * inv
        tn = jnp.max(jnp.minimum(t0, t1_), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1_), axis=-1)
        return tf >= jnp.maximum(tn, t_eps)

    def body(state):
        stack, sp, count = state
        live = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.where(live, stack[arange, top], 0)
        sp = jnp.where(live, sp - 1, sp)
        hit = slab_hit(node) & live
        is_leaf = node >= leaf_base
        count = count + (hit & is_leaf).astype(jnp.int32)
        push = hit & ~is_leaf
        slot = jnp.minimum(sp, 63)
        stack = stack.at[arange, slot].set(
            jnp.where(push, right[node], stack[arange, slot])
        )
        sp = sp + push.astype(jnp.int32)
        slot = jnp.minimum(sp, 63)
        stack = stack.at[arange, slot].set(
            jnp.where(push, left[node], stack[arange, slot])
        )
        sp = sp + push.astype(jnp.int32)
        return stack, sp, count

    def cond(state):
        return jnp.any(state[1] > 0)

    stack0 = jnp.zeros((r, 64), jnp.int32)
    init = (stack0, jnp.ones((r,), jnp.int32), jnp.zeros((r,), jnp.int32))
    if n == 1:
        counts = slab_hit(jnp.zeros((r,), jnp.int32)).astype(jnp.int32)
    else:
        _, _, counts = jax.lax.while_loop(cond, body, init)
    c = np.asarray(counts, np.float64)
    return float(math.sqrt(max((c * c).mean() - c.mean() ** 2, 0.0)))
