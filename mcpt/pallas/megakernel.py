"""Pallas megakernel: the entire path-trace loop fused into one GPU kernel.

Where the reference runs one OpenCL kernel per stage per bounce with all ray
state round-tripping through GPU global memory (``OpenCLApp.cpp:57-82``:
raygen → MAXDEPTH × {intersect, shade} → accumulate), this kernel keeps every
lane's path in registers for its whole lifetime: camera ray generation, every
intersection test, BSDF sampling, and radiance accumulation happen without
touching device memory until the final per-lane radiance write (12 bytes of
radiance plus a segment count per lane).

Lowered through Pallas's Triton route.  One program is a 1-D block of ``BLK``
lanes.  The triangle, material and light tables are whole-array operands: the
triangle loop reads each row by uniform (same-address) loads, which the L1/L2
caches serve for scenes this engine takes, and per-lane lookups (the hit's
normal and material row, the sampled light row) are gathers.  The triangle
loop is a ``fori_loop`` over ``CHUNK_TRIS``-row chunks.  Past
``CULL_MIN_TRIS`` the rows are Morton-sorted and each chunk's AABB is
slab-tested against the whole block first: a chunk no live lane can reach is
skipped (``lax.cond``), a one-level BVH.  The bounce loop is a ``while_loop``
that exits once every lane of the block is done — camera rays of one block are
spatially coherent, so blocks retire together.

RNG is a stateless counter hash (``_u01``) of (seed, salt, global
sample·pixel id), replacing the reference's per-pixel LCG (``shade.cl:1-6``):
it gives the same numbers compiled and interpreted, and for every schedule and
mesh shape, which is what makes sharded renders stream-exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from mcpt import types as T
from mcpt.runtime import pallas_interpret

# Lanes per program (a power of two, as Triton requires) and warps per program.
BLK = 256
NUM_WARPS = 4
# Triangle rows tested per loop iteration (straight-line code inside the
# chunk loop).  Tables are padded to a multiple with never-hit rows.
CHUNK_TRIS = 16
# Scenes past this size get Morton-sorted rows and per-chunk AABB culling.
CULL_MIN_TRIS = 128

_MTYPE_DIFFUSE = float(T.DIFFUSE)
_MTYPE_GLOSSY = float(T.GLOSSY)
_MTYPE_TRANSPARENT = float(T.TRANSPARENT)
_MTYPE_LIGHT = float(T.LIGHT)

# tri rows (T_pad, 16):  0:9 A row-major (o'_j = A[j,0]ox + A[j,1]oy +
#   A[j,2]oz + b_j), 9:12 b, 12:15 unit geometric normal, 15 material index.
# matt rows (M, 16), one per material: 0:3 kd, 3:6 ks, 6:9 ka, 9 ns, 10 ni,
#   11 mtype.
# lit rows (L, 16), one per emissive triangle: 0:3 v0, 3:6 e1, 6:9 e2,
#   9:12 emission, 12:15 unit normal, 15 area CDF.
# cbox rows (T_pad / CHUNK_TRIS, 8): 0:3 chunk AABB min, 3:6 max.

# murmur3 fmix32 constants as wrapped int32 literals (numpy scalars, NOT jax
# arrays — jax arrays at module scope become captured consts in pallas kernels)
_C1 = np.int32(0x85EBCA6B - (1 << 32))
_C2 = np.int32(0xC2B2AE35 - (1 << 32))
_GR = np.int32(0x9E3779B1 - (1 << 32))


def _fmix32(h):
    """murmur3 finalizer — works on scalars and vectors, int32 wraparound."""
    h = jnp.bitwise_xor(h, jax.lax.shift_right_logical(h, 16))
    h = h * _C1
    h = jnp.bitwise_xor(h, jax.lax.shift_right_logical(h, 13))
    h = h * _C2
    h = jnp.bitwise_xor(h, jax.lax.shift_right_logical(h, 16))
    return h


def _u01(seed, salt, idx):
    """Counter-based uniform in [0, 1): hash of (seed, salt, ray index).

    A stateless per-lane RNG in plain vector int ops: platform-independent,
    stateless like threefry, and far cheaper.  Replaces the reference's
    per-pixel LCG (``shade.cl:1-6``)."""
    h = _fmix32(seed + salt * _GR)
    h = _fmix32(jnp.bitwise_xor(idx * _GR, h))
    mant = jnp.bitwise_and(h, 0x7FFFFF)
    return mant.astype(jnp.float32) * (1.0 / 8388608.0)


def _where(c, a, b):
    """``jnp.where`` with Python-scalar branches made f32/i32 arrays first:
    the Triton lowering of ``select_n`` gives a weakly typed scalar branch the
    predicate's (boolean) type."""
    def typed(v):
        if isinstance(v, float):
            return np.float32(v)
        if isinstance(v, int):
            return np.int32(v)
        return v

    return jnp.where(c, typed(a), typed(b))


def _pow(x, n):
    """x**n for x ∈ (0, 1], vector n — exp/log form."""
    return jnp.exp(n * jnp.log(jnp.maximum(x, 1e-12)))


def _normalize3(x, y, z):
    inv = jax.lax.rsqrt(x * x + y * y + z * z + 1e-20)
    return x * inv, y * inv, z * inv


def _onb(nx, ny, nz):
    """Branchless ONB (Duff et al.) — vector form of shade.build_onb."""
    s = _where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t1x = 1.0 + s * nx * nx * a
    t1y = s * b
    t1z = -s * nx
    t2x = b
    t2y = s + ny * ny * a
    t2z = -ny
    return (t1x, t1y, t1z), (t2x, t2y, t2z)


def _safe_inv(d):
    tiny = 1e-30
    return 1.0 / _where(jnp.abs(d) < tiny, _where(d < 0.0, -tiny, tiny), d)


def _tri_test(tri_ref, t, ox, oy, oz, dx, dy, dz):
    """Wald unit-triangle test of row ``t`` → (t_hit, inside-triangle mask)."""
    c = [tri_ref[t, j] for j in range(12)]
    opz = c[6] * ox + c[7] * oy + c[8] * oz + c[11]
    dpz = c[6] * dx + c[7] * dy + c[8] * dz
    th = -opz / dpz
    opx = c[0] * ox + c[1] * oy + c[2] * oz + c[9]
    dpx = c[0] * dx + c[1] * dy + c[2] * dz
    u = opx + th * dpx
    opy = c[3] * ox + c[4] * oy + c[5] * oz + c[10]
    dpy = c[3] * dx + c[4] * dy + c[5] * dz
    v = opy + th * dpy
    return th, (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)


def _make_intersectors(tri_ref, cb_ref, n_chunks, cull, t_min):
    """Closest-hit and any-hit queries over the dense triangle table.

    ``closest(o…, d…, alive, rows) -> (best_t, nx, ny, nz, mat_id, rows)``
    with ``best_t == 3e38`` on a miss; ``occluded(o…, d…, limit, cand, rows)
    -> (occ, rows)`` with an f32 occlusion mask.  ``rows`` accumulates the
    live-lane triangle rows actually tested (the counter behind
    ``render_mega(count_rows=True)``)."""

    def box_hit(ci, ox, oy, oz, ivx, ivy, ivz, t_hi):
        t0x = (cb_ref[ci, 0] - ox) * ivx
        t1x = (cb_ref[ci, 3] - ox) * ivx
        t0y = (cb_ref[ci, 1] - oy) * ivy
        t1y = (cb_ref[ci, 4] - oy) * ivy
        t0z = (cb_ref[ci, 2] - oz) * ivz
        t1z = (cb_ref[ci, 5] - oz) * ivz
        tn = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        tf = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        return (tf >= jnp.maximum(tn, 0.0)) & (tn < t_hi)

    def chunk_loop(test_chunk, live_of, box_args, t_hi_of, state, rows):
        """Run ``test_chunk`` over every chunk; with culling, skip a chunk
        unless its box straddles some live lane's open segment."""
        if not cull:
            def body(ci, carry):
                st, rows = carry
                return test_chunk(ci, st), rows + live_of(st) * float(
                    CHUNK_TRIS)

            return jax.lax.fori_loop(0, n_chunks, body, (state, rows))

        def body(ci, carry):
            st, rows = carry
            live = live_of(st)
            reach = box_hit(ci, *box_args, t_hi_of(st)) & (live > 0.0)
            run = jnp.max(_where(reach, 1.0, 0.0)) > 0.0
            st = jax.lax.cond(run, lambda s: test_chunk(ci, s), lambda s: s,
                              st)
            return st, rows + _where(run, live * float(CHUNK_TRIS), 0.0)

        return jax.lax.fori_loop(0, n_chunks, body, (state, rows))

    def closest(ox, oy, oz, dx, dy, dz, alive, rows):
        def test_chunk(ci, st):
            bt, bi = st
            for j in range(CHUNK_TRIS):
                t = ci * CHUNK_TRIS + j
                th, inside = _tri_test(tri_ref, t, ox, oy, oz, dx, dy, dz)
                ok = inside & (th > t_min) & (th < bt)
                bt = _where(ok, th, bt)
                bi = _where(ok, t, bi)
            return bt, bi

        init = (jnp.full(ox.shape, 3.0e38, jnp.float32),
                jnp.zeros(ox.shape, jnp.int32))
        box_args = (ox, oy, oz, _safe_inv(dx), _safe_inv(dy), _safe_inv(dz))
        (best_t, best_i), rows = chunk_loop(
            test_chunk, lambda st: alive, box_args, lambda st: st[0], init,
            rows)
        # per-lane gathers of the winning row (a miss reads row 0; every use
        # of these values is masked by the hit test)
        nx = tri_ref[best_i, 12]
        ny = tri_ref[best_i, 13]
        nz = tri_ref[best_i, 14]
        mid = tri_ref[best_i, 15].astype(jnp.int32)
        return best_t, nx, ny, nz, mid, rows

    def occluded(sox, soy, soz, iwx, iwy, iwz, limit, cand, rows):
        def test_chunk(ci, occ):
            for j in range(CHUNK_TRIS):
                th, inside = _tri_test(tri_ref, ci * CHUNK_TRIS + j, sox, soy,
                                       soz, iwx, iwy, iwz)
                occ = jnp.maximum(occ, _where(
                    inside & (th > t_min) & (th < limit), 1.0, 0.0))
            return occ

        # a lane stops widening the box test once it is occluded, so blocks
        # that occlude early skip the rest of the table
        def live_of(occ):
            return _where(cand & (occ < 0.5), 1.0, 0.0)

        box_args = (sox, soy, soz, _safe_inv(iwx), _safe_inv(iwy),
                    _safe_inv(iwz))
        return chunk_loop(test_chunk, live_of, box_args, lambda occ: limit,
                          jnp.zeros(sox.shape, jnp.float32), rows)

    return closest, occluded


def _make_bounce_core(use_nee, use_mis, n_lights, si_ref, sf_ref, matt_ref,
                      lit_ref, closest_fn, occluded_fn, seed):
    """One path-trace bounce: intersect → material lookup → emission (with
    MIS discount) → BSDF sample → NEE shadow → transparent → next ray →
    termination → Russian roulette.  ``core(st, salt0, pidx, depth_ok,
    rr_on) -> st`` where ``st = (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg,
    rb, alive, inside, segs, prev_sc, prev_pdf, rows)`` and the four extra
    args carry the schedule-specific RNG coordinates and depth/RR gates."""
    if use_nee:
        area_l = sf_ref[16]
    eps = sf_ref[14]
    clampv = _where(sf_ref[18] > 0.0, sf_ref[18], jnp.float32(3.0e38))

    def core(st, salt0, pidx, depth_ok, rr_on):
        (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb, alive, inside,
         segs, prev_sc, prev_pdf, rows) = st
        best_t, nx, ny, nz, mid, rows = closest_fn(ox, oy, oz, dx, dy, dz,
                                                   alive, rows)
        hit = (best_t < 3.0e38) & (alive > 0.0)
        segs = segs + alive

        (kdx, kdy, kdz, ksx, ksy, ksz, kax, kay, kaz, ns_, ni_, mtype) = (
            matt_ref[mid, j] for j in range(12))

        # flip normal to face the ray (intersect.cl:23-25)
        ndotd = nx * dx + ny * dy + nz * dz
        flip = _where(ndotd < 0.0, 1.0, -1.0)
        nx = nx * flip
        ny = ny * flip
        nz = nz * flip

        hx = ox + best_t * dx
        hy = oy + best_t * dy
        hz = oz + best_t * dz

        is_lite = hit & (mtype == _MTYPE_LIGHT)
        is_diff = hit & (mtype == _MTYPE_DIFFUSE)
        is_glos = hit & (mtype == _MTYPE_GLOSSY)
        is_tran = hit & (mtype == _MTYPE_TRANSPARENT)

        # ---- LIGHT: gather emission, terminate (shade.cl:155-158).  With NEE
        # the emission after a reflective bounce is MIS-discounted (or dropped
        # entirely without MIS) against the light-sampling pdf. ----
        lmask = _where(is_lite, 1.0, 0.0)
        if use_nee:
            cos_lh = jnp.abs(ndotd)  # raw-normal · d
            pdf_lh = best_t * best_t / jnp.maximum(cos_lh * area_l, 1e-12)
            if use_mis:
                # power heuristic in ratio form — squaring large pdfs overflows
                # f32 to inf and inf/inf = NaN
                rat = pdf_lh / jnp.maximum(prev_pdf, 1e-12)
                w_hit = 1.0 / (1.0 + rat * rat)
            else:
                w_hit = 0.0
            e_scale = 1.0 - prev_sc * (1.0 - w_hit)
            lmask = lmask * e_scale
        # optional per-contribution clamp (sf[18]; 0 disables): suppresses
        # fireflies at the cost of documented bias
        rr = rr + jnp.minimum(lmask * tr * kax, clampv)
        rg = rg + jnp.minimum(lmask * tg * kay, clampv)
        rb = rb + jnp.minimum(lmask * tb * kaz, clampv)

        u1 = _u01(seed, salt0, pidx)
        u2 = _u01(seed, salt0 + 1, pidx)
        u3 = _u01(seed, salt0 + 2, pidx)
        u4 = _u01(seed, salt0 + 3, pidx)

        # ---- diffuse / glossy: cosine or phong-lobe sample ----
        (t1x, t1y, t1z), (t2x, t2y, t2z) = _onb(nx, ny, nz)
        r_ = jnp.sqrt(u1)
        phi = 6.2831853 * u2
        cphi = jnp.cos(phi)
        sphi = jnp.sin(phi)
        zc = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
        wdx = r_ * cphi * t1x + r_ * sphi * t2x + zc * nx
        wdy = r_ * cphi * t1y + r_ * sphi * t2y + zc * ny
        wdz = r_ * cphi * t1z + r_ * sphi * t2z + zc * nz

        # mirror of incoming d about n
        mdx = dx - 2.0 * ndotd * flip * nx
        mdy = dy - 2.0 * ndotd * flip * ny
        mdz = dz - 2.0 * ndotd * flip * nz
        (p1x, p1y, p1z), (p2x, p2y, p2z) = _onb(mdx, mdy, mdz)
        cos_a = _pow(jnp.maximum(u1, 1e-12), 1.0 / (ns_ + 1.0))
        sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
        wpx = sin_a * cphi * p1x + sin_a * sphi * p2x + cos_a * mdx
        wpy = sin_a * cphi * p1y + sin_a * sphi * p2y + cos_a * mdy
        wpz = sin_a * cphi * p1z + sin_a * sphi * p2z + cos_a * mdz

        pick_phong = is_glos & (u3 < 0.5)
        sxd = _where(pick_phong, wpx, wdx)
        syd = _where(pick_phong, wpy, wdy)
        szd = _where(pick_phong, wpz, wdz)

        cos_i = sxd * nx + syd * ny + szd * nz
        up_ok = cos_i > 0.0
        cos_ar = jnp.maximum(sxd * mdx + syd * mdy + szd * mdz, 0.0)
        pow_ns = _pow(cos_ar, ns_)
        inv_2pi = 0.15915494
        pdf_d = jnp.maximum(cos_i, 0.0) * (1.0 / jnp.pi)
        pdf_p = (ns_ + 1.0) * inv_2pi * pow_ns
        pdf_mix = 0.5 * pdf_d + 0.5 * pdf_p
        phong_f = (ns_ + 2.0) * inv_2pi * pow_ns
        scale_g = jnp.maximum(cos_i, 0.0) / jnp.maximum(pdf_mix, 1e-12)
        # glossy weight per channel: (kd/π + ks·phong_f)·cosθ/pdf_mix
        wgx = (kdx * (1.0 / jnp.pi) + ksx * phong_f) * scale_g
        wgy = (kdy * (1.0 / jnp.pi) + ksy * phong_f) * scale_g
        wgz = (kdz * (1.0 / jnp.pi) + ksz * phong_f) * scale_g
        # diffuse weight = kd
        ok_f = _where(up_ok, 1.0, 0.0)
        wrx = _where(is_glos, wgx, kdx) * ok_f
        wry = _where(is_glos, wgy, kdy) * ok_f
        wrz = _where(is_glos, wgz, kdz) * ok_f

        if use_nee and n_lights > 0:
            # ---- next-event estimation: sample the light area, cast a shadow
            # ray, add the MIS-weighted direct contribution (the reference has
            # no NEE) ----
            ul = _u01(seed, salt0 + 5, pidx)
            ua = _u01(seed, salt0 + 6, pidx)
            ub = _u01(seed, salt0 + 7, pidx)
            # area-proportional light pick: the CDF bin holding ul
            li = jax.lax.fori_loop(
                0, n_lights - 1,
                lambda i, acc: acc + _where(ul >= lit_ref[i, 15], 1, 0),
                jnp.zeros(ul.shape, jnp.int32),
            )
            lsel = [lit_ref[li, j] for j in range(15)]
            su_ = jnp.sqrt(ua)
            b1 = su_ * (1.0 - ub)
            b2 = su_ * ub
            lpx = lsel[0] + b1 * lsel[3] + b2 * lsel[6]
            lpy = lsel[1] + b1 * lsel[4] + b2 * lsel[7]
            lpz = lsel[2] + b1 * lsel[5] + b2 * lsel[8]
            tox = lpx - hx
            toy = lpy - hy
            toz = lpz - hz
            dist2 = tox * tox + toy * toy + toz * toz
            dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
            iwx = tox / dist
            iwy = toy / dist
            iwz = toz / dist
            cos_s = iwx * nx + iwy * ny + iwz * nz
            cos_l = jnp.abs(iwx * lsel[12] + iwy * lsel[13] + iwz * lsel[14])
            pdf_sa = dist2 / jnp.maximum(cos_l * area_l, 1e-12)
            # reflective BSDF toward the light + its sampling pdf (for MIS)
            cos_ar2 = jnp.maximum(iwx * mdx + iwy * mdy + iwz * mdz, 0.0)
            pw2 = _pow(cos_ar2, ns_)
            gmask = _where(is_glos, 1.0, 0.0)
            fx_ = kdx * (1.0 / jnp.pi) + gmask * ksx * (ns_ + 2.0) * inv_2pi * pw2
            fy_ = kdy * (1.0 / jnp.pi) + gmask * ksy * (ns_ + 2.0) * inv_2pi * pw2
            fz_ = kdz * (1.0 / jnp.pi) + gmask * ksz * (ns_ + 2.0) * inv_2pi * pw2
            pdf_d2 = jnp.maximum(cos_s, 0.0) * (1.0 / jnp.pi)
            pdf_b2 = (1.0 - 0.5 * gmask) * pdf_d2 + 0.5 * gmask * (
                (ns_ + 1.0) * inv_2pi * pw2
            )
            cand = (is_diff | is_glos) & (cos_s > 0.0) & (cos_l > 1e-6)
            # shadow ray: any hit closer than the light point blocks it
            sox = hx + eps * iwx
            soy = hy + eps * iwy
            soz = hz + eps * iwz
            limit = dist - 2.0 * eps
            occ, rows = occluded_fn(sox, soy, soz, iwx, iwy, iwz, limit, cand,
                                    rows)

            cand_f = _where(cand, 1.0, 0.0)
            vis = cand_f * (1.0 - occ)
            segs = segs + cand_f
            if use_mis:
                rat2 = pdf_b2 / jnp.maximum(pdf_sa, 1e-12)
                w_nee = 1.0 / (1.0 + rat2 * rat2)  # ratio form, see above
            else:
                w_nee = 1.0
            gain = vis * (cos_s * w_nee / jnp.maximum(pdf_sa, 1e-12))
            rr = rr + jnp.minimum(tr * fx_ * lsel[9] * gain, clampv)
            rg = rg + jnp.minimum(tg * fy_ * lsel[10] * gain, clampv)
            rb = rb + jnp.minimum(tb * fz_ * lsel[11] * gain, clampv)

        # ---- transparent: Schlick coin between refraction and mirror ----
        eta_i = _where(inside > 0.0, ni_, 1.0)
        eta_t = _where(inside > 0.0, 1.0, ni_)
        eta = eta_i / eta_t
        n_dot_i = -(nx * dx + ny * dy + nz * dz)
        k_ = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
        tir = k_ < 0.0
        sq = jnp.sqrt(jnp.maximum(k_, 0.0))
        txd = (eta * n_dot_i - sq) * nx + eta * dx
        tyd = (eta * n_dot_i - sq) * ny + eta * dy
        tzd = (eta * n_dot_i - sq) * nz + eta * dz
        txd, tyd, tzd = _normalize3(txd, tyd, tzd)
        cos_for_f = _where(
            eta_i <= eta_t, n_dot_i, -(txd * nx + tyd * ny + tzd * nz)
        )
        r0 = (ni_ - 1.0) / (ni_ + 1.0)
        r0 = r0 * r0
        one_m = jnp.clip(1.0 - jnp.abs(cos_for_f), 0.0, 1.0)
        p5 = one_m * one_m
        p5 = p5 * p5 * one_m
        fresnel = r0 + (1.0 - r0) * p5
        coin_refl = u4 < fresnel
        do_refr = is_tran & (~tir) & (~coin_refl)
        refrf = _where(do_refr, 1.0, 0.0)
        ttx = _where(do_refr, txd, mdx)
        tty = _where(do_refr, tyd, mdy)
        ttz = _where(do_refr, tzd, mdz)
        w_tran = _where(do_refr, eta * eta, 1.0)
        inside = _where(is_tran,
                           (1.0 - inside) * refrf + inside * (1.0 - refrf),
                           inside)

        # ---- compose next ray ----
        ndx = _where(is_tran, ttx, sxd)
        ndy = _where(is_tran, tty, syd)
        ndz = _where(is_tran, ttz, szd)
        wx = _where(is_tran, w_tran, wrx)
        wy = _where(is_tran, w_tran, wry)
        wz = _where(is_tran, w_tran, wrz)
        scatterish = is_diff | is_glos | is_tran
        smask = _where(scatterish, 1.0, 0.0)
        tr = tr * (wx * smask + (1.0 - smask))
        tg = tg * (wy * smask + (1.0 - smask))
        tb = tb * (wz * smask + (1.0 - smask))

        ox = _where(scatterish, hx + eps * ndx, ox)
        oy = _where(scatterish, hy + eps * ndy, oy)
        oz = _where(scatterish, hz + eps * ndz, oz)
        dx = _where(scatterish, ndx, dx)
        dy = _where(scatterish, ndy, dy)
        dz = _where(scatterish, ndz, dz)

        dead = (~hit) | is_lite | ((is_diff | is_glos) & ~up_ok)
        alive = alive * _where(dead, 0.0, 1.0) * depth_ok

        # ---- Russian roulette (optional; unbiased) ----
        u5 = _u01(seed, salt0 + 4, pidx)
        p_srv = jnp.clip(jnp.maximum(tr, jnp.maximum(tg, tb)), 0.05, 1.0)
        p_srv = p_srv * rr_on + (1.0 - rr_on)
        alive = alive * _where(u5 < p_srv, 1.0, 0.0)
        inv_p = 1.0 / p_srv
        tr = tr * inv_p
        tg = tg * inv_p
        tb = tb * inv_p

        prev_sc = _where(is_diff | is_glos, 1.0, 0.0)
        prev_pdf = _where(is_glos, pdf_mix, pdf_d)
        return (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb, alive,
                inside, segs, prev_sc, prev_pdf, rows)

    return core


def _make_kernel(use_nee, use_mis, n_lights, regen, n_chunks, cull,
                 count_rows):
    """The kernel for one block of ``BLK`` lanes, full path trace.

    ``regen=False`` (batch schedule): one lane per (sample, pixel); a lane
    whose path terminates idles until its whole block retires.

    ``regen=True`` (path regeneration): one lane per *pixel*; the moment a
    lane's path terminates it generates the NEXT sample's camera ray in place
    (per-lane depth + sample counters), so lanes stay busy until the block's
    final samples drain, and a lane's radiance accumulator is already the
    per-pixel sample sum the host wants.  It answers the dead-lane waste the
    reference sidesteps with per-work-item early return
    (``intersect.cl:16-18``).

    si (i32): 0 width, 1 height, 2 n_tris, 3 max_depth, 4 seed,
              5 rr_enabled, 6 rr_start_depth, 7 n_pixels (this shard's slice
              length), 8 n_mats, 9 n_lights, 10 pixel_base (first pixel id of
              the slice), 11 total pixels (W·H — makes the per-lane RNG
              counter globally unique across pixel shards), 12 spp (samples
              per lane under regen), 13 sample_base (first global sample index
              — a samples shard passes its own, so every (sample, pixel) RNG
              stream matches the single-device schedule exactly)
    sf (f32): 0:3 cam pos, 3:6 fwd, 6:9 right, 9:12 up, 12 half_w,
              13 half_h, 14 eps, 15 t_min, 16 total light area, 17 is_ortho,
              18 clamp
    """

    def kernel(si_ref, sf_ref, tri_ref, matt_ref, lit_ref, cb_ref, r_ref,
               g_ref, b_ref, seg_ref, *row_ref):
        width = si_ref[0]
        max_depth = si_ref[3]
        seed = si_ref[4]
        n_pixels = si_ref[7]
        ray_idx = (pl.program_id(0) * BLK
                   + jax.lax.broadcasted_iota(jnp.int32, (BLK,), 0))
        pixel = si_ref[10] + jax.lax.rem(ray_idx, n_pixels)
        pxi = jax.lax.rem(pixel, width)
        pyi = jax.lax.div(pixel, width)
        # RNG counter: globally unique (sample, pixel) id — equal to ray_idx
        # on one device, disjoint across mesh pixel AND sample shards
        ray_idx = (si_ref[13] + jax.lax.div(ray_idx, n_pixels)) * si_ref[11] \
            + pixel

        zeros = jnp.zeros((BLK,), jnp.float32)
        w_f = width.astype(jnp.float32)
        h_f = si_ref[1].astype(jnp.float32)
        half_w = sf_ref[12]
        half_h = sf_ref[13]
        # pinhole vs orthographic blend (rayGenerator.cl:13-27)
        w_ort = sf_ref[17]

        def cam_ray(idx2):
            """Camera ray for this lane's pixel, RNG stream ``idx2``
            (rayGenerator.cl:13-27 pinhole/ortho math, jittered)."""
            fx = pxi.astype(jnp.float32) + _u01(seed, jnp.int32(1), idx2)
            fy = pyi.astype(jnp.float32) + _u01(seed, jnp.int32(2), idx2)
            sx = fx / w_f - 0.5
            sy = fy / h_f - 0.5
            offx = 2.0 * sx * half_w * sf_ref[6] + 2.0 * sy * half_h * sf_ref[9]
            offy = 2.0 * sx * half_w * sf_ref[7] + 2.0 * sy * half_h * sf_ref[10]
            offz = 2.0 * sx * half_w * sf_ref[8] + 2.0 * sy * half_h * sf_ref[11]
            cdx = sf_ref[3] + (1.0 - w_ort) * offx
            cdy = sf_ref[4] + (1.0 - w_ort) * offy
            cdz = sf_ref[5] + (1.0 - w_ort) * offz
            cdx, cdy, cdz = _normalize3(cdx, cdy, cdz)
            cox = sf_ref[0] + w_ort * offx
            coy = sf_ref[1] + w_ort * offy
            coz = sf_ref[2] + w_ort * offz
            return cox, coy, coz, cdx, cdy, cdz

        closest_fn, occluded_fn = _make_intersectors(
            tri_ref, cb_ref, n_chunks, cull, sf_ref[15])
        core = _make_bounce_core(use_nee, use_mis, n_lights, si_ref, sf_ref,
                                 matt_ref, lit_ref, closest_fn, occluded_fn,
                                 seed)
        max_depth_f = max_depth.astype(jnp.float32)
        spp_s = si_ref[12]
        spp_f = spp_s.astype(jnp.float32)
        rr_en = _where(si_ref[5] > 0, 1.0, 0.0)
        rr_start_f = si_ref[6].astype(jnp.float32)

        state = (
            jnp.int32(0),  # iteration counter (== depth when not regen)
            *cam_ray(ray_idx),
            zeros + 1.0, zeros + 1.0, zeros + 1.0,  # throughput
            zeros, zeros, zeros,  # radiance
            zeros + 1.0,  # alive (f32 mask)
            zeros,  # inside (f32 mask)
            zeros,  # live-segment counter
            zeros,  # prev_sc: previous bounce sampled a reflective BSDF
            zeros,  # prev_pdf: that sample's solid-angle pdf (for MIS)
            zeros,  # live-lane triangle rows tested
        )
        if regen:
            state = state + (
                zeros,  # per-lane path depth
                zeros,  # per-lane completed-sample count
            )

            def cond(s):
                return (s[0] < spp_s * max_depth) & (
                    jnp.min(s[20]) < spp_f - 0.5)
        else:
            def cond(s):
                return (s[0] < max_depth) & (jnp.max(s[13]) > 0.0)

        def bounce(s):
            it = s[0]
            st = s[1:19]
            if regen:
                depth_v, done_s = s[19], s[20]
                # per-lane RNG coordinates: the lane's current (sample, depth)
                salt0 = 8 * depth_v.astype(jnp.int32) + 3
                pidx = (si_ref[13] + done_s.astype(jnp.int32)) * si_ref[11] \
                    + pixel
                depth_ok = _where(depth_v + 1.0 < max_depth_f, 1.0, 0.0)
                rr_on = rr_en * _where(depth_v >= rr_start_f, 1.0, 0.0)
            else:
                salt0 = 8 * it + 3
                pidx = ray_idx
                depth_ok = _where(it + 1 < max_depth, 1.0, 0.0)
                rr_on = _where((si_ref[5] > 0) & (it >= si_ref[6]), 1.0,
                                  0.0)
            st = core(st, salt0, pidx, depth_ok, rr_on)
            if not regen:
                return (it + 1, *st)

            # ---- path regeneration: a terminated lane starts its pixel's
            # next sample immediately (new camera ray, reset path state) ----
            (ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb, alive, inside,
             segs, prev_sc, prev_pdf, rows) = st
            died = s[13] - alive  # 1.0 where this iteration completed a path
            done_s = done_s + died
            reg = died * _where(done_s < spp_f - 0.5, 1.0, 0.0)
            pick = reg > 0.5
            idx_new = (si_ref[13] + done_s.astype(jnp.int32)) * si_ref[11] \
                + pixel
            cox, coy, coz, cdx, cdy, cdz = cam_ray(idx_new)
            ox = _where(pick, cox, ox)
            oy = _where(pick, coy, oy)
            oz = _where(pick, coz, oz)
            dx = _where(pick, cdx, dx)
            dy = _where(pick, cdy, dy)
            dz = _where(pick, cdz, dz)
            tr = _where(pick, 1.0, tr)
            tg = _where(pick, 1.0, tg)
            tb = _where(pick, 1.0, tb)
            inside = inside * (1.0 - reg)
            prev_sc = prev_sc * (1.0 - reg)
            prev_pdf = prev_pdf * (1.0 - reg)
            depth_v = _where(pick, 0.0, depth_v + 1.0)
            alive = alive + reg
            return (it + 1, ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb,
                    alive, inside, segs, prev_sc, prev_pdf, rows, depth_v,
                    done_s)

        final = jax.lax.while_loop(cond, bounce, state)
        r_ref[...] = final[10]
        g_ref[...] = final[11]
        b_ref[...] = final[12]
        seg_ref[...] = final[15]
        if count_rows:
            row_ref[0][...] = final[18]

    return kernel


def _expand_bits_np(x: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd position (Karras Morton expansion)."""
    x = (x | (x << 16)) & np.uint32(0x030000FF)
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def pack_materials(mats) -> np.ndarray:
    """(M, 16) f32 material-constant rows (``matt`` row contract)."""
    m_count = max(int(mats.count), 1)
    matt = np.zeros((m_count, 16), np.float32)
    matt[: mats.count, 0:3] = np.asarray(mats.kd)
    matt[: mats.count, 3:6] = np.asarray(mats.ks)
    matt[: mats.count, 6:9] = np.asarray(mats.ka)
    matt[: mats.count, 9] = np.asarray(mats.ns)
    matt[: mats.count, 10] = np.asarray(mats.ni)
    matt[: mats.count, 11] = np.asarray(mats.mtype).astype(np.float32)
    return matt


def pack_lights(scene: T.Scene, lights):
    """NEE light table (``lit`` row contract: v0, e1, e2, emission, unit
    normal, area CDF) → (lit, n_lights, total_area)."""
    n_lights = 0
    total_area = 0.0
    if lights is not None and int(lights.count) > 0:
        ids = np.asarray(lights.tri)
        n_lights = len(ids)
        lv = np.asarray(scene.geom.verts)[ids]
        lit = np.zeros((max(n_lights, 1), 16), np.float32)
        lit[:n_lights, 0:3] = lv[:, 0]
        lit[:n_lights, 3:6] = lv[:, 1] - lv[:, 0]
        lit[:n_lights, 6:9] = lv[:, 2] - lv[:, 0]
        lit[:n_lights, 9:12] = np.asarray(lights.emission)
        lit[:n_lights, 12:15] = np.asarray(scene.geom.normals)[ids]
        lit[:n_lights, 15] = np.asarray(lights.cdf)
        total_area = float(lights.total_area)
    else:
        lit = np.zeros((1, 16), np.float32)
    return lit, n_lights, total_area


class MegaScene(NamedTuple):
    """Device tables for the megakernel (built once per scene)."""

    tri: jnp.ndarray  # (T_pad, 16) f32 — Morton row order when culled
    cbox: jnp.ndarray  # (T_pad/CHUNK, 8) f32 chunk AABBs ((1, 8) unculled)
    matt: jnp.ndarray  # (M, 16) f32 — one row per material
    lit: jnp.ndarray  # (L, 16) f32 — emissive-tri table (NEE)
    n_tris: int
    n_mats: int
    n_lights: int
    eps: float
    total_light_area: float


def build_megascene(scene: T.Scene, lights=None) -> MegaScene:
    """Pack Wald transforms + per-triangle normal/material rows.
    ``lights`` (mcpt.scene.Lights) enables the NEE table."""
    assert scene.wald is not None, "scene has no Wald transforms"
    w = np.asarray(scene.wald.w)  # (3, T, 3), w[k, t, j] = A[t, j, k]
    b = np.asarray(scene.wald.b)  # (T, 3)
    normals = np.asarray(scene.geom.normals)
    t_count = b.shape[0]
    a = np.transpose(w, (1, 2, 0))  # (T, j, k) = A
    tri = np.zeros((t_count, 16), np.float32)
    tri[:, 0:9] = a.reshape(t_count, 9)
    tri[:, 9:12] = b
    tri[:, 12:15] = normals
    mat_id = np.clip(np.asarray(scene.geom.mat_id), 0, None)
    tri[:, 15] = mat_id.astype(np.float32)

    verts3 = np.asarray(scene.geom.verts, np.float32).reshape(t_count, 3, 3)
    cull = t_count > CULL_MIN_TRIS
    if cull:
        # Morton-sort rows so each CHUNK_TRIS-row chunk is spatially tight,
        # enabling the in-kernel chunk-box culling.  Row order is internal to
        # the kernel (normals/material ride the rows; the NEE light table
        # indexes the original geometry separately).
        cen = verts3.mean(axis=1)
        lo = cen.min(axis=0)
        ext = np.maximum(cen.max(axis=0) - lo, 1e-20)
        q = np.clip((cen - lo) / ext * 1024.0, 0.0, 1023.0).astype(np.uint32)
        code = ((_expand_bits_np(q[:, 2]) << 2)
                | (_expand_bits_np(q[:, 1]) << 1)
                | _expand_bits_np(q[:, 0]))
        perm = np.argsort(code, kind="stable")
        tri = tri[perm]
        verts3 = verts3[perm]

    pad = (-t_count) % CHUNK_TRIS
    if pad:
        tri = np.pad(tri, ((0, pad), (0, 0)))
        # padded rows: b2 = 1, A = 0 ⇒ d'_w = 0 ⇒ never hit — the chunk loops
        # test every padded row, so this is load-bearing
        tri[t_count:, 11] = 1.0

    if cull:
        # per-chunk AABBs (pad rows excluded via ±inf sentinels; every chunk
        # holds ≥1 real row, so no box inverts — an inverted box would ALWAYS
        # pass the min/max slab test)
        n_rows = tri.shape[0]
        tmin = np.full((n_rows, 3), np.inf, np.float32)
        tmax = np.full((n_rows, 3), -np.inf, np.float32)
        tmin[:t_count] = verts3.min(axis=1)
        tmax[:t_count] = verts3.max(axis=1)
        nch = n_rows // CHUNK_TRIS
        cbox = np.zeros((nch, 8), np.float32)
        cbox[:, 0:3] = tmin.reshape(nch, CHUNK_TRIS, 3).min(axis=1)
        cbox[:, 3:6] = tmax.reshape(nch, CHUNK_TRIS, 3).max(axis=1)
    else:
        cbox = np.zeros((1, 8), np.float32)  # never read

    matt = pack_materials(scene.materials)
    lit, n_lights, total_area = pack_lights(scene, lights)
    return MegaScene(
        tri=jnp.asarray(tri), matt=jnp.asarray(matt), lit=jnp.asarray(lit),
        cbox=jnp.asarray(cbox),
        n_tris=t_count, n_mats=matt.shape[0], n_lights=n_lights,
        eps=float(scene.eps), total_light_area=total_area,
    )


def render_mega(mega: MegaScene, cam: T.Camera, width: int, height: int,
                spp: int, seed, max_depth: int = 16, rr: bool = False,
                rr_start: int = 3, nee: bool = False, mis: bool = False,
                clamp: float = 0.0, t_min: float = 1e-4,
                interpret: bool = False, pixel_base=0,
                pixel_count: int | None = None, sample_base=0,
                schedule: str = "auto", count_rows: bool = False):
    """Render spp samples → ((pixel_count, 3) radiance sum, segments).

    ``schedule`` picks the lane scheduling: ``"regen"`` — one lane per pixel,
    in-kernel path regeneration through all spp samples; ``"batch"`` — one
    lane per (sample, pixel), whole blocks retire early; ``"auto"`` — regen
    when spp > 1.  Both compute the same estimator with the same RNG streams.

    ``pixel_base``/``pixel_count`` select a contiguous pixel slice (defaults:
    the whole image) — the spatial-sharding hook for
    ``mcpt.dist.render_mega_sharded`` (pixel_base may be traced, e.g. a mesh
    axis index).  ``sample_base`` offsets the global sample indices the same
    way (a ``samples``-axis shard renders samples ``[sample_base,
    sample_base + spp)`` of the single-device schedule with the SAME seed, so
    sharded output is stream-exact against one device).

    ``interpret=True`` runs the kernel in the Pallas interpreter (any
    backend); otherwise it is compiled for the GPU (see
    ``mcpt.runtime.pallas_interpret``).

    ``count_rows=True`` returns a third value: the live-lane triangle rows
    actually tested, after chunk culling (the operation count behind a
    roofline share)."""
    if pixel_count is None:
        pixel_count = width * height
    if schedule == "auto":
        schedule = "regen" if spp > 1 else "batch"
    if schedule not in ("regen", "batch"):
        raise ValueError(f"unknown schedule {schedule!r}")
    return _render_mega_jit(
        mega.tri, mega.matt, mega.lit, mega.cbox, cam, width, height, spp,
        seed, max_depth, rr, rr_start, nee and mega.n_lights > 0, mis, clamp,
        t_min, pallas_interpret(interpret), mega.n_tris, mega.n_mats,
        mega.n_lights, mega.eps, mega.total_light_area, pixel_base,
        pixel_count, sample_base, schedule == "regen", count_rows,
    )


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "rr", "rr_start",
                     "nee", "mis", "clamp", "t_min", "interpret", "n_tris",
                     "n_mats", "n_lights", "eps", "total_light_area",
                     "pixel_count", "regen", "count_rows"),
)
def _render_mega_jit(tri, matt, lit, cb, cam, width, height, spp, seed,
                     max_depth, rr, rr_start, nee, mis, clamp, t_min,
                     interpret, n_tris, n_mats, n_lights, eps,
                     total_light_area, pixel_base, pixel_count,
                     sample_base=0, regen=False, count_rows=False):
    n_pixels = pixel_count
    n_rays = n_pixels if regen else n_pixels * spp
    n_blocks = (n_rays + BLK - 1) // BLK

    si = jnp.array(
        [width, height, n_tris, max_depth, 0, int(rr), rr_start, n_pixels,
         n_mats, n_lights, 0, width * height, spp, 0],
        jnp.int32,
    )
    si = si.at[4].set(jnp.asarray(seed, jnp.int32))
    si = si.at[10].set(jnp.asarray(pixel_base, jnp.int32))
    si = si.at[13].set(jnp.asarray(sample_base, jnp.int32))
    sf = jnp.concatenate(
        [
            cam.position.reshape(3),
            cam.forward.reshape(3),
            cam.right.reshape(3),
            cam.up.reshape(3),
            jnp.stack(
                [
                    cam.half_width.reshape(()),
                    cam.half_height.reshape(()),
                    jnp.float32(eps),
                    jnp.float32(t_min),
                ]
            ),
            jnp.asarray([total_light_area], jnp.float32),
            cam.is_ortho.reshape(1),
            jnp.asarray([clamp], jnp.float32),
        ]
    ).astype(jnp.float32)

    assert tri.shape[0] % CHUNK_TRIS == 0, tri.shape
    n_out = 5 if count_rows else 4
    outs = pl.pallas_call(
        _make_kernel(nee, mis, n_lights, regen, tri.shape[0] // CHUNK_TRIS,
                     n_tris > CULL_MIN_TRIS, count_rows),
        grid=(n_blocks,),
        out_shape=[jax.ShapeDtypeStruct((n_blocks * BLK,), jnp.float32)
                   for _ in range(n_out)],
        out_specs=[pl.BlockSpec((BLK,), lambda i: (i,)) for _ in range(n_out)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="mcpt_megakernel",
    )(si, sf, tri, matt, lit, cb)
    r, g, b, segs = (o[:n_rays] for o in outs[:4])

    rad = jnp.stack([r, g, b], axis=-1)
    if regen:
        radiance = rad  # each lane already accumulated all spp samples
    else:
        radiance = rad.reshape(spp, n_pixels, 3).sum(axis=0)
    segments = jnp.sum(segs)
    if count_rows:
        return radiance, segments, jnp.sum(outs[4][:n_rays])
    return radiance, segments
