"""Wavefront path-tracing integrator: the per-sample render loop.

The data-parallel equivalent of the reference frame tick (``OpenCLApp.cpp:57-82``):
generate one camera ray per pixel, then ``maxdepth`` × {intersect, shade} with
everything resident on device, then splat into the (sum, count) framebuffer.  The
reference runs its bounce loop with a fixed trip count and lets dead rays
early-return inside the kernels (``OpenCLApp.cpp:69-72``, ``intersect.cl:16``);
here the bounce loop is a ``lax.while_loop`` that exits as soon as every path has
terminated — dead lanes cost zero full iterations instead of ``maxdepth`` kernel
launches.

Extensions over the reference (config-gated, see ``mcpt.config.IntegratorConfig``):
next-event estimation with the power-heuristic MIS against BSDF sampling, and
Russian roulette.  All randomness is threefry, keyed per (sample index, bounce).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mcpt.scene import Lights, Scene
from mcpt.render import camera as camera_mod
from mcpt.render import shade as shade_mod
from mcpt.render import traverse
from mcpt.types import EPSILON, Camera, Framebuffer, RayPool


class RenderOptions(NamedTuple):
    """Static (hashable) integrator options — part of the jit cache key."""

    max_depth: int = 16
    nee: bool = False
    mis: bool = False
    russian_roulette: bool = False
    rr_start_depth: int = 3
    method: str = "auto"  # intersector: auto | brute | bvh
    jitter: bool = True
    # Bounce-loop lowering.  "fori" (default) is a fixed-trip-count loop — the
    # reference's own scheduling (``OpenCLApp.cpp:69-72``).  "while" adds an
    # any-alive early exit, a win when most paths die before max_depth.
    loop: str = "fori"
    # Stream compaction between bounces (SURVEY §7 step 5; the reference instead
    # early-returns dead work-items in-kernel, ``intersect.cl:16-18`` — in a
    # data-parallel wavefront dead lanes cost full work, so the pool is
    # physically shrunk).  A
    # tuple of per-depth live-fraction caps (len ≥ max_depth - 1, entry d caps
    # the pool entering bounce d+1); None disables.  Static → one compile per
    # schedule.  Use ``measure_schedule`` to derive one from a pilot render.
    compact: tuple | None = None
    # Inter-bounce ray re-sorting for the BVH walk: after each bounce the pool
    # is sorted by (origin Morton code, direction octant) with dead rays keyed
    # last, via ONE multi-operand lax.sort that carries the ray state with the
    # keys (no permutation gather).  Neighbouring rays then walk similar node
    # sets, and dead rays gather at the end of the pool.  The original ray
    # order is restored once after the loop (sort by carried index).
    # Pointless for brute-force scenes.
    resort: bool = False
    # Coarse-cell bits of the resort key (3b = 2^b cells per axis): a pool of
    # R rays averages R / (2^B · 8) rays per (cell, octant) bucket.
    resort_coarse_bits: int = 6


def _nee_contribution(scene: Scene, lights: Lights, res: shade_mod.ShadeResult,
                      hit_point, wo, key, opts: RenderOptions):
    """Sample one point on the light area; returns (radiance_delta (R,3))."""
    r = hit_point.shape[0]
    u = jax.random.uniform(key, (r, 3), jnp.float32)

    # pick a light triangle ∝ area
    li = jnp.clip(
        jnp.searchsorted(lights.cdf, u[:, 0], side="left"), 0, lights.count - 1
    )
    tri = lights.tri[li]
    v = scene.geom.verts[tri]  # (R, 3, 3)
    su = jnp.sqrt(u[:, 1])
    b0 = 1.0 - su
    b1 = su * (1.0 - u[:, 2])
    b2 = su * u[:, 2]
    p_l = b0[:, None] * v[:, 0] + b1[:, None] * v[:, 1] + b2[:, None] * v[:, 2]
    n_l = scene.geom.normals[tri]

    to_l = p_l - hit_point
    dist2 = jnp.sum(to_l * to_l, axis=-1)
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-20))
    wi = to_l / dist[:, None]

    cos_surf = jnp.sum(res.n_shade * wi, axis=-1)
    cos_light = jnp.abs(jnp.sum(n_l * wi, axis=-1))  # lights emit double-sided

    # area-uniform pdf over all light area → solid angle
    pdf_sa = dist2 / jnp.maximum(cos_light * lights.total_area, 1e-12)

    f, bsdf_pdf = shade_mod.eval_bsdf(scene.materials, res.mat_id, res.n_shade, wo, wi)

    cand = res.scatter & (cos_surf > 0.0) & (cos_light > 1e-6)
    shadow_o = hit_point + scene.eps * wi
    blocked = traverse.occluded(
        scene, shadow_o, wi, dist - 2.0 * scene.eps, active=cand, method=opts.method
    )
    vis = cand & ~blocked

    Le = lights.emission[li]
    if opts.mis:
        w_mis = pdf_sa**2 / jnp.maximum(pdf_sa**2 + bsdf_pdf**2, 1e-20)
    else:
        w_mis = jnp.ones_like(pdf_sa)
    contrib = f * Le * (cos_surf * w_mis / jnp.maximum(pdf_sa, 1e-12))[:, None]
    return jnp.where(vis[:, None], contrib, 0.0)


class _LoopState(NamedTuple):
    depth: jnp.ndarray
    pool: RayPool
    prev_scatter: jnp.ndarray  # (R,) — previous bounce sampled a non-delta BSDF
    prev_pdf: jnp.ndarray  # (R,) — its solid-angle pdf (for MIS at light hits)
    segments: jnp.ndarray  # () f32 — live ray segments traced (incl. shadow rays)
    orig_idx: jnp.ndarray  # (R,) i32 — original pool slot (identity unless resort)


def _sort_key(pool: RayPool, bb_lo, inv_ext, coarse_bits: int = 6):
    """Ray coherence key: coarse origin cell (``coarse_bits``-bit Morton)
    major, direction octant next, fine origin Morton last — neighbouring rays
    then walk near-identical node sets (same neighbourhood, same descent
    order).  ≤30 bits, never negative; dead rays get ``0x7FFFFFFF`` so they
    sort last.  See ``RenderOptions.resort_coarse_bits``."""
    from mcpt.bvh import lbvh

    u = jnp.clip((pool.origin - bb_lo) * inv_ext, 0.0, 0.999999)
    m = lbvh.morton30(u)
    octant = (
        (pool.direction[:, 0] > 0).astype(jnp.int32)
        + 2 * (pool.direction[:, 1] > 0).astype(jnp.int32)
        + 4 * (pool.direction[:, 2] > 0).astype(jnp.int32)
    )
    fine_bits = min(30 - coarse_bits, 12)
    coarse = m >> (30 - coarse_bits)
    fine = (m >> (30 - coarse_bits - fine_bits)) & ((1 << fine_bits) - 1)
    key = (coarse << (3 + fine_bits)) | (octant << fine_bits) | fine
    return jnp.where(pool.alive, key, jnp.int32(0x7FFFFFFF))


def _resort_pool(pool: RayPool, prev_scatter, prev_pdf, orig_idx,
                 bb_lo, inv_ext, coarse_bits: int = 6):
    """Sort the pool by ``_sort_key`` with dead rays keyed to the end.  One
    multi-operand ``lax.sort`` moves the whole ray state with the keys — no
    permutation gather."""
    key = _sort_key(pool, bb_lo, inv_ext, coarse_bits)
    ops = jax.lax.sort(
        (
            key,
            pool.origin[:, 0], pool.origin[:, 1], pool.origin[:, 2],
            pool.direction[:, 0], pool.direction[:, 1], pool.direction[:, 2],
            pool.throughput[:, 0], pool.throughput[:, 1], pool.throughput[:, 2],
            pool.radiance[:, 0], pool.radiance[:, 1], pool.radiance[:, 2],
            pool.pixel, pool.alive, pool.inside,
            prev_scatter, prev_pdf, orig_idx,
        ),
        num_keys=1,
    )
    new_pool = RayPool(
        origin=jnp.stack(ops[1:4], axis=-1),
        direction=jnp.stack(ops[4:7], axis=-1),
        throughput=jnp.stack(ops[7:10], axis=-1),
        radiance=jnp.stack(ops[10:13], axis=-1),
        pixel=ops[13],
        alive=ops[14],
        inside=ops[15],
    )
    return new_pool, ops[16], ops[17], ops[18]


def trace(scene: Scene, lights: Lights, pool: RayPool, key: jax.Array,
          opts: RenderOptions, with_stats: bool = False):
    """Run the bounce loop to termination; returns the final pool (radiance set).

    ``with_stats=True`` also returns the number of live ray segments traced
    (closest-hit queries on live paths + NEE shadow rays) — the honest
    numerator for a Mrays/s metric."""
    r = pool.count
    use_nee = opts.nee and lights.count > 0
    if opts.resort:
        # scene bounds for the Morton sort keys (one tiny reduction per trace)
        v = scene.geom.verts.reshape(-1, 3)
        bb_lo = jnp.min(v, axis=0)
        ext = jnp.max(v, axis=0) - bb_lo
        inv_ext = 1.0 / jnp.maximum(ext, 1e-12)

    def body(state: _LoopState) -> _LoopState:
        pool = state.pool
        kd_, kn_, ks_ = jax.random.split(
            jax.random.fold_in(key, state.depth), 3
        )
        hit = traverse.intersect_scene(
            scene, pool.origin, pool.direction, active=pool.alive, method=opts.method
        )

        # Emission discount at light hits (MIS vs the previous bounce's NEE).
        if use_nee:
            cos_l = jnp.abs(jnp.sum(hit.normal * pool.direction, axis=-1))
            pdf_light_sa = (hit.t**2) / jnp.maximum(
                cos_l * lights.total_area, 1e-12
            )
            if opts.mis:
                w = state.prev_pdf**2 / jnp.maximum(
                    state.prev_pdf**2 + pdf_light_sa**2, 1e-20
                )
            else:
                w = jnp.zeros((r,), jnp.float32)  # NEE-only: no double counting
            e_scale = jnp.where(state.prev_scatter, w, 1.0)
        else:
            e_scale = None

        wo = -pool.direction
        res = shade_mod.shade(
            scene.materials,
            scene.geom.mat_id,
            pool,
            hit,
            ks_,
            state.depth,
            opts.max_depth,
            rr_enabled=opts.russian_roulette,
            rr_start_depth=opts.rr_start_depth,
            emission_scale=e_scale,
            eps=scene.eps,
        )
        new_pool = res.pool

        segments = state.segments + jnp.sum(pool.alive.astype(jnp.float32))
        if use_nee:
            delta = _nee_contribution(scene, lights, res, hit.point, wo, kn_, opts)
            # NEE uses the throughput *before* this bounce's BSDF weight
            new_pool = new_pool._replace(
                radiance=new_pool.radiance + pool.throughput * delta
            )
            segments = segments + jnp.sum(res.scatter.astype(jnp.float32))

        prev_scatter, prev_pdf, orig_idx = res.scatter, res.bsdf_pdf, state.orig_idx
        if opts.resort:
            new_pool, prev_scatter, prev_pdf, orig_idx = _resort_pool(
                new_pool, prev_scatter, prev_pdf, orig_idx, bb_lo, inv_ext,
                opts.resort_coarse_bits,
            )
        return _LoopState(
            depth=state.depth + 1,
            pool=new_pool,
            prev_scatter=prev_scatter,
            prev_pdf=prev_pdf,
            segments=segments,
            orig_idx=orig_idx,
        )

    def cond(state: _LoopState):
        return (state.depth < opts.max_depth) & jnp.any(state.pool.alive)

    init = _LoopState(
        depth=jnp.int32(0),
        pool=pool,
        prev_scatter=jnp.zeros((r,), bool),
        prev_pdf=jnp.zeros((r,), jnp.float32),
        segments=jnp.float32(0.0),
        orig_idx=jnp.arange(r, dtype=jnp.int32),
    )
    if opts.loop == "while":
        final = jax.lax.while_loop(cond, body, init)
    elif opts.loop == "fori":
        final = jax.lax.fori_loop(0, opts.max_depth, lambda i, s: body(s), init)
    elif opts.loop == "unroll":
        final = init
        for _ in range(opts.max_depth):
            final = body(final)
    else:
        raise ValueError(f"unknown loop mode {opts.loop!r}")
    out_pool = final.pool
    if opts.resort:
        # restore original ray order (radiance + pixel are what callers use
        # positionally) with one more payload sort by the carried index
        o = jax.lax.sort(
            (final.orig_idx,
             out_pool.radiance[:, 0], out_pool.radiance[:, 1],
             out_pool.radiance[:, 2], out_pool.pixel),
            num_keys=1,
        )
        out_pool = out_pool._replace(
            radiance=jnp.stack(o[1:4], axis=-1), pixel=o[4]
        )
    if with_stats:
        return out_pool, final.segments
    return out_pool


def _round_up(n: int, mult: int = 1024) -> int:
    return ((n + mult - 1) // mult) * mult


def _compact_pool(pool: RayPool, prev_scatter, prev_pdf, key, cap: int):
    """Shrink the pool to its live prefix, capacity ``cap`` (static).

    If more than ``cap`` paths are live, exactly ``cap`` survivors are picked
    uniformly at random (rank selection over random scores — every live ray has
    inclusion probability ``p = cap/live``) and survivor throughput is scaled by
    ``1/p``: unbiased under any schedule (a too-tight bucket only costs
    variance, never bias), and the kept count can never overflow the bucket."""
    r = pool.count
    live = jnp.sum(pool.alive.astype(jnp.int32))
    n_keep = jnp.minimum(live, jnp.int32(cap))
    p_keep = n_keep.astype(jnp.float32) / jnp.maximum(
        live.astype(jnp.float32), 1.0
    )
    u = jax.random.uniform(key, (r,))
    # alive rays first, in random order; rank < n_keep selects exactly n_keep
    order = jnp.argsort(jnp.where(pool.alive, u, 2.0))
    rank = jnp.zeros((r,), jnp.int32).at[order].set(
        jnp.arange(r, dtype=jnp.int32)
    )
    keep = pool.alive & (rank < n_keep)
    throughput = pool.throughput / p_keep
    # positions of kept rays in the compact prefix
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    n_kept = n_keep
    perm = jnp.zeros((cap,), jnp.int32)
    scatter_to = jnp.where(keep, pos, cap)  # cap = dropped
    perm = perm.at[scatter_to].set(
        jnp.arange(r, dtype=jnp.int32), mode="drop"
    )
    row_alive = jnp.arange(cap) < n_kept

    def take(x, fill=0):
        out = x[perm]
        return jnp.where(
            row_alive.reshape((cap,) + (1,) * (x.ndim - 1)), out, fill
        )

    new_pool = RayPool(
        origin=take(pool.origin),
        direction=take(pool.direction),
        throughput=take(throughput),
        radiance=jnp.zeros((cap, 3), jnp.float32),  # deltas already flushed
        pixel=take(pool.pixel),
        alive=row_alive,
        inside=take(pool.inside),
    )
    return new_pool, take(prev_scatter), take(prev_pdf)


def trace_compacted(scene: Scene, lights: Lights, pool: RayPool, key: jax.Array,
                    opts: RenderOptions, num_pixels: int, with_stats: bool = False):
    """Bounce loop with inter-bounce stream compaction → (num_pixels, 3) radiance
    sums (dead rays' contributions are scatter-added into the per-pixel image the
    bounce they terminate, so the shrinking pool never loses radiance).

    Python-unrolled over depth: each depth has its own (static) pool size from
    ``opts.compact``; one compile per (resolution, schedule).
    """
    r0 = pool.count
    schedule = opts.compact
    assert schedule is not None
    image = jnp.zeros((num_pixels, 3), jnp.float32)
    segments = jnp.float32(0.0)
    prev_scatter = jnp.zeros((pool.count,), bool)
    prev_pdf = jnp.zeros((pool.count,), jnp.float32)
    use_nee = opts.nee and lights.count > 0

    for depth in range(opts.max_depth):
        kd_ = jax.random.fold_in(key, depth)
        kn_, ks_, kc_ = jax.random.split(kd_, 3)
        hit = traverse.intersect_scene(
            scene, pool.origin, pool.direction, active=pool.alive,
            method=opts.method,
        )
        segments = segments + jnp.sum(pool.alive.astype(jnp.float32))

        if use_nee:
            cos_l = jnp.abs(jnp.sum(hit.normal * pool.direction, axis=-1))
            pdf_light_sa = (hit.t**2) / jnp.maximum(
                cos_l * lights.total_area, 1e-12
            )
            if opts.mis:
                w = prev_pdf**2 / jnp.maximum(
                    prev_pdf**2 + pdf_light_sa**2, 1e-20
                )
            else:
                w = jnp.zeros_like(prev_pdf)
            e_scale = jnp.where(prev_scatter, w, 1.0)
        else:
            e_scale = None

        wo = -pool.direction
        res = shade_mod.shade(
            scene.materials, scene.geom.mat_id, pool, hit, ks_,
            depth, opts.max_depth,
            rr_enabled=opts.russian_roulette,
            rr_start_depth=opts.rr_start_depth,
            emission_scale=e_scale,
            eps=scene.eps,
        )
        new_pool = res.pool
        delta = new_pool.radiance - pool.radiance
        if use_nee:
            delta = delta + pool.throughput * _nee_contribution(
                scene, lights, res, hit.point, wo, kn_, opts
            )
            segments = segments + jnp.sum(res.scatter.astype(jnp.float32))
        # flush this bounce's radiance into the image (scatter-add by pixel)
        image = image.at[new_pool.pixel].add(delta, mode="drop")

        prev_scatter, prev_pdf = res.scatter, res.bsdf_pdf
        pool = new_pool._replace(radiance=jnp.zeros_like(new_pool.radiance))

        if depth + 1 < opts.max_depth:
            frac = schedule[min(depth, len(schedule) - 1)]
            cap = min(pool.count, max(1024, _round_up(int(frac * r0))))
            if cap < pool.count:
                pool, prev_scatter, prev_pdf = _compact_pool(
                    pool, prev_scatter, prev_pdf, kc_, cap
                )

    if with_stats:
        return image, segments
    return image


def measure_schedule(scene: Scene, lights: Lights, cam: Camera,
                     opts: RenderOptions, width: int = 128, height: int = 128,
                     seed: int = 0, margin: float = 1.35) -> tuple:
    """Pilot render measuring per-depth live fractions → a compaction schedule
    (fraction caps, 1/64 granularity, ``margin`` headroom, monotone)."""
    from mcpt.render import camera as _cm

    key = jax.random.key(seed)
    pool = _cm.generate_rays(cam, width, height, key=key, jitter=opts.jitter)
    fracs = []
    r = pool.count
    o = opts._replace(compact=None)
    for depth in range(opts.max_depth - 1):
        hit = traverse.intersect_scene(
            scene, pool.origin, pool.direction, active=pool.alive,
            method=opts.method,
        )
        res = shade_mod.shade(
            scene.materials, scene.geom.mat_id, pool, hit,
            jax.random.fold_in(key, depth), depth, opts.max_depth,
            rr_enabled=o.russian_roulette, rr_start_depth=o.rr_start_depth,
            eps=scene.eps,
        )
        pool = res.pool
        fracs.append(float(jnp.sum(pool.alive.astype(jnp.float32))) / r)
    sched = []
    prev = 1.0
    for f in fracs:
        capped = min(prev, max(f * margin, 1.0 / 64.0))
        capped = min(1.0, (int(capped * 64) + 1) / 64.0)
        capped = min(prev, capped)
        sched.append(capped)
        prev = capped
    return tuple(sched)


@functools.partial(jax.jit, static_argnames=("width", "height", "opts", "spp",
                                             "with_stats"))
def render_batch(scene: Scene, lights: Lights, cam: Camera, width: int,
                 height: int, key: jax.Array, opts: RenderOptions,
                 spp: int = 1, with_stats: bool = False) -> jnp.ndarray:
    """``spp`` samples per pixel in one device program → (W·H, 3) radiance *sum*.

    Batching the sample axis into the ray pool replaces the reference's
    one-sample-per-frame-tick scheduling (``OpenCLApp.cpp:57-82``): a W·H·spp
    pool keeps the device busy and amortizes dispatch.
    ``with_stats=True`` also returns the live-segment count (the honest
    Mrays/s numerator — the reference shows live FPS in its window title,
    ``openglapp.cpp:52-56``; we show measured segments/s)."""
    keys = jax.random.split(key, spp)
    n = width * height

    gen = functools.partial(camera_mod.generate_rays, cam, width, height)

    if spp == 1 and opts.compact is None:
        k_cam, k_path = jax.random.split(keys[0])
        pool = gen(key=k_cam, jitter=opts.jitter)
        out = trace(scene, lights, pool, k_path, opts, with_stats=with_stats)
        if with_stats:
            return out[0].radiance, out[1]
        return out.radiance

    # one flat pool of spp·W·H rays (not vmap: a single big wavefront vectorizes
    # the bounce loop across samples AND pixels, so partially-dead sample slices
    # don't serialize)
    k_cams, _ = jax.vmap(lambda k: tuple(jax.random.split(k)))(keys)
    pools = jax.vmap(lambda k: gen(key=k, jitter=opts.jitter))(k_cams)
    flat = jax.tree.map(
        lambda x: x.reshape((spp * n,) + x.shape[2:]), pools
    )
    if opts.compact is not None:
        # compacted trace scatter-adds by (true) pixel id — order-independent
        return trace_compacted(scene, lights, flat, key, opts, num_pixels=n,
                               with_stats=with_stats)
    out = trace(scene, lights, flat, key, opts, with_stats=with_stats)
    if with_stats:
        return out[0].radiance.reshape(spp, n, 3).sum(axis=0), out[1]
    return out.radiance.reshape(spp, n, 3).sum(axis=0)


def render_sample(scene: Scene, lights: Lights, cam: Camera, width: int,
                  height: int, key: jax.Array, opts: RenderOptions) -> jnp.ndarray:
    """One sample per pixel → (W·H, 3) radiance."""
    return render_batch(scene, lights, cam, width, height, key, opts, spp=1)


@functools.partial(jax.jit, static_argnames=("spp",))
def accumulate(fb: Framebuffer, radiance_sum: jnp.ndarray, spp: int = 1) -> Framebuffer:
    """Exact running (sum, count) — unlike the reference's black/saturated-sample
    skipping (``history.cl:15-18``), every sample counts: unbiased mean."""
    return Framebuffer(sum=fb.sum + radiance_sum, count=fb.count + float(spp))


def render(scene: Scene, lights: Lights, cam: Camera, width: int, height: int,
           opts: RenderOptions, spp: int, seed: int = 0,
           fb: Framebuffer | None = None, progress=None, spp_per_step: int = 1):
    """Progressive accumulation of ``spp`` samples (host loop ≙ the reference's
    frame ticks, one sample per tick, ``colorout.cpp:55-62``; ``spp_per_step``
    batches several samples per device program).

    Returns the framebuffer; ``fb`` may resume a previous render (checkpointing —
    the reference has none across runs, SURVEY §5)."""
    from mcpt.types import make_framebuffer

    if fb is None:
        fb = make_framebuffer(width * height)
    base = jax.random.key(seed)
    start = int(fb.count.max()) if fb.count.size else 0
    s = start
    while s < start + spp:
        step = min(spp_per_step, start + spp - s)
        radiance = render_batch(
            scene, lights, cam, width, height, jax.random.fold_in(base, s), opts,
            spp=step,
        )
        fb = accumulate(fb, radiance, spp=step)
        s += step
        if progress is not None:
            progress(s, fb)
    return fb


def framebuffer_image(fb: Framebuffer, width: int, height: int):
    """(H, W, 3) float32 mean radiance, row 0 at the *bottom* (reference
    framebuffer orientation; flip when writing images)."""
    import numpy as np

    return np.asarray(fb.mean).reshape(height, width, 3)
