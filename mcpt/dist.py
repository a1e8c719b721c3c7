"""Distributed rendering over a device mesh.

The reference is strictly single-process/single-GPU (one in-order
``cl::CommandQueue``, ``oclbasic.cpp:14,117``) — this module is the *new*
first-class component SURVEY §2.3 calls for: a ``jax.sharding.Mesh`` with two
named axes,

- ``"samples"`` — data-parallel over the sample (spp) axis: every shard renders
  the full image at ``spp / |samples|``, radiance sums are ``psum``-reduced
  (XLA hands the collective to NCCL on GPUs);
- ``"pixels"``  — spatial sharding of the framebuffer: each shard owns a
  contiguous pixel slice and only ever touches its slice (no collective
  needed until host gather).

Every GPU of a host reaches every other at the same NVLink rate, so the mesh
follows the algorithm: sample parallelism (``samples`` = device count) needs
one ``psum`` of the image per step and no other communication.

Scene, BVH, materials and camera are replicated (they are small: ≤ a few hundred
MB even for san-miguel-class scenes), the ray pool and framebuffer are sharded.
The per-device program is the same code used on one device — the whole render
step is ``shard_map``-ped and jit-compiled once.

Determinism contract: the megakernel (``render_mega_sharded``) renders every
shard with the SAME seed and a ``sample_base`` equal to its global sample
offset, so each (sample, pixel) RNG stream is identical to the single-device
schedule and the rendered image is the same for any mesh shape up to f32 sum
order (1×1 ≡ 2×4 ≡ 8×1 — tested in ``tests/test_dist.py``).  The wavefront
(``render_batch_sharded``) is the exception: its RNG is ``jax.random`` keyed
per (sample-shard, pixel-shard) and positional within the pool, so its sharded
output is a *different but unbiased* estimate that is deterministic in (seed,
mesh shape); making it stream-exact means moving the wavefront to the
megakernel's counter-hash RNG.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mcpt.render import camera as camera_mod
from mcpt.render import integrator as integ
from mcpt.scene import Lights, Scene
from mcpt.types import Camera, Framebuffer


def make_mesh(samples: int = 1, pixels: int | None = None,
              devices: Sequence[jax.Device] | None = None) -> Mesh:
    """Build a ("samples", "pixels") mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if pixels is None:
        pixels = n // max(samples, 1)
    if samples < 1 or samples * pixels != n:
        raise ValueError(
            f"a mesh of samples={samples} x pixels={pixels} does not cover "
            f"the {n} devices")
    arr = np.asarray(devices).reshape(samples, pixels)
    return Mesh(arr, axis_names=("samples", "pixels"))


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "opts", "spp", "mesh", "with_stats"),
)
def render_batch_sharded(
    scene: Scene,
    lights: Lights,
    cam: Camera,
    width: int,
    height: int,
    key: jax.Array,
    opts: integ.RenderOptions,
    spp: int,
    mesh: Mesh,
    with_stats: bool = False,
):
    """One sharded render step → (W·H, 3) radiance *sum* over ``spp`` samples,
    laid out sharded over the ``pixels`` axis (replicated over ``samples``);
    with ``with_stats=True`` also the total live-segment count (``psum`` over
    both axes — the honest Mrays/s numerator).

    ``spp`` must divide by the samples-axis size; the pixel count is padded up to
    the pixels-axis size internally (static shapes — SURVEY §7 "dynamic-shape
    allergy").  RNG: ``jax.random`` keys folded per (sample-shard,
    pixel-shard) — deterministic in (seed, mesh shape) but NOT stream-exact
    against one device; see the module docstring for why the wavefront is
    the one engine outside the uniform contract.
    """
    d_s = mesh.shape["samples"]
    d_p = mesh.shape["pixels"]
    assert spp % d_s == 0, f"spp {spp} not divisible by samples axis {d_s}"
    spp_local = spp // d_s
    n = width * height
    n_pad = _pad_to(n, d_p)
    local_n = n_pad // d_p

    def step(scene, lights, cam, key):
        si = jax.lax.axis_index("samples")
        pi = jax.lax.axis_index("pixels")
        k_dev = jax.random.fold_in(jax.random.fold_in(key, si), pi)

        pix = pi * local_n + jnp.arange(local_n, dtype=jnp.int32)
        pix = jnp.minimum(pix, n - 1)  # padded tail re-renders the last pixel

        k_all = jax.random.split(k_dev, spp_local)
        k_cams, k_paths = jax.vmap(lambda k: tuple(jax.random.split(k)))(k_all)
        pools = jax.vmap(
            lambda k: camera_mod.generate_rays_for_pixels(
                cam, width, height, pix, key=k, jitter=opts.jitter
            )
        )(k_cams)
        flat = jax.tree.map(
            lambda x: x.reshape((spp_local * local_n,) + x.shape[2:]), pools
        )
        flat, segs = integ.trace(scene, lights, flat, k_dev, opts,
                                 with_stats=True)
        local_sum = flat.radiance.reshape(spp_local, local_n, 3).sum(axis=0)
        # DP reduction over the samples axis
        return (jax.lax.psum(local_sum, axis_name="samples"),
                jax.lax.psum(segs, axis_name=("samples", "pixels")))

    out, segs = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P("pixels"), P()),
        # the wavefront loops build carries from constants; skip the
        # varying-manual-axes bookkeeping (correctness is covered by tests)
        check_vma=False,
    )(scene, lights, cam, key)
    if with_stats:
        return out[:n], segs
    return out[:n]


def render_sharded(
    scene: Scene,
    lights: Lights,
    cam: Camera,
    width: int,
    height: int,
    opts: integ.RenderOptions,
    spp: int,
    mesh: Mesh,
    seed: int = 0,
    fb: Framebuffer | None = None,
    spp_per_step: int | None = None,
    progress=None,
) -> Framebuffer:
    """Progressive sharded accumulation (multi-device analogue of
    ``integ.render``)."""
    from mcpt.types import make_framebuffer

    d_s = mesh.shape["samples"]
    if spp_per_step is None:
        spp_per_step = d_s
    assert spp_per_step % d_s == 0
    # each sharded step renders a multiple of the samples-axis size; round the
    # request up ONCE so fb.count always equals the spp actually rendered
    spp = _pad_to(spp, d_s)
    if fb is None:
        fb = make_framebuffer(width * height)
    base = jax.random.key(seed)
    start = int(fb.count.max()) if fb.count.size else 0
    s = start
    while s < start + spp:
        step = min(spp_per_step, start + spp - s)
        step = (step // d_s) * d_s
        radiance = render_batch_sharded(
            scene, lights, cam, width, height, jax.random.fold_in(base, s),
            opts, step, mesh,
        )
        fb = integ.accumulate(fb, radiance, spp=step)
        s += step
        if progress is not None:
            progress(s, fb)
    return fb


def replicate(tree, mesh: Mesh):
    """Place a pytree replicated over the mesh (scene/BVH/materials/camera)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def render_mega_sharded(
    mega,
    cam: Camera,
    width: int,
    height: int,
    spp: int,
    mesh: Mesh,
    seed: int = 0,
    max_depth: int = 16,
    nee: bool = False,
    mis: bool = False,
    rr: bool = False,
    clamp: float = 0.0,
    interpret: bool = False,
):
    """Sharded megakernel render over BOTH mesh axes: each ``pixels`` shard
    renders only its contiguous pixel slice (true spatial sharding — the
    kernel's ``pixel_base`` hook), each ``samples`` shard renders global
    sample indices ``[si·spp/|samples|, (si+1)·spp/|samples|)`` via the
    kernel's ``sample_base`` hook with the SAME seed — every (sample, pixel)
    RNG stream matches the single-device schedule exactly, so the output is
    the same for any mesh shape up to f32 sum order.  The only collectives are the radiance
    ``psum`` over samples and the segment-count ``psum`` over both axes
    (the scene tables are small, so replication is cheap).

    Returns ``((W·H, 3) radiance sum over all spp, total segments traced)``;
    radiance is laid out sharded over the ``pixels`` axis.
    """
    from mcpt.pallas import megakernel as mk

    d_s = mesh.shape["samples"]
    d_p = mesh.shape["pixels"]
    assert spp % d_s == 0, (spp, d_s)
    spp_local = spp // d_s
    n = width * height
    n_pad = _pad_to(n, d_p)
    local_n = n_pad // d_p

    def step(tri, matt, lit, cbox, cam_):
        mega_local = mega._replace(tri=tri, matt=matt, lit=lit, cbox=cbox)
        si = jax.lax.axis_index("samples")
        pi = jax.lax.axis_index("pixels")
        rad, segs = mk.render_mega(
            mega_local, cam_, width, height, spp=spp_local, seed=seed,
            max_depth=max_depth, nee=nee, mis=mis, rr=rr, clamp=clamp,
            interpret=interpret,
            pixel_base=pi * local_n, pixel_count=local_n,
            sample_base=si * spp_local,
        )
        # DP reduction over samples; pixels need no collective (disjoint)
        return (jax.lax.psum(rad, axis_name="samples"),
                jax.lax.psum(segs, axis_name=("samples", "pixels")))

    out, segs = jax.jit(
        shard_map(
            step,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=(P("pixels"), P()),
            check_vma=False,
        )
    )(mega.tri, mega.matt, mega.lit, mega.cbox, cam)
    return out[:n], segs
