"""Camera basis + primary-ray generation.

Reproduces the reference's camera model exactly (``auxiliary.cpp:20-71`` and
``kernels/rayGenerator.cl:10-28``): right-handed basis ``right = dir × up``,
``up = right × dir``; a pinhole ray through pixel (x, y) is

    d = forward · (0.5 / tan(fov/2)) + (x/W - 0.5) · right · (W/H) + (y/H - 0.5) · up

so row 0 is the image *bottom* (the reference vertically flips at write time,
``thirdpartywrapper.cpp:21``).  The orthographic camera offsets the origin instead
(``rayGenerator.cl:23-27``).

Differences from the reference, on purpose:

- optional sub-pixel jitter (the reference samples the exact pixel corner every
  attempt, ``rayGenerator.cl:10`` — no antialiasing; ground-truth renders are
  pixel-filtered, so jitter is on by default),
- counter-based threefry RNG instead of a per-pixel LCG (``shade.cl:1-6``).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from mcpt.config import CameraConfig
from mcpt.types import Camera, RayPool


def make_camera(cfg: CameraConfig, ortho_height: float | None = None) -> Camera:
    """Build the orthonormal camera basis on the host (``auxiliary.cpp:20-71``).

    ``cfg.ortho_height > 0`` (or the explicit kwarg) selects the orthographic
    camera (reference cameraType 1): rays share the forward direction and the
    origin sweeps a ``ortho_height``-tall view plane (``rayGenerator.cl:23-27``'s
    ``±arg/2`` span).  Otherwise a pinhole with ``fov`` degrees vertical —
    ``fov <= 0`` is rejected (every pixel would get the identical ray).
    """
    pos = np.asarray(cfg.position, np.float32)
    lookat = np.asarray(cfg.lookat, np.float32)
    up_in = np.asarray(cfg.up, np.float32)
    fwd = lookat - pos

    if ortho_height is None and cfg.ortho_height > 0.0:
        ortho_height = cfg.ortho_height
    is_ortho = ortho_height is not None
    if not is_ortho and cfg.fov <= 0.0:
        raise ValueError(
            f"fov must be > 0 for the perspective camera (got {cfg.fov}); "
            "set camera.ortho_height > 0 for the orthographic camera"
        )
    if not is_ortho:
        right = np.cross(fwd, up_in)
        up = np.cross(right, fwd)
    else:
        # ortho branch orthogonalizes up against fwd (auxiliary.cpp:53-61)
        up = up_in - (up_in @ fwd) / (fwd @ fwd) * fwd
        right = np.cross(fwd, up)

    def _norm(v):
        return v / np.linalg.norm(v)

    fov_rad = math.radians(cfg.fov)
    # pinhole: ray dir scale is 0.5/tan(fov/2) on the forward axis with ±0.5 spans
    # on up/right (rayGenerator.cl:17-18) ⇒ half_height = tan(fov/2).
    # ortho: ±ortho_height/2 origin span (rayGenerator.cl:26's ±arg/2)
    half_h = math.tan(fov_rad / 2.0) if not is_ortho else float(ortho_height) / 2.0
    w, h = cfg.resolution
    aspect = (w / h) if h else 1.0
    return Camera(
        position=jnp.asarray(pos),
        forward=jnp.asarray(_norm(fwd)),
        right=jnp.asarray(_norm(right)),
        up=jnp.asarray(_norm(up)),
        half_height=jnp.float32(half_h),
        half_width=jnp.float32(half_h * aspect),
        is_ortho=jnp.float32(1.0 if is_ortho else 0.0),
    )


def generate_rays(
    camera: Camera,
    width: int,
    height: int,
    key: jax.Array | None = None,
    jitter: bool = True,
) -> RayPool:
    """Generate one primary ray per pixel (``rayGenerator.cl:1-31`` semantics).

    Returns a RayPool of R = width·height rays, pixel id = y·W + x, throughput 1,
    depth/flags cleared — the reference resets ``term_depth`` and per-path
    throughput the same way each attempt (``rayGenerator.cl:29-30``,
    ``OpenCLApp.cpp:63``).
    """
    pix = jnp.arange(width * height, dtype=jnp.int32)
    return generate_rays_for_pixels(camera, width, height, pix, key=key,
                                    jitter=jitter)


def generate_rays_for_pixels(
    camera: Camera,
    width: int,
    height: int,
    pix: jnp.ndarray,
    key: jax.Array | None = None,
    jitter: bool = True,
) -> RayPool:
    """Primary rays for an explicit pixel-id slice — the building block for
    pixel-sharded rendering across a device mesh (each shard passes its own ids;
    no reference counterpart, the reference is single-device)."""
    n = pix.shape[0]
    px = (pix % width).astype(jnp.float32)
    py = (pix // width).astype(jnp.float32)
    if jitter and key is not None:
        off = jax.random.uniform(key, (n, 2), jnp.float32)
        px = px + off[:, 0]
        py = py + off[:, 1]
    else:
        # reference samples the exact pixel corner: point = id / extent
        pass
    sx = px / width - 0.5
    sy = py / height - 0.5

    fwd, right, up = camera.forward, camera.right, camera.up
    # pinhole (rayGenerator.cl:13-21): d = fwd*0.5/tan(fov/2) + sx*right*aspect + sy*up
    # — equivalently (normalizing by 2·tan(fov/2)): fwd + 2sx·half_w·right + 2sy·half_h·up
    d_pin = (
        fwd[None, :]
        + (2.0 * sx * camera.half_width)[:, None] * right[None, :]
        + (2.0 * sy * camera.half_height)[:, None] * up[None, :]
    )
    o_pin = jnp.broadcast_to(camera.position, (n, 3))
    # orthographic (rayGenerator.cl:23-27)
    o_ort = (
        camera.position[None, :]
        + (2.0 * sx * camera.half_width)[:, None] * right[None, :]
        + (2.0 * sy * camera.half_height)[:, None] * up[None, :]
    )
    d_ort = jnp.broadcast_to(fwd, (n, 3))

    w_ort = camera.is_ortho
    origin = o_pin * (1.0 - w_ort) + o_ort * w_ort
    direction = d_pin * (1.0 - w_ort) + d_ort * w_ort
    direction = direction / jnp.linalg.norm(direction, axis=1, keepdims=True)

    return RayPool(
        origin=origin,
        direction=direction,
        throughput=jnp.ones((n, 3), jnp.float32),
        radiance=jnp.zeros((n, 3), jnp.float32),
        pixel=pix,
        alive=jnp.ones((n,), bool),
        inside=jnp.zeros((n,), bool),
    )
