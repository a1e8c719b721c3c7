"""Core SoA pytrees: scene, materials, BVH, camera, ray pool, render state.

The reference packs everything into AoS C structs shared between host and device
(``objdef.h:21-99``: ``Camera``, ``Ray`` with bit-packed depth/inside/terminated state,
``Triangle`` as 3×float4 + union'd normal/materialID, ``Material``, ``BVHNode``).
A data-parallel design wants structure-of-arrays with static shapes so XLA can lay
each field out densely — so every struct here is a NamedTuple-of-arrays pytree,
and the reference's bit-packing (``objdef.h:29-39``) becomes explicit ``depth`` /
``inside`` / ``alive`` arrays that XLA fuses for free.

Layout contract kept from the reference (``BVH/hlbvh.cpp:164-193``): a flattened BVH
over N triangles has ``2N-1`` nodes, internal nodes at ``[0, N-2]``, leaves at
``[N-1, 2N-2]``, root ``0``, and a leaf's ``left == right == triangle id``.  Keeping
this exact contract lets the traversal kernels and the quality-metrics harness
(``mcpt.bvh.metrics``) consume any builder's output interchangeably.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# Material type codes — same values as the reference enum (objdef.h:58-67).
DIFFUSE = 1
GLOSSY = 2
TRANSPARENT = 3
LIGHT = 4

# Geometric epsilon for origin offsets (reference oclbasic.h:193 EPSILON=0.001f).
EPSILON = 1e-3


class Materials(NamedTuple):
    """SoA material table (reference ``objdef.h:69-79`` ``Material``).

    Unlike the reference loader, which *prescales* BRDF constants at load time
    (``thirdpartywrapper.cpp:85-87``: kd ← Kd/π, ks ← Ks·(Ns+2)·(2/π)), we store the
    raw .mtl values; normalization lives in the BSDF code (``mcpt.render.shade``)
    where it is auditable.
    """

    mtype: jnp.ndarray  # (M,)  int32 — DIFFUSE/GLOSSY/TRANSPARENT/LIGHT
    kd: jnp.ndarray  # (M, 3) f32 — diffuse reflectance
    ks: jnp.ndarray  # (M, 3) f32 — specular reflectance (glossy)
    ka: jnp.ndarray  # (M, 3) f32 — emission (LIGHT) per reference convention
    ns: jnp.ndarray  # (M,)  f32 — phong exponent
    ni: jnp.ndarray  # (M,)  f32 — index of refraction

    @property
    def count(self) -> int:
        return self.mtype.shape[0]


class Geometry(NamedTuple):
    """Triangle soup with baked per-face data (reference ``scenebuild.cpp:58-62``)."""

    verts: jnp.ndarray  # (N, 3, 3) f32 — triangle vertices
    normals: jnp.ndarray  # (N, 3) f32 — geometric normals (unit)
    mat_id: jnp.ndarray  # (N,) int32

    @property
    def count(self) -> int:
        return self.verts.shape[0]


class BVH(NamedTuple):
    """Flattened SoA BVH, layout contract in the module docstring."""

    bbmin: jnp.ndarray  # (2N-1, 3) f32
    bbmax: jnp.ndarray  # (2N-1, 3) f32
    left: jnp.ndarray  # (2N-1,) int32 — child node id; for leaves: triangle id
    right: jnp.ndarray  # (2N-1,) int32
    parent: jnp.ndarray  # (2N-1,) int32 — -1 for root

    @property
    def n_nodes(self) -> int:
        return self.left.shape[0]

    @property
    def n_tris(self) -> int:
        return (self.n_nodes + 1) // 2

    def is_leaf(self, node):
        n = self.n_tris
        if n == 1:  # degenerate single-triangle scene: the root is the only leaf
            return jnp.ones_like(node, dtype=bool)
        return node >= n - 1


class WaldTris(NamedTuple):
    """Precomputed unit-triangle affine transforms (Wald-style) packed for
    matmul-shaped intersection: for triangle i, ``A_i`` maps world space so the
    triangle becomes the unit triangle in the (u, v) plane with its plane at
    w = 0.  A ray transforms as ``o' = o @ W + B``, ``d' = d @ W`` (one fused
    (R,3)×(3,3T) contraction each), then ``t = -o'_w/d'_w``,
    ``u = o'_u + t·d'_u``, ``v = o'_v + t·d'_v`` — ~15 VPU flops per ray-triangle
    test instead of the ~60 of Möller–Trumbore.  This replaces the reference's
    per-ray 4×4-inverse test (``objdef.h:178-221``)."""

    w: jnp.ndarray  # (3, T, 3) f32 — A_i^T columns, laid out for (R,3)@(3,T·3)
    b: jnp.ndarray  # (T, 3) f32 — affine offsets


class Scene(NamedTuple):
    geom: Geometry
    materials: Materials
    bvh: BVH
    # Scale-aware geometric epsilon for ray-origin offsets and shadow-ray clipping.
    # The reference uses a fixed EPSILON=0.001 (oclbasic.h:193) — below float32
    # precision for 550-unit scenes like cbox; we derive it from the root AABB
    # diagonal at build time instead.
    eps: jnp.ndarray = jnp.float32(EPSILON)
    # Precomputed Wald transforms for the matmul-shaped brute intersector
    # (built by mcpt.scene.build_scene; None only in hand-rolled test scenes).
    wald: "WaldTris | None" = None

    @property
    def n_tris(self) -> int:
        return self.geom.count


class Camera(NamedTuple):
    """Orthonormal camera basis (reference ``auxiliary.cpp:20-71`` ``parseCamera``).

    ``tmin == 0`` selects the pinhole camera, ``tmin == -inf`` the orthographic one —
    the same encoding the reference uses (``auxiliary.cpp:47,66``; consumed by
    ``rayGenerator.cl:10-28`` as cameraType 0/1).
    """

    position: jnp.ndarray  # (3,)
    forward: jnp.ndarray  # (3,) unit, towards lookat
    right: jnp.ndarray  # (3,) unit
    up: jnp.ndarray  # (3,) unit
    half_height: jnp.ndarray  # () tan(fov/2) for pinhole; world half-height for ortho
    half_width: jnp.ndarray  # () half_height * aspect
    is_ortho: jnp.ndarray  # () f32, 1.0 = orthographic — branches blended via where


class RayPool(NamedTuple):
    """Wavefront ray state, one entry per live path (R = W·H·spp_batch).

    Replaces the reference's bit-packed ``Ray`` (``objdef.h:29-39``): depth bits 0-15,
    inside-flag ``0x00FF0000`` and terminated-flag ``0xFF000000`` become explicit
    arrays.
    """

    origin: jnp.ndarray  # (R, 3) f32
    direction: jnp.ndarray  # (R, 3) f32 unit
    throughput: jnp.ndarray  # (R, 3) f32 — path weight so far
    radiance: jnp.ndarray  # (R, 3) f32 — accumulated emitted radiance
    pixel: jnp.ndarray  # (R,) int32 — destination pixel id
    alive: jnp.ndarray  # (R,) bool
    inside: jnp.ndarray  # (R,) bool — inside a transparent medium

    @property
    def count(self) -> int:
        return self.origin.shape[0]


class Hit(NamedTuple):
    """Closest-hit record (reference ``objdef.h:41-48`` ``Hit``)."""

    t: jnp.ndarray  # (R,) f32 — inf on miss
    tri: jnp.ndarray  # (R,) int32 — -1 on miss
    point: jnp.ndarray  # (R, 3) f32
    normal: jnp.ndarray  # (R, 3) f32 — geometric, NOT yet flipped to face the ray

    @property
    def valid(self):
        return self.tri >= 0


class Framebuffer(NamedTuple):
    """Progressive accumulation state (reference ``colorout.cpp:23-24,49-50``).

    The reference stores a running mean and skips black/saturated samples
    (``history.cl:15-23``) which biases the estimate; we keep an exact (sum, count)
    pair and divide at readout — an unbiased running mean, and trivially
    all-reducible across a device mesh (sum and count are both additive).
    """

    sum: jnp.ndarray  # (H*W, 3) f32 — Σ radiance samples
    count: jnp.ndarray  # (H*W,) f32 — samples accumulated per pixel

    @property
    def mean(self) -> jnp.ndarray:
        return self.sum / jnp.maximum(self.count, 1.0)[:, None]


def make_framebuffer(n_pixels: int) -> Framebuffer:
    return Framebuffer(
        sum=jnp.zeros((n_pixels, 3), jnp.float32),
        count=jnp.zeros((n_pixels,), jnp.float32),
    )


def materials_from_numpy(
    mtype, kd, ks, ka, ns, ni
) -> Materials:
    return Materials(
        mtype=jnp.asarray(np.asarray(mtype), jnp.int32),
        kd=jnp.asarray(np.asarray(kd), jnp.float32).reshape(-1, 3),
        ks=jnp.asarray(np.asarray(ks), jnp.float32).reshape(-1, 3),
        ka=jnp.asarray(np.asarray(ka), jnp.float32).reshape(-1, 3),
        ns=jnp.asarray(np.asarray(ns), jnp.float32).reshape(-1),
        ni=jnp.asarray(np.asarray(ni), jnp.float32).reshape(-1),
    )


def geometry_from_verts(verts, mat_id) -> Geometry:
    """Bake geometric normals from vertex winding (reference ``scenebuild.cpp:58-62``)."""
    v = np.asarray(verts, np.float32).reshape(-1, 3, 3)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    length = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(length, 1e-20)
    return Geometry(
        verts=jnp.asarray(v),
        normals=jnp.asarray(n, jnp.float32),
        mat_id=jnp.asarray(np.asarray(mat_id), jnp.int32).reshape(-1),
    )
