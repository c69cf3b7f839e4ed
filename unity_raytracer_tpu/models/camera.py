"""Pinhole camera + batched primary-ray generation.

Reference model: explicit physical image plane (not FOV) — ``ImagePlane``
holds resolution, distance-to-camera and half extents
(Data/Camera/ImagePlane.cs:11-45); the camera basis is position/forward/
right/up (Data/Camera/CameraData.cs:5-11). Primary rays go through pixel
centers: ``topLeft + (x+0.5)*hLen/resX * right - (y+0.5)*vLen/resY * up``
(Demo-RayTracing/RayTracingSetup.cs:291-298). Pixel (0,0) is top-left; +x
right, +y down (ImagePlane.cs doc comment).

The reference computes this in a scalar double loop; here it is one
broadcasted tensor expression producing a flat ``[H*W, 3]`` ray batch — the
wavefront layout every downstream kernel consumes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera pose + image plane. ``width``/``height`` are static metadata."""

    position: jnp.ndarray   # [3]
    forward: jnp.ndarray    # [3] unit
    right: jnp.ndarray      # [3] unit
    up: jnp.ndarray         # [3] unit
    dist: jnp.ndarray       # [] image-plane distance to camera
    half_h: jnp.ndarray     # [] half horizontal extent
    half_v: jnp.ndarray     # [] half vertical extent
    width: int = dataclasses.field(metadata=dict(static=True), default=0)
    height: int = dataclasses.field(metadata=dict(static=True), default=0)

    @staticmethod
    def make(position=(0.0, 0.0, 0.0), forward=(0.0, 0.0, 1.0),
             up=(0.0, 1.0, 0.0), dist: float = 10.0, half_h: float = 20.0,
             half_v: float = 10.0, width: int = 50, height: int = 50) -> "Camera":
        f = np.asarray(forward, np.float32)
        f = f / np.linalg.norm(f)
        u = np.asarray(up, np.float32)
        r = np.cross(f, u)          # left-handed Unity basis: right = fwd x up
        r = r / np.linalg.norm(r)
        u = np.cross(r, f)
        u = u / np.linalg.norm(u)
        return Camera(
            position=jnp.asarray(position, jnp.float32),
            forward=jnp.asarray(f), right=jnp.asarray(r), up=jnp.asarray(u),
            dist=jnp.float32(dist), half_h=jnp.float32(half_h),
            half_v=jnp.float32(half_v), width=int(width), height=int(height))

    @staticmethod
    def from_fov(position, look_at, up=(0.0, 1.0, 0.0), fov_y_deg: float = 45.0,
                 dist: float = 1.0, width: int = 512, height: int = 512) -> "Camera":
        """Convenience constructor by FOV (the reference has no FOV camera)."""
        p = np.asarray(position, np.float32)
        f = np.asarray(look_at, np.float32) - p
        half_v = dist * np.tan(np.deg2rad(fov_y_deg) * 0.5)
        half_h = half_v * (width / height)
        return Camera.make(position=p, forward=f, up=up, dist=dist,
                           half_h=float(half_h), half_v=float(half_v),
                           width=width, height=height)


def generate_rays_blocks(cam: Camera, bs: int
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Primary rays emitted directly in bs x bs pixel-block order.

    Each walk-kernel block steps its rays until its longest walk ends, so
    neighbouring lanes should walk alike (utils/swizzle.py). Rather than
    permuting row-major rays with a gather, the pixel coordinates are
    computed analytically from the block-ordered lane id with integer ops:
    zero data movement.

    The image is padded up to whole blocks (Wp = ceil(W/bs)*bs etc.); pad
    lanes get valid rays through out-of-frame pixel centers (same image
    plane formula, RayTracingSetup.cs:291-298) and are cropped at image
    assembly (utils/swizzle.unswizzle_image). Returns ``(o [Np,3],
    d [Np,3])`` with ``Np = Wp*Hp``.
    """
    w, h = cam.width, cam.height
    wp = -(-w // bs) * bs
    hp = -(-h // bs) * bs
    n = wp * hp
    lane = jnp.arange(n, dtype=jnp.int32)
    wb = wp // bs
    blk = lane // (bs * bs)
    off = lane % (bs * bs)
    y = (blk // wb) * bs + off // bs
    x = (blk % wb) * bs + off % bs

    center = cam.position + cam.forward * cam.dist
    top_left = center - cam.right * cam.half_h + cam.up * cam.half_v
    xs = (x.astype(jnp.float32) + 0.5) * (2.0 * cam.half_h / w)
    ys = (y.astype(jnp.float32) + 0.5) * (2.0 * cam.half_v / h)
    # SoA per-component math (three [N] lanes, no size-3 minor axis).
    # Operation ORDER matches the original [N,3] formulation bitwise
    # ((top_left + xs*r - ys*u) - pos, then sqrt+divide) so golden images
    # and silhouette-edge pixel decisions are unchanged.
    dx = (top_left[0] + xs * cam.right[0] - ys * cam.up[0]) - cam.position[0]
    dy = (top_left[1] + xs * cam.right[1] - ys * cam.up[1]) - cam.position[1]
    dz = (top_left[2] + xs * cam.right[2] - ys * cam.up[2]) - cam.position[2]
    nrm = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    d = jnp.stack([dx / nrm, dy / nrm, dz / nrm], axis=-1)
    o = jnp.broadcast_to(cam.position, (n, 3))
    return o, d


def generate_rays(cam: Camera) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Primary rays through all pixel centers.

    Returns ``(origins [N,3], directions [N,3])`` with ``N = H*W`` flattened
    row-major (x + y*W — the reference framebuffer index,
    RayTracingSetup.cs:243-245). Directions are unit. Same arithmetic as
    ``generate_rays_blocks`` (bs=1 is row-major order), so images match
    bitwise across lane orders.
    """
    return generate_rays_blocks(cam, 1)
