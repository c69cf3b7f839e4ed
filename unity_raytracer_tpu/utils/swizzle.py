"""Pixel-block swizzle: remap row-major pixels into bs x bs screen blocks.

The BVH walk kernel (ops/pallas/walk.py) runs a block of rays until its
longest walk ends and fetches node rows for all of them at once, so lanes
of one block should be spatial neighbours. Row-major lanes make a block a
strip of one scanline; swizzling lanes into 32x32 screen blocks makes each
block a compact square whose rays visit much the same nodes.

The reference sorts its pixel loop for cache locality for the same reason
("Traverse order swapped for better cache usage",
Demo-RayTracing/RayTracingSetup.cs:286).

Two implementations:

* ``block_perm`` — explicit permutation arrays (kept for equivalence
  tests); applying it costs a gather per array.
* the production path — rays are GENERATED in block order
  (models/camera.generate_rays_blocks, pure integer lane math) on a
  padded whole-block grid, and ``unswizzle_image`` restores row-major
  with one reshape+transpose (a relayout, not a gather).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


def padded_dims(width: int, height: int, bs: int) -> Tuple[int, int]:
    """(Wp, Hp): image dims rounded up to whole bs x bs blocks."""
    if bs <= 1:
        return width, height
    return -(-width // bs) * bs, -(-height // bs) * bs


def unswizzle_image(rad, width: int, height: int, bs: int):
    """Block-ordered radiance [Wp*Hp, C] -> row-major image [H, W, C].

    Inverse of models/camera.generate_rays_blocks's lane order: lanes are
    (block row, block col, in-block row, in-block col); a single 5-d
    reshape + transpose restores (row, col) and the pad margin is cropped.
    """
    import jax.numpy as jnp
    c = rad.shape[-1]
    if bs <= 1:
        return rad.reshape(height, width, c)
    wp, hp = padded_dims(width, height, bs)
    # per-channel 4-d transposes ([Hb,bs,Wb,bs] relayouts) instead of a
    # 5-d transpose with a size-3 minor axis
    chans = [
        jnp.transpose(rad[:, k].reshape(hp // bs, wp // bs, bs, bs),
                      (0, 2, 1, 3)).reshape(hp, wp)
        for k in range(c)
    ]
    return jnp.stack(chans, axis=-1)[:height, :width]


def swizzle_image(img, bs: int):
    """Row-major image [H, W, C] -> block-ordered lanes [Wp*Hp, C]
    (inverse of unswizzle_image, pad margin zero-filled) — puts a target
    image into generate_rays_blocks's lane order for ray-space losses."""
    import jax.numpy as jnp
    h, w, c = img.shape
    if bs <= 1:
        return img.reshape(-1, c)
    wp, hp = padded_dims(w, h, bs)
    img = jnp.pad(img, ((0, hp - h), (0, wp - w), (0, 0)))
    chans = [
        jnp.transpose(img[:, :, k].reshape(hp // bs, bs, wp // bs, bs),
                      (0, 2, 1, 3)).reshape(-1)
        for k in range(c)
    ]
    return jnp.stack(chans, axis=-1)


@functools.lru_cache(maxsize=32)
def block_perm(width: int, height: int, bs: int = 32
               ) -> Tuple[np.ndarray, np.ndarray]:
    if bs <= 1:
        eye = np.arange(width * height, dtype=np.int32)
        return eye, eye
    ys, xs = np.mgrid[0:height, 0:width]
    # unique sort key: (block row, block col, in-block row-major offset)
    key = (((ys // bs) * ((width + bs - 1) // bs) + (xs // bs))
           * (bs * bs) + (ys % bs) * bs + (xs % bs))
    perm = np.argsort(key.ravel(), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return perm, inv
