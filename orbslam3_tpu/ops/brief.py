"""Rotated-BRIEF (rBRIEF) 256-bit descriptors.

The reference computes one byte per OpenCL lane from 16 rotated point-pair
tests (/root/reference/src/OpenCL/Kernel/Orb.cl:36-90).  Here the whole
descriptor block is one vectorised program: rotate all 512 pattern points for
all keypoints in f32 (cvRound == rint, matching the oracle's f32 arithmetic),
pull the 512 samples per keypoint with the one-hot window sampler
(ops/patches.sample_windows), then compare the 256 pairs and pack bits
with a weighted sum against powers of two.

Sampling buffer: the rotated pattern reaches up to 18 px from the center
while keypoints sit only >= 16 px from the level edge, so sampling uses the
reference's bordered-buffer semantics — a 19 px reflect-101 border of the
*raw* level image around the blurred interior (see
oracle.orb_cpu.brief_sampling_image; the reference builds each pyramid level
inside such an allocation and blurs only the interior view).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_tpu.ops.brief_pattern import BIT_PATTERN_31
from orbslam3_tpu.ops.patches import sample_windows

BRIEF_PAD = 19   # border width of the sampling buffer (reference EDGE_THRESHOLD)
PATCH_HALF = 18  # max rounded rotated pattern offset

_FACTOR_PI = np.float32(math.pi / 180.0)
# (256, 2) point pairs -> (512,) flat points, even = p0, odd = p1
_PX = np.concatenate([BIT_PATTERN_31[:, [0, 2]].reshape(-1)]).astype(np.float32)
_PY = np.concatenate([BIT_PATTERN_31[:, [1, 3]].reshape(-1)]).astype(np.float32)
_POW2 = np.array([1, 2, 4, 8, 16, 32, 64, 128], dtype=np.int32)


def _reflect101_pad(img: jax.Array, p: int) -> jax.Array:
    top = img[p:0:-1, :]
    bot = img[-2 : -2 - p : -1, :]
    v = jnp.concatenate([top, img, bot], axis=0)
    left = v[:, p:0:-1]
    right = v[:, -2 : -2 - p : -1]
    return jnp.concatenate([left, v, right], axis=1)


def brief_sampling_image(raw: jax.Array, blurred: jax.Array) -> jax.Array:
    """Blurred interior inside a reflect-101 border of the raw level image."""
    pad = _reflect101_pad(raw, BRIEF_PAD)
    return pad.at[BRIEF_PAD:-BRIEF_PAD, BRIEF_PAD:-BRIEF_PAD].set(blurred)


@jax.jit
def brief_descriptors(
    sampling_img: jax.Array,
    xy: jax.Array,
    angles_deg: jax.Array,
    trig: tuple[jax.Array, jax.Array] | None = None,
) -> jax.Array:
    """(N, 32) uint8 descriptors.

    sampling_img: bordered composite from `brief_sampling_image`;
    xy: (N, 2) f32 level coords (un-bordered); angles: (N,) degrees.
    Bit-exact vs the oracle given identical (cos, sin); platform trig may
    differ by ulps, which the tests bound separately (pass `trig` to pin it).
    """
    if trig is not None:
        a = trig[0].astype(jnp.float32)[:, None]
        b = trig[1].astype(jnp.float32)[:, None]
    else:
        ang = angles_deg.astype(jnp.float32) * _FACTOR_PI
        a = jnp.cos(ang)[:, None]  # (N, 1)
        b = jnp.sin(ang)[:, None]
    px = jnp.asarray(_PX)[None, :]  # (1, 512)
    py = jnp.asarray(_PY)[None, :]
    cy = jnp.rint(xy[:, 1]).astype(jnp.int32) + BRIEF_PAD
    cx = jnp.rint(xy[:, 0]).astype(jnp.int32) + BRIEF_PAD
    r_off = jnp.rint(px * b + py * a).astype(jnp.int32)  # (N, 512) in [-18, 18]
    c_off = jnp.rint(px * a - py * b).astype(jnp.int32)

    samples = sample_windows(
        sampling_img, cy - PATCH_HALF, cx - PATCH_HALF,
        r_off + PATCH_HALF, c_off + PATCH_HALF,
        2 * PATCH_HALF + 1, 2 * PATCH_HALF + 1,
    )

    t0 = samples[:, 0::2]
    t1 = samples[:, 1::2]
    bits = (t0 < t1).astype(jnp.int32).reshape(-1, 32, 8)  # (N, 32 bytes, 8 bits)
    return jnp.sum(bits * jnp.asarray(_POW2)[None, None, :], axis=-1).astype(jnp.uint8)
