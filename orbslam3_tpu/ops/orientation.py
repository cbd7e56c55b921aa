"""IC-angle keypoint orientation.

One 31x31 window per keypoint (ops/patches.window_moments), then two exact
weighted reductions for the intensity-centroid moments and an
f32 atan2.  Unlike the reference's OpenCL kernel — which drops the cross-lane
reduction of the partial sums (a known bug, SURVEY §2 G4) — this implements
the semantically-correct full reduction, matching the reference's CPU path.
Integer moments are order-independent, so the result is bit-identical to the
oracle regardless of XLA's reduction order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_tpu.oracle.orb_cpu import HALF_PATCH_SIZE, ic_moment_weights
from orbslam3_tpu.ops.patches import window_moments

_W10_NP, _W01_NP = ic_moment_weights()


def patch_moments(img: jax.Array, xy: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(m10, m01) moments of the circular 31x31 patches at integer xy.

    Windows come from the one-hot gather (ops/patches.py); the weighted
    reductions are bf16 x bf16 -> f32 einsums (weights in [-15, 15] and pixels <= 255 are
    bf16-exact; |moments| <= 3.7M < 2^24 is f32-exact), so results equal the
    oracle's integer sums bit-for-bit.
    """
    return window_moments(
        img,
        xy[:, 1] - HALF_PATCH_SIZE,
        xy[:, 0] - HALF_PATCH_SIZE,
        _W10_NP.astype(np.float32),
        _W01_NP.astype(np.float32),
    )


@jax.jit
def ic_angles(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Angles in degrees [0, 360) for integer keypoint centers xy (N, 2)."""
    m10, m01 = patch_moments(img, xy)
    ang = jnp.degrees(jnp.arctan2(m01.astype(jnp.float32), m10.astype(jnp.float32)))
    return jnp.where(ang < 0, ang + 360.0, ang)
