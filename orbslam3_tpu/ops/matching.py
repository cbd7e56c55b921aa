"""Batch Hamming-distance matching primitives.

The reference computes 256-bit Hamming distances one pair at a time with SWAR
popcount inside nested scalar loops (/root/reference/src/ORBmatcher3.cc:637-653)
and prunes candidates through per-frame grids / BoW buckets.  Here the whole
distance field is one dense matrix product over the unpacked descriptor bits,
with candidate pruning expressed as masks on the distance matrix instead of
control flow.

The device stereo LR matcher (frontend/stereo_frame.py) is a mask-builder over
`hamming_matrix`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

TH_LOW = 50        # ORBmatcher.h:91-93 thresholds
TH_HIGH = 100
HISTO_LENGTH = 30

# Sentinel added to masked-out entries; > 256 so it never wins an argmin.
BIG = jnp.int32(1 << 15)


def unpack_bits(desc: jax.Array) -> jax.Array:
    """(N, 32) uint8 -> (N, 256) bit matrix (LSB-first per byte, as packed)."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint8(1)
    return bits.reshape(desc.shape[0], 256)


def hamming_matrix(desc_a: jax.Array, desc_b: jax.Array) -> jax.Array:
    """(Na, Nb) int32 Hamming distances between uint8 descriptor blocks.

    desc_*: (N, 32) uint8.  Unpacked to a (N, 256) 0/1 bit matrix and
    computed as one matrix product —
        ham(a, b) = |a| + |b| - 2 a.b
    bf16 operands (values <= 256 are exact in bf16) with f32 accumulation.
    """
    bits_a = unpack_bits(desc_a).astype(jnp.bfloat16)
    bits_b = unpack_bits(desc_b).astype(jnp.bfloat16)
    ab = jnp.dot(bits_a, bits_b.T, preferred_element_type=jnp.float32)
    pa = jnp.sum(bits_a.astype(jnp.float32), axis=1)
    pb = jnp.sum(bits_b.astype(jnp.float32), axis=1)
    return (pa[:, None] + pb[None, :] - 2.0 * ab).astype(jnp.int32)


def rotation_histogram_mask(
    angle_a: jax.Array, angle_b: jax.Array, valid: jax.Array, n_keep: int = 3
) -> jax.Array:
    """Rotation-consistency check (ORBmatcher3.cc:592 semantics, vectorised).

    angle_a/angle_b: matched keypoint angles in degrees for each tentative
    match row; valid: (N,) bool of tentative matches.  Bins the angle
    difference into HISTO_LENGTH bins, keeps the `n_keep` most-populated bins.
    Returns the pruned validity mask.
    """
    rot = angle_a - angle_b
    rot = jnp.where(rot < 0, rot + 360.0, rot)
    factor = 1.0 / (360.0 / HISTO_LENGTH)
    bins = jnp.round(rot * factor).astype(jnp.int32)
    bins = jnp.where(bins == HISTO_LENGTH, 0, bins)
    bins = jnp.clip(bins, 0, HISTO_LENGTH - 1)
    counts = jnp.zeros(HISTO_LENGTH, jnp.int32).at[bins].add(valid.astype(jnp.int32))
    top, top_idx = jax.lax.top_k(counts, 3)
    # ComputeThreeMaxima: drop bin 2/3 when much smaller than the best
    keep2 = top[1].astype(jnp.float32) >= 0.1 * top[0].astype(jnp.float32)
    keep3 = top[2].astype(jnp.float32) >= 0.1 * top[0].astype(jnp.float32)
    keep_bin = (
        (bins == top_idx[0])
        | ((bins == top_idx[1]) & keep2)
        | ((bins == top_idx[2]) & keep3)
    )
    return valid & keep_bin & (counts[bins] > 0)
