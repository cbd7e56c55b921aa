"""Per-keypoint window gathers and sampling as one-hot einsums.

Every per-keypoint read of the front-end (orientation moments, rBRIEF
samples, stereo SAD strips) goes through `gather_windows`,
`window_moments` or `sample_windows`.  Each is written as batched matmuls
against one-hot selection matrices:

    window[k] = rowOH[k] @ img @ colOH[k]^T     (separable selection)
    sample[k, s] = rowOH2[k, s] . window[k] . colOH2[k, s]

Exactness: every operand is a small non-negative integer (pixels <= 255,
one-hots 0/1) — all exactly representable in bfloat16 — and contractions
accumulate in float32 (exact for integers < 2^24), so results are
bit-identical to the gather formulation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def onehot_bf16(idx: jax.Array, n: int) -> jax.Array:
    """0/1 bf16 one-hot over the last axis: out[..., j] = (idx == j)."""
    iota = jax.lax.broadcasted_iota(jnp.int32, idx.shape + (n,), idx.ndim)
    return (idx[..., None] == iota).astype(jnp.bfloat16)


def extract_row_strips(
    img2d: jax.Array,
    row0: jax.Array,
    x0: jax.Array,
    nr: int,
    nc: int,
) -> jax.Array:
    """(K, nr, nc) windows from a 2D composite — window k reads
    img2d[row0[k]:row0[k]+nr, x0[k]:x0[k]+nc].

    The nr window rows are consecutive, so one base-row one-hot (K, H) is
    contracted against nr shifted image views instead of materialising a
    (K, nr, H) one-hot.  Bit-identical (one contributor per output)."""
    h, w = img2d.shape
    img2d = img2d.astype(jnp.bfloat16)
    base_oh = onehot_bf16(row0, h)                       # (K, H)
    img_pad = jnp.concatenate(
        [img2d, jnp.zeros((nr, w), img2d.dtype)], axis=0
    )
    strips = jnp.stack(
        [
            jnp.einsum(
                "kh,hw->kw",
                base_oh,
                jax.lax.dynamic_slice_in_dim(img_pad, r, h, 0),
                preferred_element_type=jnp.bfloat16,
            )
            for r in range(nr)
        ],
        axis=1,
    )  # (K, nr, W)
    cols = x0[:, None] + jnp.arange(nc, dtype=jnp.int32)[None, :]
    col_oh = onehot_bf16(cols, w)                        # (K, nc, W)
    return jnp.einsum(
        "krw,kcw->krc",
        strips,
        col_oh,
        preferred_element_type=jnp.float32,
    )


def sample_patches(patches: jax.Array, r: jax.Array, c: jax.Array) -> jax.Array:
    """samples[k, s] = patches[k, r[k, s], c[k, s]] via separable one-hots.

    patches: (K, Pr, Pc) f32 with small-int values; r, c: (K, S) int32 in
    [0, Pr) / [0, Pc).
    """
    pr, pc = patches.shape[1], patches.shape[2]
    row_oh = onehot_bf16(r, pr)  # (K, S, Pr)
    col_oh = onehot_bf16(c, pc)  # (K, S, Pc)
    strips = jnp.einsum(
        "ksp,kpq->ksq",
        row_oh,
        patches.astype(jnp.bfloat16),
        preferred_element_type=jnp.bfloat16,
    )  # selected pixels (<= 255, bf16-exact; one contributor per output)
    return jnp.einsum(
        "ksq,ksq->ks",
        strips,
        col_oh,
        preferred_element_type=jnp.float32,
    )


def gather_windows(
    img2d: jax.Array, row0: jax.Array, col0: jax.Array, nr: int, nc: int
) -> jax.Array:
    """(K, nr, nc) bf16 windows; window k = img2d[row0[k]:+nr, col0[k]:+nc].

    Starts are clamped into bounds (callers guarantee real windows are
    in-bounds; clamping only normalises masked/invalid slots).  bf16 is
    exact for the u8-valued pixels; consumers upcast before any reduction
    that can exceed bf16's integer range.
    """
    with jax.named_scope("gather_windows"):
        h, w = img2d.shape
        r = jnp.clip(row0.astype(jnp.int32), 0, h - nr)
        c = jnp.clip(col0.astype(jnp.int32), 0, w - nc)
        return extract_row_strips(img2d, r, c, nr, nc).astype(jnp.bfloat16)


def window_moments(
    img2d: jax.Array,
    row0: jax.Array,
    col0: jax.Array,
    w10: np.ndarray,
    w01: np.ndarray,
) -> tuple[jax.Array, jax.Array]:
    """(m10, m01) weighted window sums per keypoint; weights (nr, nc) are
    integer-valued host constants.  Exact: integer sums < 2^24 in f32."""
    nr, nc = w10.shape
    with jax.named_scope("window_moments"):
        patches = gather_windows(img2d, row0, col0, nr, nc)
        # both moments in ONE einsum: the (K, nr, nc) patch read happens
        # once instead of twice
        wb = jnp.asarray(np.stack([w10, w01]), jnp.bfloat16)
        m = jnp.einsum(
            "kpq,wpq->kw", patches, wb, preferred_element_type=jnp.float32
        )
        return m[:, 0], m[:, 1]


def sample_windows(
    img2d: jax.Array,
    row0: jax.Array,
    col0: jax.Array,
    ridx: jax.Array,
    cidx: jax.Array,
    nr: int,
    nc: int,
) -> jax.Array:
    """(K, S) samples; sample [k, s] = img2d[row0[k]+ridx[k,s], col0[k]+cidx[k,s]].

    ridx/cidx must lie in [0, nr) / [0, nc); row0/col0 are clamped like
    gather_windows."""
    with jax.named_scope("sample_windows"):
        patches = gather_windows(img2d, row0, col0, nr, nc)
        return sample_patches(patches, ridx, cidx)
