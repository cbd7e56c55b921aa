"""Device-side image pyramid: bilinear resize + fixed-point Gaussian blur.

All arithmetic is integer fixed point (order-independent, so
XLA may fuse/reorder freely without breaking bit-exactness vs the CPU oracle in
``orbslam3_tpu.oracle.orb_cpu``).  The resize matches cv2.resize INTER_LINEAR
for uint8 bit-exactly (the reference builds its pyramid with cv::resize,
/root/reference/src/ORBextractor.cc:1309-1329); the blur is the framework's
own 16-bit-fraction spec (see oracle module docstring for the rationale).

Shapes are static per level — the per-level Python loop unrolls under jit into
one fused XLA program; no host round-trips between levels.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from orbslam3_tpu.oracle.orb_cpu import (
    PyramidParams,
    _linear_coeffs,
    gaussian_kernel7_fixed,
)

_BLUR_K = [int(v) for v in gaussian_kernel7_fixed()]
_BLUR_HALF = 1 << 15


@functools.lru_cache(maxsize=None)
def _resize_mats(sh: int, sw: int, dh: int, dw: int):
    """Constant selection/tap matrices for one resize geometry.

    The horizontal pass a0*s[sx] + a1*s[sx+1] is a matmul against a (sw, dw)
    two-nonzeros-per-column tap matrix; the vertical pass needs its two row
    selections separately (per-term truncation), i.e. two (dh, sh) one-hot
    matrices, so the resize is matrix products instead of element gathers.
    Exactness: the 11-bit taps don't fit bf16, so the tap matrix
    is pre-split into two bf16-exact parts (hi + lo); bf16 x bf16 products
    accumulate exactly in f32 and every partial sum stays < 2^24.
    """
    import ml_dtypes

    sx, ax0, ax1 = _linear_coeffs(dw, sw)
    sy, by0, by1 = _linear_coeffs(dh, sh)
    sx1 = np.minimum(sx + 1, sw - 1)
    sy1 = np.minimum(sy + 1, sh - 1)
    mx = np.zeros((sw, dw), np.float32)
    np.add.at(mx, (sx, np.arange(dw)), ax0.astype(np.float32))
    np.add.at(mx, (sx1, np.arange(dw)), ax1.astype(np.float32))
    mx_hi = mx.astype(ml_dtypes.bfloat16)
    mx_lo = (mx - mx_hi.astype(np.float32)).astype(ml_dtypes.bfloat16)
    assert (mx_hi.astype(np.float32) + mx_lo.astype(np.float32) == mx).all()
    s0 = np.zeros((dh, sh), ml_dtypes.bfloat16)
    s0[np.arange(dh), sy] = 1.0
    s1 = np.zeros((dh, sh), ml_dtypes.bfloat16)
    s1[np.arange(dh), sy1] = 1.0
    return mx_hi, mx_lo, s0, s1, by0.astype(np.int32), by1.astype(np.int32)


def _rows_hi_lo(rows: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Byte-split of the horizontal-pass accumulator, all-f32 (exact: rows
    holds integers <= 522240 < 2^24; floor-scalings by powers of two are
    exact f32 ops)."""
    rows4 = jnp.floor(rows * jnp.float32(1 / 16.0))  # == rows >> 4, <= 32640
    hi = jnp.floor(rows4 * jnp.float32(1 / 256.0))
    lo = rows4 - 256.0 * hi
    return hi.astype(jnp.bfloat16), lo.astype(jnp.bfloat16)


def _vertical_term(by: jax.Array, h: jax.Array, l: jax.Array) -> jax.Array:
    """floor((by * (256*h + l)) / 2^16) in exact f32.

    by <= 2048, h <= 127, l <= 255: with r = 256*h + l,
    (by*r) >> 16 == (by*h + ((by*l) >> 8)) >> 8 — every intermediate is an
    integer < 2^24 (by*l <= 522240, by*h <= 260096), so f32 products and
    floor-scalings reproduce the int32 chain bit-exactly.
    """
    b1 = jnp.floor(by * l * jnp.float32(1 / 256.0))
    return jnp.floor((by * h + b1) * jnp.float32(1 / 256.0))


@functools.partial(jax.jit, static_argnums=(1, 2))
def resize_linear_u8(src: jax.Array, dh: int, dw: int) -> jax.Array:
    """Bit-exact cv2 INTER_LINEAR 8u resize (11-bit taps, 22-bit accumulator)."""
    sh, sw = src.shape
    mx_hi, mx_lo, s0, s1, by0, by1 = _resize_mats(sh, sw, dh, dw)
    srcb = src.astype(jnp.bfloat16)  # pixels <= 255 are bf16-exact
    rows = jnp.dot(srcb, jnp.asarray(mx_hi), preferred_element_type=jnp.float32)
    rows = rows + jnp.dot(srcb, jnp.asarray(mx_lo), preferred_element_type=jnp.float32)
    hi, lo = _rows_hi_lo(rows)

    def select(sel):
        sel = jnp.asarray(sel)
        return (
            jnp.dot(sel, hi, preferred_element_type=jnp.float32),
            jnp.dot(sel, lo, preferred_element_type=jnp.float32),
        )

    h0, l0 = select(s0)
    h1, l1 = select(s1)
    by0 = jnp.asarray(by0, jnp.float32)[:, None]
    by1 = jnp.asarray(by1, jnp.float32)[:, None]
    out = jnp.floor(
        (_vertical_term(by0, h0, l0) + _vertical_term(by1, h1, l1) + 2.0) * 0.25
    )
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def _reflect101_pad3(img: jax.Array) -> jax.Array:
    """Pad 3 px on each side with reflect-101 (no edge repeat)."""
    top = img[3:0:-1, :]
    bot = img[-2:-5:-1, :]
    v = jnp.concatenate([top, img, bot], axis=0)
    left = v[:, 3:0:-1]
    right = v[:, -2:-5:-1]
    return jnp.concatenate([left, v, right], axis=1)


@functools.partial(jax.jit, static_argnums=(1,))
def gaussian_blur7_u8(img: jax.Array, reflect: bool = True) -> jax.Array:
    """Separable 7-tap sigma=2 fixed-point blur, bit-exact vs the oracle.

    Computed in f32 FMAs: taps are non-negative 16-bit ints summing to
    65536 and pixels are u8, so every partial sum is an integer
    <= 255*65536 < 2^24 — exactly representable in f32 in any association
    order; the `(x + HALF) >> 16` rounding is floor((x + HALF) * 2^-16),
    exact for the same reason.  Bit-identical to the integer oracle.

    `reflect=False` zero-pads instead of reflect-101 — valid ONLY when the
    caller never consumes outputs within 3 px of the image edge (the merged
    bordered composite masks those out), which saves the narrow reflect `rev` ops.
    """
    h, w = img.shape
    if reflect:
        pad = _reflect101_pad3(img.astype(jnp.float32))
    else:
        pad = jnp.pad(img, 3).astype(jnp.float32)
    inv16 = jnp.float32(1.0 / 65536.0)
    half = jnp.float32(_BLUR_HALF)
    hp = sum(jnp.float32(_BLUR_K[i]) * pad[:, i : i + w] for i in range(7))
    hp = jnp.floor((hp + half) * inv16)
    vp = sum(jnp.float32(_BLUR_K[i]) * hp[i : i + h, :] for i in range(7))
    out = jnp.floor((vp + half) * inv16)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@functools.lru_cache(maxsize=None)
def _fused_pyramid_mats(sh: int, sw: int, sizes: tuple):
    """Concatenated tap/selection matrices for ALL levels at once.

    Direct-from-native resizing (see oracle.build_pyramid) has no level
    dependency chain, so the horizontal passes fuse into ONE (sw, sum_w)
    matmul and the vertical selections into ONE (sum_h, sh) matmul; the
    level images are the diagonal blocks of the (sum_h, sum_w) result.
    ~8x fewer (and far larger) ops than per-level resizing — the chain was
    latency-bound at ~2 ms/frame, this runs in ~0.3 ms.
    """
    import ml_dtypes

    mx_hi, mx_lo, s0, s1, by0, by1 = [], [], [], [], [], []
    for (dh, dw) in sizes:
        a, b, c, d, e, f = _resize_mats(sh, sw, dh, dw)
        mx_hi.append(a)
        mx_lo.append(b)
        s0.append(c)
        s1.append(d)
        by0.append(e)
        by1.append(f)
    return (
        np.concatenate(mx_hi, axis=1),           # (sw, sum_w) bf16
        np.concatenate(mx_lo, axis=1),
        np.concatenate(s0, axis=0),              # (sum_h, sh) bf16
        np.concatenate(s1, axis=0),
        np.concatenate(by0)[:, None].astype(np.int32),  # (sum_h, 1)
        np.concatenate(by1)[:, None].astype(np.int32),
    )


def build_pyramid(image: jax.Array, params: PyramidParams) -> list[jax.Array]:
    """All pyramid levels (uint8); level l is a bit-exact cv2 INTER_LINEAR
    resize of the native image (oracle.build_pyramid semantics).

    The horizontal tap pass is SHARED across levels (one (sh, sum_w)
    matmul — every level reads the same source rows), but the vertical row
    selections run per level: the earlier all-levels formulation computed a
    full (sum_h, sum_w) product and kept only its diagonal blocks, wasting
    ~4x the matmul work (off-diagonal blocks select level A's rows against
    level B's columns and are discarded)."""
    sh, sw = image.shape
    sizes = params.level_sizes(sh, sw)[1:]
    if not sizes:
        return [image]
    mx_hi, mx_lo, s0c, s1c, by0c, by1c = _fused_pyramid_mats(sh, sw, tuple(sizes))
    srcb = image.astype(jnp.bfloat16)
    rows = jnp.dot(srcb, jnp.asarray(mx_hi), preferred_element_type=jnp.float32)
    rows = rows + jnp.dot(srcb, jnp.asarray(mx_lo), preferred_element_type=jnp.float32)
    hi, lo = _rows_hi_lo(rows)                 # (sh, sum_w) bf16 bytes

    levels = [image]
    y = x = 0
    for (dh, dw) in sizes:
        s0 = jnp.asarray(s0c[y : y + dh])      # (dh, sh) one-hot
        s1 = jnp.asarray(s1c[y : y + dh])
        hi_l = hi[:, x : x + dw]
        lo_l = lo[:, x : x + dw]

        def select(sel):
            return (
                jnp.dot(sel, hi_l, preferred_element_type=jnp.float32),
                jnp.dot(sel, lo_l, preferred_element_type=jnp.float32),
            )

        h0, l0 = select(s0)
        h1, l1 = select(s1)
        by0 = jnp.asarray(by0c[y : y + dh], jnp.float32)
        by1 = jnp.asarray(by1c[y : y + dh], jnp.float32)
        out = jnp.floor(
            (_vertical_term(by0, h0, l0) + _vertical_term(by1, h1, l1) + 2.0)
            * 0.25
        )
        levels.append(jnp.clip(out, 0, 255).astype(jnp.uint8))
        y += dh
        x += dw
    return levels
