"""Fused stereo frame front-end: L+R extraction + rectified LR matching.

One jitted XLA program per image geometry runs *everything* the reference's
stereo Frame constructor does on the perception side (two extractor calls on
two std::threads + the sequential row-bucketed CPU matcher,
/root/reference/src/Frame.cc:102-143,841-1011): pyramid, FAST, selection,
orientation, descriptors for both cameras, then the dense masked Hamming
match with SAD subpixel refinement and the median-distance filter.

Design notes:
 - left/right run as two unrolled instances inside one program (XLA
   schedules them freely; no image-axis vmap);
 - candidate pruning (row band, octave window, disparity range) is additive
   masking on the K x K Hamming matrix — no row buckets, no control flow;
 - SAD refinement gathers 11x21 strips per keypoint slot from the
   bordered pyramid composite (ops/patches.gather_windows);
 - the median-of-SAD outlier filter is a masked sort (the reference sorts a
   dynamic vector on the host).

Semantics match ``orbslam3_tpu.oracle.stereo_cpu`` bit-exactly (which see,
for the documented deviations from the reference).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_tpu.oracle.orb_cpu import PyramidParams
from orbslam3_tpu.ops.extractor import FrameFeatures, extract_from_pyramid
from orbslam3_tpu.ops.matching import BIG, TH_HIGH, TH_LOW, hamming_matrix
from orbslam3_tpu.ops.patches import gather_windows
from orbslam3_tpu.ops.pyramid import build_pyramid

SAD_W = 5
SAD_L = 5

# EuRoC-like defaults for the benchmark path (cam0 pinhole, ~0.11 m baseline)
DEFAULT_FX = 435.2046959714599
DEFAULT_MBF = 47.90639384423901


class StereoFrameFeatures(NamedTuple):
    left: FrameFeatures
    right: FrameFeatures
    u_right: jax.Array  # (K,) f32 — refined right x per left slot, -1 if none
    depth: jax.Array    # (K,) f32 — mbf/disparity, -1 if none


def stereo_match(
    feat_l: FrameFeatures,
    feat_r: FrameFeatures,
    stack_l: tuple,   # (composite (sum_h, W), (L,) numpy row origins, (L,) numpy col origins)
    stack_r: tuple,
    level_hw: np.ndarray,       # (L, 2) static per-level (h, w)
    scale_factors: np.ndarray,  # (L,) static
    mbf: float,
    mb: float,
) -> tuple[jax.Array, jax.Array]:
    """Device LR matcher; returns (u_right, depth) per left keypoint slot."""
    th_orb = (TH_HIGH + TH_LOW) // 2
    max_d = mbf / mb
    scales = jnp.asarray(scale_factors, jnp.float32)
    inv_scales = 1.0 / scales
    h_tab = jnp.asarray(level_hw[:, 0], jnp.int32)
    w_tab = jnp.asarray(level_hw[:, 1], jnp.int32)

    ul, vl = feat_l.xy[:, 0], feat_l.xy[:, 1]
    ur, vr = feat_r.xy[:, 0], feat_r.xy[:, 1]
    oct_l, oct_r = feat_l.octave, feat_r.octave

    # per-keypoint lookups from the tiny (L,) level tables as masked
    # reduces instead of (K,)-from-(L,) fancy indexing; a single
    # contributor keeps the sums exact
    n_lvl = scales.shape[0]
    oh_l = oct_l[:, None] == jnp.arange(n_lvl, dtype=jnp.int32)[None, :]
    oh_r = oct_r[:, None] == jnp.arange(n_lvl, dtype=jnp.int32)[None, :]

    def lut(onehot, table):
        return jnp.where(onehot, table[None, :], jnp.zeros_like(table[:1])).sum(axis=1)

    # --- candidate masks over the K x K pair grid -------------------------
    row = vl.astype(jnp.int32).astype(jnp.float32)  # trunc(vL), as reference
    r_r = 2.0 * lut(oh_r, scales)
    row_ok = (row[:, None] >= jnp.floor(vr - r_r)[None, :]) & (
        row[:, None] <= jnp.ceil(vr + r_r)[None, :]
    )
    oct_ok = (oct_r[None, :] >= oct_l[:, None] - 1) & (
        oct_r[None, :] <= oct_l[:, None] + 1
    )
    u_ok = (ur[None, :] >= (ul - max_d)[:, None]) & (ur[None, :] <= ul[:, None])
    pair_ok = row_ok & oct_ok & u_ok & feat_l.valid[:, None] & feat_r.valid[None, :]

    dist = hamming_matrix(feat_l.desc, feat_r.desc)
    d = jnp.where(pair_ok, dist, BIG)
    best_r = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_dist = d.min(axis=1)  # == value at argmin, without a scalar gather
    tentative = best_dist < th_orb

    # --- SAD subpixel refinement at the left keypoint's level -------------
    inv = lut(oh_l, inv_scales)
    sul = jnp.round(ul * inv).astype(jnp.int32)
    svl = jnp.round(vl * inv).astype(jnp.int32)
    # winner pickup as a masked reduce (one contributor -> the f32 sum is
    # exact)
    win_oh = (
        jax.lax.broadcasted_iota(jnp.int32, d.shape, 1) == best_r[:, None]
    )
    ur0 = jnp.where(win_oh, ur[None, :], 0.0).sum(axis=1)
    sur0 = jnp.round(ur0 * inv).astype(jnp.int32)
    lh = lut(oh_l, h_tab).astype(jnp.int32)
    lw = lut(oh_l, w_tab).astype(jnp.int32)
    in_bounds = (
        (svl - SAD_W >= 0) & (svl + SAD_W + 1 <= lh)
        & (sul - SAD_W >= 0) & (sul + SAD_W + 1 <= lw)
        & (sur0 - SAD_L - SAD_W >= 0) & (sur0 + SAD_L + SAD_W + 1 <= lw)
    )
    comp_l, row_off_l, col0_l = stack_l
    comp_r, row_off_r, col0_r = stack_r
    wl, ww = 2 * SAD_W + 1, 2 * (SAD_L + SAD_W) + 1
    # per-level clips keep every (masked-or-not) window inside its level's
    # block of the composite
    cl_svl = jnp.clip(svl - SAD_W, 0, lh - wl)
    cl_sul = jnp.clip(sul - SAD_W, 0, lw - wl)
    cl_sur = jnp.clip(sur0 - SAD_L - SAD_W, 0, lw - ww)
    off_l = lut(oh_l, jnp.asarray(row_off_l)).astype(jnp.int32)
    off_r = lut(oh_l, jnp.asarray(row_off_r)).astype(jnp.int32)
    coff_l = lut(oh_l, jnp.asarray(col0_l)).astype(jnp.int32)
    coff_r = lut(oh_l, jnp.asarray(col0_r)).astype(jnp.int32)
    p_l = gather_windows(comp_l, off_l + cl_svl, coff_l + cl_sul, wl, wl)
    p_r = gather_windows(comp_r, off_r + cl_svl, coff_r + cl_sur, wl, ww)
    # SAD in (slide, row*col, K) layout: one contiguous reduce over the
    # 121 window pixels per slide.  Exact: |u8 diffs| sum to integers
    # < 2^24, so f32 reassociation cannot change a bit.
    pl_t = jnp.transpose(p_l, (2, 1, 0))  # (11, 11, K)
    pr_t = jnp.transpose(p_r, (2, 1, 0))  # (21, 11, K)
    k_slots = p_l.shape[0]
    pl2 = pl_t.reshape(wl * wl, k_slots)  # (121, K)
    # one (231, K) repack of the right strips; slide j's 121 window rows are
    # then the CONTIGUOUS row block [j*11, j*11+121) — views instead of 11
    # slice+reshape copies
    pr2 = pr_t.reshape(ww * wl, k_slots)
    slides = jnp.stack(
        [
            jax.lax.slice_in_dim(pr2, j * wl, j * wl + wl * wl, axis=0)
            for j in range(2 * SAD_L + 1)
        ]
    )  # (11, 121, K)
    # gathers arrive bf16 (u8-exact); diffs stay integer-exact in bf16 and
    # the reduction accumulates in f32 (sums < 2^15) — bit-identical
    dists = jnp.abs(pl2[None] - slides).sum(axis=1, dtype=jnp.float32).T  # (K, 11)
    best_j = jnp.argmin(dists, axis=1).astype(jnp.int32)
    sad = dists.min(axis=1)  # == dists[best_j]
    inc_ok = (best_j > 0) & (best_j < 2 * SAD_L)
    jm = jnp.clip(best_j, 1, 2 * SAD_L - 1)
    # neighbor pickup over the tiny slide axis as one-hot reduces
    jiota = jax.lax.broadcasted_iota(jnp.int32, dists.shape, 1)

    def at_lane(j):
        return jnp.where(jiota == j[:, None], dists, 0.0).sum(axis=1).astype(jnp.float32)

    d1 = at_lane(jm - 1)
    d2 = at_lane(jm)
    d3 = at_lane(jm + 1)
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = jnp.where(denom != 0, (d1 - d3) / denom, 0.0)
    delta_ok = (delta >= -1.0) & (delta <= 1.0)

    best_ur = lut(oh_l, scales) * (
        sur0.astype(jnp.float32) + (best_j - SAD_L).astype(jnp.float32) + delta
    )
    disparity = ul - best_ur
    disp_ok = (disparity >= 0.0) & (disparity < max_d)
    clamped = disparity <= 0.0
    disparity = jnp.where(clamped, 0.01, disparity)
    best_ur = jnp.where(clamped, ul - 0.01, best_ur)

    ok = tentative & in_bounds & inc_ok & delta_ok & disp_ok

    # --- median-of-SAD outlier filter ------------------------------------
    n_ok = ok.sum()
    sorted_sad = jnp.sort(jnp.where(ok, sad, BIG))
    median = sorted_sad[jnp.minimum(n_ok // 2, sad.shape[0] - 1)].astype(jnp.float32)
    th = 1.5 * 1.4 * median
    ok = ok & jnp.where(n_ok > 0, sad.astype(jnp.float32) < th, False)

    u_right = jnp.where(ok, best_ur, -1.0)
    depth = jnp.where(ok, mbf / disparity, -1.0)
    return u_right, depth


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def extract_and_match_stereo_sequence(
    pairs: jax.Array,
    params: PyramidParams,
    mbf: float = DEFAULT_MBF,
    fx: float = DEFAULT_FX,
) -> StereoFrameFeatures:
    """Offline/mapping throughput path: (N, 2, H, W) uint8 stereo pairs
    through the fused front-end in ONE dispatch (lax.scan over frames;
    leaves stacked along a leading N axis).  Amortises per-dispatch latency
    for batch jobs — the real-time loop uses `extract_and_match_stereo` /
    `prefetch_stereo` instead."""

    def body(_, pair):
        return None, extract_and_match_stereo.__wrapped__(pair, params, mbf, fx)

    return jax.lax.scan(body, None, pairs)[1]


def _extract_and_match_stereo_impl(
    pair: jax.Array,
    params: PyramidParams,
    mbf: float = DEFAULT_MBF,
    fx: float = DEFAULT_FX,
) -> StereoFrameFeatures:
    """pair: (2, H, W) uint8 — the full stereo perception front-end, fused."""
    pyr_l = build_pyramid(pair[0], params)
    pyr_r = build_pyramid(pair[1], params)
    # BOTH cameras' FAST detection in one composite pass (16 crops, one
    # score + NMS/retry instead of two of each), then both
    # cameras' selection/orientation/descriptors through the camera-merged
    # extraction core (one top_k, one orientation gather, one BRIEF gather)
    from orbslam3_tpu.ops.extractor import detection_crops, extract_from_pyramids
    from orbslam3_tpu.ops.fast import detect_two_threshold_multi

    act_l, crops_l = detection_crops(pyr_l, params)
    act_r, crops_r = detection_crops(pyr_r, params)
    score_list = detect_two_threshold_multi(
        crops_l + crops_r, params.ini_th_fast, params.min_th_fast
    )
    from orbslam3_tpu.ops.extractor import build_merged_composites

    comps = build_merged_composites([pyr_l, pyr_r])
    feat_l, feat_r = extract_from_pyramids(
        [pyr_l, pyr_r],
        params,
        [
            dict(zip(act_l, score_list[: len(act_l)])),
            dict(zip(act_r, score_list[len(act_l) :])),
        ],
        comps=comps,
    )
    # the SAD refinement reads the same bordered raw composite (interior
    # offset +pad folds into the per-level offsets)
    p = comps.pad
    stack_l = (
        comps.bordered,
        np.asarray(comps.y0[0], np.int32) + p,
        np.asarray(comps.x0[0], np.int32) + p,
    )
    stack_r = (
        comps.bordered,
        np.asarray(comps.y0[1], np.int32) + p,
        np.asarray(comps.x0[1], np.int32) + p,
    )
    level_hw = np.array([lvl.shape for lvl in pyr_l], np.int32)
    u_right, depth = stereo_match(
        feat_l,
        feat_r,
        stack_l,
        stack_r,
        level_hw,
        params.scale_factors.astype(np.float32),
        mbf,
        mbf / fx,
    )
    return StereoFrameFeatures(feat_l, feat_r, u_right, depth)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def extract_and_match_stereo(
    pair: jax.Array,
    params: PyramidParams,
    mbf: float = DEFAULT_MBF,
    fx: float = DEFAULT_FX,
) -> StereoFrameFeatures:
    """pair: (2, H, W) uint8 — the full stereo perception front-end, fused."""
    return _extract_and_match_stereo_impl(pair, params, mbf, fx)


# columns of the packed host-transfer layout (see pack_for_host)
_PACK_COLS = 40  # x, y, response, angle, octave, valid, u_right, depth, desc[32]


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def extract_and_match_stereo_packed(
    pair: jax.Array,
    params: PyramidParams,
    mbf: float = DEFAULT_MBF,
    fx: float = DEFAULT_FX,
) -> jax.Array:
    """extract_and_match_stereo + device-side packing into ONE (K, 40) f32.

    Fetching StereoFrameFeatures leaf by leaf costs ~10 device->host
    transfers per frame.  The tracker only consumes the LEFT camera block +
    u_right/depth; packing those into one f32 matrix (descriptor bytes are
    <= 255, f32-exact) makes the transfer a single buffer.  Unpack with `unpack_host_features`.
    """
    # call the pure implementation, not the (possibly monkeypatched/
    # memoized) module attribute — this runs under jit
    out = _extract_and_match_stereo_impl(pair, params, mbf, fx)
    return _pack_features(out)


def _pack_features(out: "StereoFrameFeatures") -> jax.Array:
    l = out.left
    cols = [
        l.xy[:, 0], l.xy[:, 1],
        l.response, l.angle,
        l.octave.astype(jnp.float32), l.valid.astype(jnp.float32),
        out.u_right, out.depth,
    ]
    packed = jnp.stack(cols, axis=1)
    return jnp.concatenate([packed, l.desc.astype(jnp.float32)], axis=1)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def extract_and_match_stereo_packed_batch(
    pairs: jax.Array,
    params: PyramidParams,
    mbf: float = DEFAULT_MBF,
    fx: float = DEFAULT_FX,
) -> jax.Array:
    """(B, 2, H, W) uint8 -> (B, K, 40): B stereo front-ends in ONE
    dispatch.  Serves mapping-rate / multi-robot throughput workloads and
    the prefetch pipeline's batched dispatch unit
    (System.prefetch_stereo_batch) — the latency-critical per-frame loop
    keeps the unbatched program.

    Internally a lax.scan, not a vmap: sequential scan iterations reuse the
    single-frame program's layout.  Row b is the single-frame program on
    pairs[b], bit for bit."""

    def body(_, pair):
        return None, _pack_features(
            _extract_and_match_stereo_impl(pair, params, mbf, fx)
        )

    return jax.lax.scan(body, None, pairs)[1]


def unpack_host_features(arr: np.ndarray) -> dict:
    """Host-side inverse of extract_and_match_stereo_packed (compacted)."""
    valid = arr[:, 5] > 0.5
    a = arr[valid]
    return dict(
        kps=a[:, 0:2],
        response=a[:, 2],
        angle=a[:, 3],
        octave=a[:, 4].astype(np.int32),
        u_right=a[:, 6],
        depth=a[:, 7],
        desc=a[:, 8:40].astype(np.uint8),
    )
