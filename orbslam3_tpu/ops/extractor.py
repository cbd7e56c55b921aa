"""Fused single-dispatch ORB extraction pipeline.

The reference issues ~32 synchronous kernel launches + host round-trips per
camera per frame (SURVEY §3.2) — its main inefficiency.  Here the *entire*
extraction (pyramid, blur, FAST, selection, orientation, descriptors, output
packing) is one jitted XLA program per image geometry: one dispatch, zero host
syncs, everything HBM-resident.  Stereo runs as a batch of two via vmap.

API parity: `ORBextractor::operator()` (/root/reference/include/ORBextractor.h:66-68)
returns keypoints + descriptors + a mono/stereo lapping split; here the device
returns a fixed-size `FrameFeatures` slot block (per-level blocks of static
quota with validity masks) and the lapping split is a cheap host/post step
(`split_lapping`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam3_tpu.oracle.orb_cpu import FAST_BORDER, PATCH_SIZE, PyramidParams
from orbslam3_tpu.ops.pyramid import build_pyramid, gaussian_blur7_u8
from orbslam3_tpu.ops.fast import (
    detect_two_threshold,
    detect_two_threshold_multi,
    shelf_pack,
)
from orbslam3_tpu.ops.select import select_topk_grid_multi
from orbslam3_tpu.ops.orientation import ic_angles
from orbslam3_tpu.ops.brief import (
    BRIEF_PAD,
    _reflect101_pad,
    brief_descriptors,
    brief_sampling_image,
)


class MergedComposites(NamedTuple):
    """Camera-merged bordered composites shared by orientation, BRIEF and
    the stereo SAD refinement.

    `bordered` stacks every (camera, level) as a reflect-101 bordered raw
    block (right-padded with zeros to a common width); `sampling` is the
    same layout with the level interiors replaced by their 7x7 sigma=2
    blur — the reference's descriptor-buffer semantics (each pyramid level
    lives inside a bordered allocation whose interior alone is blurred,
    /root/reference/src/ORBextractor.cc:1270-1273 + EDGE_THRESHOLD borders).
    Building `sampling` as ONE composite blur + a static interior-mask
    select is bit-identical to per-level blurring (blur radius 3 <= the
    border band, so no interior output reads across a seam) and replaces
    2 x L per-level blur programs + interior update-slices with one fused
    pass.

    The band is 4 px, not the reference's EDGE_THRESHOLD=19: the only
    consumers of border pixels are BRIEF's rotated-pattern overhang
    (reach 18 from keypoints that sit >= 16 px inside the level -> <= 2 px
    out) and the blur's 3-px halo; orientation (radius 15) and the SAD
    windows (in_bounds-gated) never leave the interior.  Reflect-101 of
    any band >= 3 yields the same consumed values as the reference's
    19-px allocation, and the composite shrinks ~15% (blur + select +
    gather-pin work scale with area).
    """

    bordered: jax.Array   # (sum_h, wmax) u8 — raw, `pad`-px borders per block
    sampling: jax.Array   # same shape — blurred interiors, raw borders
    y0: tuple             # y0[cam][level]: block top-left row
    x0: tuple             # x0[cam][level]: block top-left column
    pad: int              # border band width (>= 3; see class docstring)


COMPOSITE_BAND = 4


def build_merged_composites(pyramids: list[list[jax.Array]]) -> MergedComposites:
    import numpy as _np

    p = COMPOSITE_BAND
    blocks = [img for pyr in pyramids for img in pyr]
    # 2-D shelf packing (first-fit over existing shelves, descending block
    # width): narrow high levels stacked at the level-0 width waste ~25% of
    # the composite as zero columns, and blur, interior-select and the
    # window gathers all scale with composite area.  Correctness is the same
    # argument as the detection composite (ops/fast.py): every block keeps
    # its own `p`-px reflect band, and no consumer window reads past its
    # block's band, so blocks can sit side by side.
    hb = [img.shape[0] + 2 * p for img in blocks]
    wb = [img.shape[1] + 2 * p for img in blocks]
    w_comp = max(wb)
    order = sorted(range(len(blocks)), key=lambda b: (-wb[b], -hb[b], b))
    place, shelves = shelf_pack(hb, wb, w_comp, order=order)
    # Reflect borders for ALL blocks ride ONE stacked reverse per side
    # (narrow per-block revs are op-overhead bound: 2L row revs + 2L lane
    # revs collapse to 4 ops).  Columns first, rows second — reflect-101
    # is separable, so the corner pixels come out identical to per-block
    # cv2-style padding.
    lefts = jnp.concatenate([img[:, 1 : 1 + p] for img in blocks])[:, ::-1]
    rights = jnp.concatenate(
        [img[:, img.shape[1] - 1 - p : img.shape[1] - 1] for img in blocks]
    )[:, ::-1]
    cv = []
    y = 0
    for img in blocks:
        h, w = img.shape
        cv.append(jnp.concatenate([lefts[y : y + h], img, rights[y : y + h]], axis=1))
        y += h
    # stacking the strips in REVERSED block order makes the single global
    # [::-1] both flip each strip's rows (the reflect) and restore block
    # order: rev(concat([T_n.., T_0])) == concat([rev(T_0), .., rev(T_n)])
    # (widths differ per block now, so the side-border strips — full block
    # width each — stack per side at width w_comp and are sliced back)
    padded_cv = [jnp.pad(v, ((0, 0), (0, w_comp - v.shape[1]))) for v in cv]
    tops = jnp.concatenate([v[1 : 1 + p] for v in reversed(padded_cv)])[::-1]
    bots = jnp.concatenate(
        [v[v.shape[0] - 1 - p : v.shape[0] - 1] for v in reversed(padded_cv)]
    )[::-1]
    by_shelf: dict[int, list] = {}
    for b in range(len(blocks)):
        by_shelf.setdefault(place[b][0], []).append(b)
    shelf_rows = []
    interior = []
    for sy0, sh, _ in shelves:
        x_cur, pieces = 0, []
        for b in sorted(by_shelf[sy0], key=lambda b: place[b][1]):
            tile = jnp.concatenate(
                [
                    tops[b * p : (b + 1) * p, : wb[b]],
                    cv[b],
                    bots[b * p : (b + 1) * p, : wb[b]],
                ]
            )
            if sh - hb[b]:
                tile = jnp.pad(tile, ((0, sh - hb[b]), (0, 0)))
            pieces.append(tile)
            x_cur = place[b][1] + wb[b]
            interior.append(
                (sy0 + p, place[b][1] + p) + blocks[b].shape
            )
        if w_comp - x_cur:
            pieces.append(jnp.zeros((sh, w_comp - x_cur), blocks[0].dtype))
        shelf_rows.append(jnp.concatenate(pieces, axis=1))
    bordered = jnp.concatenate(shelf_rows, axis=0)
    y0_all, x0_all, i = [], [], 0
    for pyr in pyramids:
        y0_all.append(tuple(place[b][0] for b in range(i, i + len(pyr))))
        x0_all.append(tuple(place[b][1] for b in range(i, i + len(pyr))))
        i += len(pyr)
    mask = _np.zeros(bordered.shape, bool)
    for (iy, ix, h, w) in interior:
        mask[iy : iy + h, ix : ix + w] = True
    # zero-pad blur: every surviving (interior) output sits >= `p` (>= 4) px
    # from the composite edge (block bands never abut the composite edge
    # closer than their own band), so the 3-px pad values are never consumed
    sampling = jnp.where(
        jnp.asarray(mask), gaussian_blur7_u8(bordered, reflect=False), bordered
    )
    return MergedComposites(bordered, sampling, tuple(y0_all), tuple(x0_all), p)


class FrameFeatures(NamedTuple):
    """Fixed-size keypoint block; invalid slots are masked, not removed."""

    xy: jax.Array        # (K, 2) f32 — level-0 (full-res) coordinates
    response: jax.Array  # (K,) f32 — FAST corner score
    angle: jax.Array     # (K,) f32 — IC angle, degrees [0, 360)
    octave: jax.Array    # (K,) i32 — pyramid level
    size: jax.Array      # (K,) f32 — PATCH_SIZE * scale_factor[octave]
    valid: jax.Array     # (K,) bool
    desc: jax.Array      # (K, 32) u8 — rBRIEF

    @property
    def max_keypoints(self) -> int:
        return self.xy.shape[-2]


def _empty_level_block(k: int) -> FrameFeatures:
    return FrameFeatures(
        xy=jnp.zeros((k, 2), jnp.float32),
        response=jnp.zeros((k,), jnp.float32),
        angle=jnp.zeros((k,), jnp.float32),
        octave=jnp.zeros((k,), jnp.int32),
        size=jnp.zeros((k,), jnp.float32),
        valid=jnp.zeros((k,), bool),
        desc=jnp.zeros((k, 32), jnp.uint8),
    )


def extract_features(
    image: jax.Array, params: PyramidParams
) -> FrameFeatures:
    """Full ORB extraction of one grayscale uint8 image. Trace-once per shape."""
    return extract_from_pyramid(build_pyramid(image, params), params)


def detection_crops(
    pyramid: list[jax.Array], params: PyramidParams
) -> tuple[list[int], list[jax.Array]]:
    """(active levels, FAST detection crops) for a pyramid — callers can
    batch crops from SEVERAL pyramids (e.g. the stereo pair) into one
    `detect_two_threshold_multi` composite pass."""
    quotas = [int(q) for q in params.features_per_level()]
    b = FAST_BORDER
    active, crops = [], []
    for level, img in enumerate(pyramid):
        h, w = img.shape
        ch, cw = h - 2 * b, w - 2 * b
        if ch >= 7 and cw >= 7 and quotas[level] > 0:
            active.append(level)
            crops.append(img[b : h - b, b : w - b])
    return active, crops


def extract_from_pyramid(
    pyramid: list[jax.Array],
    params: PyramidParams,
    scores: dict[int, jax.Array] | None = None,
) -> FrameFeatures:
    """Extraction given a prebuilt pyramid (lets callers reuse the levels).

    `scores` (level -> NMS'd score crop) skips detection — the stereo path
    computes both cameras' detections in one composite pass.  Standard
    geometries route through the merged-composite core (one composite blur
    + one orientation/BRIEF gather across all levels) exactly like the
    stereo pair; irregular geometries fall back to the per-level path."""
    if scores is None:
        active, crops = detection_crops(pyramid, params)
        score_list = detect_two_threshold_multi(
            crops, params.ini_th_fast, params.min_th_fast
        )
        scores = dict(zip(active, score_list))
    return extract_from_pyramids([pyramid], params, [scores])[0]


def extract_from_pyramids(
    pyramids: list[list[jax.Array]],
    params: PyramidParams,
    scores_list: list[dict[int, jax.Array]],
    comps: MergedComposites | None = None,
) -> list[FrameFeatures]:
    """Extraction for SEVERAL cameras' pyramids with shared device work.

    For the standard geometry (every level active at full quota, e.g. the
    stereo pair) the cameras share ONE batched top-k selection, ONE
    orientation gather and ONE descriptor gather over camera-stacked
    composites — half the per-frame gather and einsum work items of
    per-camera extraction.  Bit-identical to the per-camera
    path: the batched top_k is row-independent, and composites stack
    whole cameras vertically (windows never cross a camera seam for the
    same reason they never cross level seams — the >= 19 px per-level
    borders).  Falls back to per-camera extraction for irregular
    geometries."""
    b = FAST_BORDER
    quotas = [int(q) for q in params.features_per_level()]

    def flat_info(pyramid, scores):
        sel_levels = [l for l in range(len(pyramid)) if l in scores]
        k_effs = [
            min(quotas[l],
                (pyramid[l].shape[0] - 2 * b) * (pyramid[l].shape[1] - 2 * b))
            for l in sel_levels
        ]
        flat = sel_levels == list(range(len(pyramid))) and all(
            ke == quotas[l] for ke, l in zip(k_effs, sel_levels)
        )
        return flat, sel_levels, k_effs

    infos = [flat_info(p, s) for p, s in zip(pyramids, scores_list)]
    if not all(i[0] for i in infos):
        return [
            _extract_single(p, params, s)
            for p, s in zip(pyramids, scores_list)
        ]

    scales = params.scale_factors
    n_cams = len(pyramids)
    sel_levels = infos[0][1]
    k_effs = infos[0][2]
    # ONE batched top_k across every (camera, level) score map
    all_scores = [
        scores_list[c][l] for c in range(n_cams) for l in sel_levels
    ]
    selections_flat = select_topk_grid_multi(all_scores, k_effs * n_cams)
    k_cam = sum(k_effs)

    # per-camera slot metadata (host-constant parts shared across cameras)
    scale_vec = np.repeat(
        np.asarray([1.0] + [float(s) for s in scales[1:]], np.float32),
        quotas,
    )
    oct_np = np.repeat(np.arange(len(quotas), dtype=np.int32), quotas)
    size_np = (PATCH_SIZE * scale_vec).astype(np.float32)

    xy_cats, resp_cats, valid_cats, safe_cats = [], [], [], []
    for c in range(n_cams):
        sel = selections_flat[c * len(sel_levels) : (c + 1) * len(sel_levels)]
        xy_cat = jnp.concatenate([s[0] for s in sel]) + b
        resp_cat = jnp.concatenate([s[1] for s in sel])
        valid_cat = jnp.concatenate([s[2] for s in sel])
        xy_cats.append(xy_cat)
        resp_cats.append(resp_cat)
        valid_cats.append(valid_cat)
        safe_cats.append(jnp.where(valid_cat[:, None], xy_cat, b + 3))

    # camera-merged bordered composites shared by orientation + BRIEF (and
    # reused by the stereo SAD refinement when the caller passes them in)
    if comps is None:
        comps = build_merged_composites(pyramids)
    p = comps.pad

    def _offsets(extra):
        # per-slot (x, y) block origins — host constants, zero device ops
        row = np.concatenate(
            [
                np.repeat(np.asarray(comps.y0[c], np.int32), k_effs)
                for c in range(n_cams)
            ]
        )
        col = np.concatenate(
            [
                np.repeat(np.asarray(comps.x0[c], np.int32), k_effs)
                for c in range(n_cams)
            ]
        )
        return jnp.asarray(np.stack([col + extra, row + extra], axis=1))

    xy_all = jnp.concatenate(safe_cats)
    # orientation reads RAW pixels: gather from the bordered composite with
    # the +pad interior offset folded in
    angles_all = ic_angles(comps.bordered, xy_all + _offsets(p))
    # brief_descriptors adds BRIEF_PAD (19) to both coords internally;
    # offset by (pad - 19) so the net shift lands on the composite's
    # interior origin whatever the band width
    desc_all = brief_descriptors(
        comps.sampling,
        (xy_all + _offsets(p - BRIEF_PAD)).astype(jnp.float32),
        angles_all,
    )

    out = []
    for c in range(n_cams):
        v = valid_cats[c]
        angles = angles_all[c * k_cam : (c + 1) * k_cam]
        desc = desc_all[c * k_cam : (c + 1) * k_cam]
        out.append(
            FrameFeatures(
                xy=jnp.where(
                    v[:, None],
                    xy_cats[c].astype(jnp.float32)
                    * jnp.asarray(scale_vec)[:, None],
                    0.0,
                ),
                response=jnp.where(v, resp_cats[c].astype(jnp.float32), 0.0),
                angle=jnp.where(v, angles, 0.0),
                octave=jnp.asarray(oct_np),
                size=jnp.asarray(size_np),
                valid=v,
                desc=jnp.where(v[:, None], desc, 0),
            )
        )
    return out


def _extract_single(
    pyramid: list[jax.Array],
    params: PyramidParams,
    scores: dict[int, jax.Array] | None = None,
) -> FrameFeatures:
    quotas = [int(q) for q in params.features_per_level()]
    scales = params.scale_factors
    b = FAST_BORDER
    if scores is None:
        # FAST detection for every level in ONE composite pass (one score
        # + NMS/retry instead of eight of each)
        active, crops = detection_crops(pyramid, params)
        score_list = detect_two_threshold_multi(
            crops, params.ini_th_fast, params.min_th_fast
        )
        scores = dict(zip(active, score_list))
    # one batched top_k across all levels (select_topk_grid_multi) instead
    # of 8 per-level top_k dispatches — bit-identical, ~2x less select time
    sel_levels = [l for l in range(len(pyramid)) if l in scores]
    k_effs = [
        min(quotas[l],
            (pyramid[l].shape[0] - 2 * b) * (pyramid[l].shape[1] - 2 * b))
        for l in sel_levels
    ]
    selections = dict(
        zip(sel_levels,
            select_topk_grid_multi([scores[l] for l in sel_levels], k_effs))
    )
    # ---- cross-level batched orientation + BRIEF ----
    # All levels' keypoints are processed by ONE moments gather/einsum and
    # ONE descriptor gather/sampler over vertically-stacked composites
    # (2 window gathers per camera instead of 16, and the per-keypoint
    # einsums run at full batch).  Bit-exact: level regions are
    # separated by their own borders (orientation keypoints sit >= 19 px
    # inside each level; BRIEF's rotated pattern reach 18 < the 19-px
    # per-level reflect border), so no window crosses a level seam, and all
    # coordinates are integral (composite row offsets commute with rint).
    # fast path: every level active at its full static quota (the standard
    # EuRoC-like geometry) — assemble per-slot metadata with whole-array ops
    # instead of ~20 tiny per-level HLOs x L levels (at 1801 device ops per
    # stereo program, per-op sequencer overhead is a measurable cost)
    flat = sel_levels == list(range(len(pyramid))) and all(
        ke == quotas[l] for ke, l in zip(k_effs, sel_levels)
    )
    safe_xys, level_meta = [], []
    if flat:
        xy_cat = jnp.concatenate([selections[l][0] for l in sel_levels]) + b
        resp_cat = jnp.concatenate([selections[l][1] for l in sel_levels])
        valid_cat = jnp.concatenate([selections[l][2] for l in sel_levels])
        safe_cat = jnp.where(valid_cat[:, None], xy_cat, b + 3)
        safe_xys = [safe_cat]  # one composite "level" for the y0 offsets
        level_meta = None
    else:
        for level in sel_levels:
            xy_c, resp, valid = selections[level]
            xy_i = xy_c + b  # add detection border back (addBorder semantics)
            safe_xy = jnp.where(valid[:, None], xy_i, b + 3)  # in-bounds slices
            safe_xys.append(safe_xy)
            level_meta.append((level, xy_i, resp, valid))
    if sel_levels:
        raw_wmax = max(pyramid[l].shape[1] for l in sel_levels)
        samp_wmax = raw_wmax + 2 * 19  # BRIEF_PAD borders
        raw_rows, samp_rows, y0_raw, y0_samp = [], [], [], []
        for level in sel_levels:
            img = pyramid[level]
            h, w = img.shape
            blurred = gaussian_blur7_u8(img)
            samp = brief_sampling_image(img, blurred)
            y0_raw.append(sum(r.shape[0] for r in raw_rows))
            y0_samp.append(sum(r.shape[0] for r in samp_rows))
            raw_rows.append(jnp.pad(img, ((0, 0), (0, raw_wmax - w))))
            samp_rows.append(
                jnp.pad(samp, ((0, 0), (0, samp_wmax - samp.shape[1])))
            )
        comp_raw = jnp.concatenate(raw_rows, axis=0)
        comp_samp = jnp.concatenate(samp_rows, axis=0)
        # y0s and quotas are static -> the per-slot row offsets are host
        # constants, zero device ops
        def _offsets(y0s):
            col = np.repeat(np.asarray(y0s, np.int32), k_effs)
            return jnp.asarray(
                np.stack([np.zeros_like(col), col], axis=1)
            )

        off, off_s = _offsets(y0_raw), _offsets(y0_samp)
        xy_all = safe_xys[0] if flat else jnp.concatenate(safe_xys)
        angles_all = ic_angles(comp_raw, xy_all + off)
        desc_all = brief_descriptors(
            comp_samp, (xy_all + off_s).astype(jnp.float32), angles_all
        )
    if flat:
        # whole-array slot metadata: scale/octave/size are host constants
        scale_vec = np.repeat(
            np.asarray([1.0] + [float(s) for s in scales[1:]], np.float32),
            quotas,
        )
        oct_np = np.repeat(np.arange(len(quotas), dtype=np.int32), quotas)
        size_np = (PATCH_SIZE * scale_vec).astype(np.float32)
        v = valid_cat
        return FrameFeatures(
            xy=jnp.where(
                v[:, None],
                xy_cat.astype(jnp.float32) * jnp.asarray(scale_vec)[:, None],
                0.0,
            ),
            response=jnp.where(v, resp_cat.astype(jnp.float32), 0.0),
            angle=jnp.where(v, angles_all, 0.0),
            octave=jnp.asarray(oct_np),
            size=jnp.asarray(size_np),
            valid=v,
            desc=jnp.where(v[:, None], desc_all, 0),
        )
    starts = np.cumsum([0] + [sx.shape[0] for sx in safe_xys])
    per_level = {
        level: (xy_i, resp, valid,
                angles_all[starts[i] : starts[i + 1]],
                desc_all[starts[i] : starts[i + 1]])
        for i, (level, xy_i, resp, valid) in enumerate(level_meta)
    }
    blocks: list[FrameFeatures] = []
    for level, img in enumerate(pyramid):
        h, w = img.shape
        k = quotas[level]
        ch, cw = h - 2 * b, w - 2 * b
        if level not in scores:
            blocks.append(_empty_level_block(max(k, 0)))
            continue
        k_eff = min(k, ch * cw)
        xy_i, resp, valid, angles, desc = per_level[level]
        scale = float(scales[level])
        blk = FrameFeatures(
            xy=xy_i.astype(jnp.float32) * (scale if level != 0 else 1.0),
            response=resp.astype(jnp.float32),
            angle=angles,
            octave=jnp.full((k_eff,), level, jnp.int32),
            size=jnp.full((k_eff,), PATCH_SIZE * scale, jnp.float32),
            valid=valid,
            desc=desc,
        )
        if k_eff < k:  # pad the block to the static quota
            pad = _empty_level_block(k - k_eff)
            blk = jax.tree.map(lambda a, p: jnp.concatenate([a, p]), blk, pad)
        # zero out invalid slots so downstream masked ops see clean data
        blk = blk._replace(
            xy=jnp.where(blk.valid[:, None], blk.xy, 0.0),
            response=jnp.where(blk.valid, blk.response, 0.0),
            angle=jnp.where(blk.valid, blk.angle, 0.0),
            desc=jnp.where(blk.valid[:, None], blk.desc, 0),
        )
        blocks.append(blk)
    return jax.tree.map(lambda *xs: jnp.concatenate(xs), *blocks)


@functools.partial(jax.jit, static_argnums=(1,))
def extract_features_jit(image: jax.Array, params: PyramidParams) -> FrameFeatures:
    return extract_features(image, params)


@functools.partial(jax.jit, static_argnums=(1,))
def extract_features_stereo_jit(images: jax.Array, params: PyramidParams) -> FrameFeatures:
    """Batched extraction — images (B, H, W); left/right as a batch of 2."""
    return jax.vmap(lambda im: extract_features(im, params))(images)


def split_lapping(feat_np: dict, lapping: tuple[float, float]) -> tuple[np.ndarray, int]:
    """Order valid slots mono-first / stereo-tail (operator() :1289-1303).

    Returns (permutation over valid entries, mono_index).
    """
    xy = feat_np["xy"]
    valid = feat_np["valid"]
    idx = np.nonzero(valid)[0]
    in_lap = (xy[idx, 0] >= lapping[0]) & (xy[idx, 0] <= lapping[1])
    order = np.concatenate([idx[~in_lap], idx[in_lap][::-1]])
    return order, int((~in_lap).sum())
