"""FAST-9/16 corner detection as whole-image array code.

The reference implements FAST as a per-thread scalar kernel with a 2KB
contiguous-arc lookup table and a binary search for the corner score
(/root/reference/src/OpenCL/Kernel/TileCalcKeypoints.cl:140-448).  Here the
whole image is evaluated as 16 shifted planes:

 - the ring is materialised via static rolls (pure elementwise, fuses in XLA);
 - the "exists a contiguous arc of 9" test + score collapse into a closed form:
   score = max over the 16 circular 9-windows of (min over the window of the
   excess) - 1, computed with a log-step circular min (4 ops instead of 144) —
   provably equal to the reference's binary search over thresholds;
 - 3x3 strict NMS and the per-32x32-tile two-threshold retry
   (TileCalcKeypoints.cl:384-409) are elementwise masks.

On a GPU the score is one Pallas/Triton kernel over 2-D tiles with the
same arithmetic (`raw_score_triton`).  Everything is int32; results are
bit-identical to the CPU oracle.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from orbslam3_tpu.oracle.orb_cpu import FAST_RING

TILE = 32  # two-threshold retry granularity (work-group tile in the reference)


def _ring_planes(img_i32: jax.Array) -> jax.Array:
    """(16, H, W): ring pixel value at each offset, via static rolls."""
    planes = [
        jnp.roll(img_i32, (-int(dy), -int(dx)), axis=(0, 1))
        for (dx, dy) in FAST_RING
    ]
    return jnp.stack(planes, axis=0)


def _arc_score(d: jax.Array) -> jax.Array:
    """max over 16 circular 9-windows of the windowed min of d (16, H, W)."""
    m2 = jnp.minimum(d, jnp.roll(d, -1, axis=0))
    m4 = jnp.minimum(m2, jnp.roll(m2, -2, axis=0))
    m8 = jnp.minimum(m4, jnp.roll(m4, -4, axis=0))
    m9 = jnp.minimum(m8, jnp.roll(d, -8, axis=0))
    return m9.max(axis=0)


def raw_score_map(img: jax.Array) -> jax.Array:
    """Threshold-free FAST corner score (max t at which the pixel is a corner).

    Computed once; any thresholded map is `where(raw >= t, raw, 0)` — the
    two-threshold retry therefore costs one score evaluation, not two.
    On a GPU the Triton kernel computes it; elsewhere the XLA roll
    formulation, which is also the kernel's reference.  On the H100 the
    kernel took the stereo front-end from 8.4 to 7.1 ms/frame, and XLA:GPU
    (jax 0.9.0) miscompiled the roll formulation for a 480x752 image:
    under jit ~24k pixels differed from the oracle, op by op none did
    (pinned on the card by tests/test_fast_triton.py).
    """
    if jax.default_backend() == "gpu":
        return raw_score_triton(img)
    return raw_score_xla(img)


def raw_score_xla(img: jax.Array) -> jax.Array:
    """raw_score_map as whole-image XLA: 16 rolled int32 planes."""
    h, w = img.shape
    c = img.astype(jnp.int32)
    ring = _ring_planes(c)
    d_bright = ring - c[None]
    score = jnp.maximum(_arc_score(d_bright), _arc_score(-d_bright)) - 1
    # 3-px frame where the ring would wrap
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inner = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return jnp.where(inner, score, 0)


# Output tile of the Triton kernel, (rows, cols): powers of two, as Triton
# requires.  8x64 and 16x64 timed alike on the H100 (tools/fast_ab.py).
TRITON_TILE = (8, 64)


def _win9(p: list, op) -> list:
    """Circular window-9 `op` over 16 planes (van Herk / Gil-Werman):
    prefix and suffix runs over blocks of 9 of the ring unrolled to 24,
    16 windows for 2 x 24 + 16 ops instead of 16 x 8."""
    e = [p[j % 16] for j in range(24)]
    pre = [None] * 24
    for j in range(24):
        pre[j] = e[j] if j % 9 == 0 else op(pre[j - 1], e[j])
    suf = [None] * 24
    for j in reversed(range(24)):
        suf[j] = e[j] if (j % 9 == 8 or j == 23) else op(suf[j + 1], e[j])
    return [op(suf[o], pre[o + 8]) for o in range(16)]


def _score16(d: list) -> jax.Array:
    """max(bright arc score, dark arc score) from the 16 ring differences
    (ring - center), before the final -1."""
    bright = functools.reduce(jnp.maximum, _win9(d, jnp.minimum))
    neg_dark = functools.reduce(jnp.minimum, _win9(d, jnp.maximum))
    return jnp.maximum(bright, -neg_dark)


def raw_score_triton(img: jax.Array, interpret: bool = False) -> jax.Array:
    """raw_score_map as a Pallas kernel through Triton: each 2-D output
    tile loads its own +-3 px halo from a zero-padded copy of the image,
    so no rolled plane reaches memory.  `interpret` runs it on any
    backend."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    th, tw = TRITON_TILE
    h, w = img.shape
    nh, nw = -(-h // th), -(-w // tw)
    padded = jnp.pad(img, ((3, nh * th - h + 3), (3, nw * tw - w + 3)))

    def kernel(p_ref, o_ref):
        r0 = pl.program_id(0) * th
        c0 = pl.program_id(1) * tw

        def at(dy, dx):
            v = p_ref[pl.ds(r0 + 3 + dy, th), pl.ds(c0 + 3 + dx, tw)]
            return v.astype(jnp.int32)

        c = at(0, 0)
        s = _score16([at(dy, dx) - c for (dx, dy) in FAST_RING]) - 1
        ys = r0 + jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0)
        xs = c0 + jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1)
        inner = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
        o_ref[...] = jnp.where(inner, s, 0)

    out = pl.pallas_call(
        kernel,
        grid=(nh, nw),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((th, tw), lambda i, j: (i, j)),
        # under shard_map the output varies over the same mesh axes as
        # the image it is computed from
        out_shape=jax.ShapeDtypeStruct(
            (nh * th, nw * tw), jnp.int32, vma=jax.typeof(padded).vma),
        backend="triton",
        interpret=interpret,
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        name="fast_raw_score",
    )(padded)
    return out[:h, :w]


@functools.partial(jax.jit, static_argnums=1)
def fast_score_map(img: jax.Array, threshold: int) -> jax.Array:
    """Per-pixel FAST corner score (0 where not a corner at `threshold`)."""
    raw = raw_score_map(img)
    return jnp.where(raw >= threshold, raw, 0)


@jax.jit
def nms3(score: jax.Array) -> jax.Array:
    """Strict 3x3 non-max suppression (kernel `isMax` semantics)."""
    h, w = score.shape
    p = jnp.pad(score, 1)
    keep = jnp.ones((h, w), dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            keep &= score > jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w))
    return jnp.where(keep & (score > 0), score, 0)


def shelf_pack(
    heights, widths, w_comp: int, order=None
) -> tuple[list, list]:
    """First-fit 2-D shelf packing shared by the detection composite (below)
    and the gather/blur composite (ops/extractor.build_merged_composites).

    Blocks are placed in `order` (default: given order) onto horizontal
    shelves of width `w_comp`: the first existing shelf tall and roomy
    enough takes the block at its x-cursor, else a new shelf opens at the
    bottom.  Returns (place, shelves) where place[b] = (y0, x0) in the
    blocks' original indexing and shelves is a list of [y0, height,
    x_cursor] rows (x_cursor = used width).
    """
    n = len(heights)
    if order is None:
        order = range(n)
    shelves: list[list[int]] = []  # [y0, height, x_cursor]
    place: list = [None] * n
    y_total = 0
    for b in order:
        hb, wb = heights[b], widths[b]
        for s in shelves:
            if s[1] >= hb and s[2] + wb <= w_comp:
                place[b] = (s[0], s[2])
                s[2] += wb
                break
        else:
            shelves.append([y_total, hb, wb])
            place[b] = (y_total, 0)
            y_total += hb
    return place, shelves


def detect_two_threshold_multi(
    crops: list, ini_th: int, min_th: int
) -> list:
    """detect_two_threshold for ALL pyramid levels in ONE pass.

    The crops are stacked into a single composite image (each level padded
    to a 32-row/col multiple so the per-tile retry grid stays anchored at
    its own origin) and the score/NMS/retry pipeline runs once instead of
    eight times.  Bit-identical to the per-level path: each
    level's 3-px ring frame is zeroed BEFORE NMS exactly as
    raw_score_map does per level, and interior pixels never read across a
    level boundary (ring radius 3 < 3-px zeroed frame + padding).
    """
    import numpy as np

    if not crops:
        return []
    # 2-D shelf packing (origins on the TILE grid): narrow high levels would
    # waste ~35% of the composite as zero columns if stacked vertically at
    # the level-0 width; packing levels side-by-side cuts the scored area
    # ~25%.  Correctness: every level keeps its own 3-px zeroed ring frame,
    # so neither the ring reads (radius 3) nor the 3x3 NMS of any interior
    # pixel can cross a level seam, and TILE-aligned origins keep the retry
    # tile grid anchored per level exactly as the vertical layout did.
    pads = [(-(-c.shape[0] // TILE) * TILE, -(-c.shape[1] // TILE) * TILE)
            for c in crops]
    w_comp = max(pw for _, pw in pads)
    place, shelves = shelf_pack(
        [ph for ph, _ in pads], [pw for _, pw in pads], w_comp
    )
    # build the composite with pure pad+concat (one fused copy) instead of
    # a chain of dynamic-update-slices (measured 0.05 ms/camera of pure
    # data movement); layout is bit-identical to the scatter form
    meta = []
    by_shelf: dict[int, list] = {}
    for crop, (y0, x0) in zip(crops, place):
        ch, cw = crop.shape
        meta.append((y0, x0, ch, cw))
        by_shelf.setdefault(y0, []).append((x0, crop))
    shelf_rows = []
    for y0, sh, _ in shelves:
        cells = sorted(by_shelf.get(y0, ()), key=lambda t: t[0])
        x_cur, pieces = 0, []
        for x0, crop in cells:
            ch, cw = crop.shape
            pieces.append(
                jnp.pad(crop, ((0, sh - ch), (x0 - x_cur, 0)))
            )
            x_cur = x0 + cw
        pieces.append(
            jnp.zeros((sh, w_comp - x_cur), crops[0].dtype)
        )
        shelf_rows.append(jnp.concatenate(pieces, axis=1))
    comp = jnp.concatenate(shelf_rows, axis=0)
    # per-level 3-px ring frames (static mask)
    mask = np.zeros(comp.shape, bool)
    for (y0, x0, ch, cw) in meta:
        mask[y0 + 3 : y0 + ch - 3, x0 + 3 : x0 + cw - 3] = True
    # named scope: trace reductions attribute the FAST stage's device time
    with jax.named_scope("fast_detect"):
        raw = jnp.where(jnp.asarray(mask), raw_score_map(comp), 0)
        hi = jnp.where(raw >= ini_th, raw, 0)
        lo = jnp.where(raw >= min_th, raw, 0)
        tile_max = jax.lax.reduce_window(
            hi, jnp.int32(0), jax.lax.max, (TILE, TILE), (TILE, TILE), "VALID"
        )
        use_hi = jnp.repeat(jnp.repeat(tile_max > 0, TILE, axis=0), TILE, axis=1)
        score = nms3(jnp.where(use_hi, hi, lo))
    return [
        score[y0 : y0 + ch, x0 : x0 + cw] for (y0, x0, ch, cw) in meta
    ]


@functools.partial(jax.jit, static_argnums=(1, 2))
def detect_two_threshold(crop: jax.Array, ini_th: int, min_th: int) -> jax.Array:
    """NMS'd score map of the detection crop with per-tile threshold fallback.

    A 32x32 tile that finds no corner at `ini_th` retries at `min_th` — the
    reference's two-pass semantics, evaluated in one fused pass (both score
    maps are elementwise; the retry is a tile-reduced select, not a relaunch).
    """
    h, w = crop.shape
    raw = raw_score_map(crop)
    hi = jnp.where(raw >= ini_th, raw, 0)
    lo = jnp.where(raw >= min_th, raw, 0)
    th, tw = math.ceil(h / TILE), math.ceil(w / TILE)
    hi_pad = jnp.zeros((th * TILE, tw * TILE), hi.dtype).at[:h, :w].set(hi)
    tile_max = jax.lax.reduce_window(
        hi_pad, jnp.int32(0), jax.lax.max, (TILE, TILE), (TILE, TILE), "VALID"
    )
    use_hi = (
        jnp.repeat(jnp.repeat(tile_max > 0, TILE, axis=0), TILE, axis=1)[:h, :w]
    )
    return nms3(jnp.where(use_hi, hi, lo))
