"""Spatially-uniform top-K keypoint selection (DistributeOctTree).

The reference spreads keypoints with a sequential pointer-chasing quadtree
(/root/reference/src/ORBextractor.cc:584-774) — unimplementable efficiently
under XLA's static-shape model.  Here it is replaced with an
equivalent-objective, fully data-parallel selection:

 1. partition the detection crop into a static grid of at most K cells
    (cell size chosen at trace time so gx*gy <= K);
 2. keep the best-response corner of every non-empty cell (the octree's
    "retain best per node" step, :755-771);
 3. fill the remaining quota with the globally best residual corners
    (lax.top_k over the winner-suppressed score map).

Output is a fixed-size (K,) slot block with a validity mask — no dynamic
shapes, no atomics (the reference used atomic_inc compaction).  The exact
octree is kept in the oracle for parity experiments (SURVEY §7).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def cell_size_for(h: int, w: int, k: int) -> int:
    """Smallest cell size whose grid has at most k cells."""
    cell = max(int(math.sqrt(h * w / max(k, 1))), 1)
    while math.ceil(w / cell) * math.ceil(h / cell) > k:
        cell += 1
    return cell


def _candidate_pool(
    score: jax.Array, k: int
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """(key, resp, ys, xs) flat candidate pool for one score map.

    key: f32 sort key (winners above residuals above invalid); pool holds
    >= k positive-able entries.  Shared by the single-map and the batched
    multi-level selection paths.
    """
    h, w = score.shape
    cell = cell_size_for(h, w, k)
    gy, gx = math.ceil(h / cell), math.ceil(w / cell)
    ph, pw = gy * cell, gx * cell
    padded = jnp.zeros((ph, pw), score.dtype).at[:h, :w].set(score)

    def grid_maxima(m: jax.Array, c: int, mh: int, mw: int):
        """Per-cell (max, y, x) for cell size c over (mh, mw).

        Score and within-cell position are packed into one int32 so a single
        reduce_window max finds both (no reshape/transpose through HBM).
        Packing (C-1-local) preserves the argmax tie-break: highest score,
        then smallest within-cell flat index.
        """
        ny, nx = mh // c, mw // c
        cc = c * c
        ys = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 1)
        local = (ys % c) * c + (xs % c)
        packed = m.astype(jnp.int32) * cc + (cc - 1 - local)
        pmax = jax.lax.reduce_window(
            packed, jnp.int32(-(2**31) + 1), jax.lax.max, (c, c), (c, c), "VALID"
        )  # (ny, nx)
        cmax = pmax // cc
        l_win = (cc - 1) - (pmax % cc)
        by = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 0) * c
        bx = jax.lax.broadcasted_iota(jnp.int32, (ny, nx), 1) * c
        cy = by + l_win // c
        cx = bx + l_win % c
        return cmax.reshape(-1), cy.reshape(-1), cx.reshape(-1), packed, pmax

    cmax, wy, wx, packed, pmax = grid_maxima(padded, cell, ph, pw)

    # Residual pool: winners suppressed (broadcast-compare against the
    # cell-max pack instead of a per-winner scatter), then
    # best-per-fine-cell (a 4x finer grid).  A global lax.top_k over the
    # whole map would sort ~350K values (milliseconds); per-fine-cell maxima
    # + a top-k over <=4k candidates is the same spatial-uniformity objective
    # at ~zero cost.
    pmax_full = jnp.repeat(jnp.repeat(pmax, cell, axis=0), cell, axis=1)
    resid = jnp.where(packed == pmax_full, 0, padded)
    fine = max(cell // 2, 1)
    fy, fx = math.ceil(ph / fine), math.ceil(pw / fine)
    resid = jnp.zeros((fy * fine, fx * fine), score.dtype).at[:ph, :pw].set(resid)
    rresp, ry, rx, _, _ = grid_maxima(resid, fine, fy * fine, fx * fine)

    # zero-pad the candidate pool so it always holds >= k entries
    zpad = jnp.zeros((k,), jnp.int32)
    resp = jnp.concatenate([cmax, rresp, zpad])
    ys = jnp.concatenate([wy, ry, zpad])
    xs = jnp.concatenate([wx, rx, zpad])
    # cell winners take absolute priority; invalid slots sink below everything
    is_winner = jnp.concatenate(
        [jnp.ones_like(cmax), jnp.zeros_like(rresp), zpad]
    ).astype(jnp.float32)
    key = jnp.where(resp > 0, is_winner * 1e6 + resp.astype(jnp.float32), -1.0)
    return key, resp, ys, xs


def select_topk_grid(score: jax.Array, k: int) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Pick k spatially-spread maxima from an NMS'd score map.

    Returns (xy (k, 2) int32 crop coords, response (k,) int32, valid (k,) bool).
    Deterministic: ties broken by flat index (lax.top_k is stable).
    """
    key, resp, ys, xs = _candidate_pool(score, k)
    top_key, sel = jax.lax.top_k(key, k)
    xy = jnp.stack([xs[sel], ys[sel]], axis=1)
    return xy, resp[sel], top_key > 0


def select_topk_grid_multi(
    scores: list, ks: list
) -> list:
    """select_topk_grid for SEVERAL maps with ONE batched top_k.

    The per-map candidate pools (already tiny: grid winners + fine-cell
    residuals) are padded to a common length and stacked; one
    (L, P) -> (L, k_max) lax.top_k replaces L separate top_k dispatches.
    Because top_k sorts descending and every map's pool carries the same
    key ordering, row l's first ks[l] entries are EXACTLY what the
    single-map top_k(key_l, ks[l]) returns — bit-identical outputs.

    Returns a list of (xy (k,2) i32, resp (k,) i32, valid (k,) bool).
    """
    assert len(scores) == len(ks)
    if not scores:
        return []
    pools = [_candidate_pool(s, k) for s, k in zip(scores, ks)]
    pmax = max(p[0].shape[0] for p in pools)
    kmax = max(ks)

    def pad(a, fill):
        return jnp.pad(a, (0, pmax - a.shape[0]), constant_values=fill)

    key = jnp.stack([pad(p[0], -1.0) for p in pools])     # (L, P)
    resp = jnp.stack([pad(p[1], 0) for p in pools])
    ys = jnp.stack([pad(p[2], 0) for p in pools])
    xs = jnp.stack([pad(p[3], 0) for p in pools])
    top_key, sel = jax.lax.top_k(key, kmax)               # (L, kmax)
    # payload pickup as a one-hot einsum over byte-split payload planes in
    # place of take_along_axis: bit-identical (all values < 4096 split into
    # bf16-exact bytes, one contributor per output).
    oh = (
        sel[:, :, None]
        == jax.lax.broadcasted_iota(jnp.int32, (1, 1, pmax), 2)
    ).astype(jnp.bfloat16)                                # (L, kmax, P)
    pay = jnp.stack(
        [resp >> 8, resp & 255, ys >> 8, ys & 255, xs >> 8, xs & 255], axis=2
    ).astype(jnp.bfloat16)                                # (L, P, 6)
    picked = jnp.einsum(
        "lkp,lpc->lkc", oh, pay, preferred_element_type=jnp.float32
    ).astype(jnp.int32)
    r = (picked[:, :, 0] << 8) | picked[:, :, 1]
    y = (picked[:, :, 2] << 8) | picked[:, :, 3]
    x = (picked[:, :, 4] << 8) | picked[:, :, 5]
    out = []
    for l, k in enumerate(ks):
        xy = jnp.stack([x[l, :k], y[l, :k]], axis=1)
        out.append((xy, r[l, :k], top_key[l, :k] > 0))
    return out
