"""Host-side ORB matching flavours (ORBmatcher role-parity).

Re-implements the matching semantics of /root/reference/include/
ORBmatcher.h + src/ORBmatcher1-3.cc (2,151 LoC): SearchByProjection
(local-map and last-frame overloads), SearchByBoW, SearchForInitialization,
SearchForTriangulation (epipolar), Fuse, with the TH_LOW/TH_HIGH thresholds,
nn-ratio tests, and the 30-bin rotation-consistency histogram
(ORBmatcher3.cc:592).  Distances are 256-bit Hamming over uint64 views
(ORBmatcher3.cc:637 uses SWAR popcount; NumPy's bitwise_count here).

The device pipeline's dense Hamming matrix lives in orbslam3_tpu.ops.matching;
the tracking loop matches here, on the host, where candidate sets are small
and a device dispatch per call would cost more than the match.
"""

from __future__ import annotations

import numpy as np

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30

# Acceptance threshold for the projection matchers (motion-model and
# local-map).  The reference accepts up to TH_HIGH=100; true same-octave
# re-detections measure ~16-22 bits while aliased nearby corners are >=40,
# and a wrong pairing is STICKY (the same descriptor pair re-matches every
# frame, feeding drift-consistent evidence into pose optimization).  A
# tighter gate breaks wrong-pair formation at negligible recall cost.
# DELIBERATE DEVIATION, tuned on the synthetic world — gate it (and the
# same-octave-first candidate search) behind set_tuning() so real-data
# runs can restore the reference's values (Tuning.* keys in Settings).
MATCH_TH = 50
SAME_OCTAVE_FIRST = True


def set_tuning(match_th: int | None = None,
               same_octave_first: bool | None = None):
    """Override the deviation knobs (wired from Settings Tuning.* keys)."""
    global MATCH_TH, SAME_OCTAVE_FIRST
    if match_th is not None:
        MATCH_TH = int(match_th)
    if same_octave_first is not None:
        SAME_OCTAVE_FIRST = bool(same_octave_first)


def desc_distance(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.bitwise_count(a.view(np.uint64) ^ b.view(np.uint64)).sum())


def _as_u64(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).view(np.uint64)


def desc_distances(a: np.ndarray, B: np.ndarray) -> np.ndarray:
    """(1, 32) vs (M, 32) -> (M,) int."""
    return np.bitwise_count(_as_u64(a)[None, :] ^ _as_u64(B)).sum(
        axis=-1, dtype=np.int32
    )


def hamming_matrix_np(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    a = _as_u64(A)
    b = _as_u64(B)
    return np.bitwise_count(a[:, None, :] ^ b[None, :, :]).sum(axis=-1, dtype=np.int32)


def _rotation_consistency(rot: np.ndarray, valid_idx: list[int]) -> set[int]:
    """Indices surviving the three-maxima histogram check."""
    if not valid_idx:
        return set()
    factor = HISTO_LENGTH / 360.0
    bins = np.round(np.asarray(rot) * factor).astype(int) % HISTO_LENGTH
    counts = np.bincount(bins, minlength=HISTO_LENGTH)
    order = np.argsort(-counts)
    keep_bins = {order[0]}
    if counts[order[1]] >= 0.1 * counts[order[0]]:
        keep_bins.add(order[1])
    if counts[order[2]] >= 0.1 * counts[order[0]]:
        keep_bins.add(order[2])
    return {i for i, b in zip(valid_idx, bins) if b in keep_bins}


def _rotation_mask(rot: np.ndarray) -> np.ndarray:
    """Boolean survivors of the three-maxima histogram check (array form)."""
    if len(rot) == 0:
        return np.zeros(0, bool)
    factor = HISTO_LENGTH / 360.0
    bins = np.round(np.asarray(rot) * factor).astype(int) % HISTO_LENGTH
    counts = np.bincount(bins, minlength=HISTO_LENGTH)
    order = np.argsort(-counts)
    keep = [order[0]]
    if counts[order[1]] >= 0.1 * counts[order[0]]:
        keep.append(order[1])
    if counts[order[2]] >= 0.1 * counts[order[0]]:
        keep.append(order[2])
    return np.isin(bins, keep)


def _occupied_mask(frame) -> np.ndarray:
    """(n,) uint8: slot already holds a map-anchored (n_obs > 0) point.

    Landmark-table gather where possible; unattached points are temporal
    VO points, which have n_obs == 0 by construction."""
    objs = frame.map_points
    occ = np.zeros(len(objs), np.uint8)
    nz = np.nonzero(objs != None)[0]  # noqa: E711 — elementwise over objects
    if len(nz) == 0:
        return occ
    mps = [objs[i] for i in nz]
    table = next(
        (t for t in (getattr(mp, "_table", None) for mp in mps) if t is not None),
        None,
    )
    if table is None:
        occ[nz] = np.fromiter((mp.n_obs > 0 for mp in mps), bool, len(mps))
        return occ
    slots = table.slots_of(mps)
    att = slots >= 0
    occ[nz[att]] = table.n_obs[slots[att]] > 0
    return occ


def search_by_projection_cands(frame, cands, proj, n_obs, desc,
                               th: float = 1.0, ratio: float = 0.8):
    """Core of SearchByProjection(Frame, local map) over precomputed
    candidate arrays: `proj` (K, 5) = (u, v, ur, level, view_cos), `n_obs`
    (K,), `desc` (K, 32) — produced either by the tracker's batched
    landmark-table frustum pass or by the attribute-based wrapper below.
    Returns number of new matches; writes frame.map_points.

    Runs the native C++ kernel when available (bit-identical walk order and
    gates, ~30x the Python loop — this is the tracking loop's hottest host
    stage); falls back to the Python walk otherwise."""
    from orbslam3_tpu import native

    if len(cands) == 0:
        return 0
    if native.available():
        occupied = _occupied_mask(frame)
        # fisheye frames: the kernel builds its own grid over the arrays it
        # receives, so pass only the left-camera block (right keypoints live
        # in right-image coordinates — the right pass runs via right_view())
        nl = frame.n_left
        res = native.project_match_local(
            np.ascontiguousarray(proj, np.float32),
            np.ascontiguousarray(desc, np.uint8),
            (np.asarray(n_obs) > 0).astype(np.uint8),
            frame.kps_un[:nl], frame.octave[:nl], frame.desc[:nl],
            frame.u_right[:nl], occupied[:nl],
            frame.scale_factors, th, ratio, MATCH_TH,
            frame.min_x, frame.min_y, frame._grid_w, frame._grid_h,
        )
        if res is not None:
            out, _ = res
            n_matched = 0
            for k_i in np.nonzero(out >= 0)[0]:
                frame.map_points[out[k_i]] = cands[k_i]
                n_matched += 1
            return n_matched
    n_matched = 0
    for j, mp in enumerate(cands):
        u, v, ur, level, view_cos = proj[j]
        level = int(level)
        r = 2.5 if view_cos > 0.998 else 4.0
        r *= th * frame.scale_factors[level]
        idx = frame.features_in_area(u, v, r, level - 1, level)
        if len(idx) == 0:
            continue
        best, best2 = 256, 256
        best_i, best_lvl, best2_lvl = -1, -1, -1
        dists = desc_distances(np.asarray(desc[j], np.uint8), frame.desc[idx])
        for k_i, i in enumerate(idx):
            cur = frame.map_points[i]
            if cur is not None and cur.n_obs > 0:
                continue
            if frame.u_right[i] >= 0 and ur >= 0:
                if abs(ur - frame.u_right[i]) > r:
                    continue
            d = int(dists[k_i])
            if d < best:
                best2, best2_lvl = best, best_lvl
                best, best_i, best_lvl = d, i, int(frame.octave[i])
            elif d < best2:
                best2, best2_lvl = d, int(frame.octave[i])
        if best <= MATCH_TH and best_i >= 0:
            if best_lvl == best2_lvl and best > ratio * best2:
                continue
            frame.map_points[best_i] = mp
            n_matched += 1
    return n_matched


def search_by_projection_local_map(frame, map_points, th: float = 1.0, ratio: float = 0.8,
                                   far_points_th: float = 0.0):
    """Match frame keypoints to local map points already marked in-view
    (ORBmatcher SearchByProjection, Frame vs vector<MapPoint*>): attribute
    protocol (mp.track_in_view/mp.track_proj) wrapper over the array core."""
    cands = [mp for mp in map_points if mp.track_in_view and not mp.bad]
    if not cands:
        return 0
    proj = np.asarray([mp.track_proj for mp in cands], np.float32)
    desc = np.stack([mp.descriptor for mp in cands])
    n_obs = np.asarray([mp.n_obs for mp in cands], np.int32)
    return search_by_projection_cands(frame, cands, proj, n_obs, desc, th, ratio)


def search_by_projection_last_frame(cur, last, th: float, mono: bool,
                                    check_rotation: bool = True,
                                    map_points_only: bool = False,
                                    rot_collect: list | None = None,
                                    nn_ratio: float = 0.0):
    """Motion-model matching: project last frame's map points into the
    current frame (ORBmatcher3.cc:256 semantics).

    Pinhole frames run the native C++ kernel (same gates/walk order; the
    rotation-consistency histogram runs here on the returned pairs);
    everything else uses the Python walk below.

    `rot_collect`: fisheye dual-camera mode — instead of filtering
    rotation consistency inside this call, append (frame, idx, rot) per
    accepted match so the caller can run ONE histogram across the left and
    right passes (the reference shares a single rotHist between the left
    and bRight blocks, ORBmatcher3.cc SearchByProjection(CurrentFrame,
    LastFrame))."""
    tcw = cur.Tcw
    tlw = last.Tcw
    tlc = tlw * tcw.inverse()
    tz = (tcw * tlw.inverse()).t[2]  # z of last origin in cur frame
    forward = tz > cur.mb and not mono
    backward = -tz > cur.mb and not mono

    if type(cur.camera).__name__ == "Pinhole":
        from orbslam3_tpu import native

        if native.available():
            m = last.n
            pw = np.zeros((m, 3))
            mp_valid = np.zeros(m, np.uint8)
            mp_obs = np.zeros(m, np.uint8)
            objs = last.map_points
            outlier = last.outlier
            sel_i = np.nonzero((objs != None) & ~outlier)[0]  # noqa: E711 — elementwise over objects
            if len(sel_i):
                mps_sel = list(objs[sel_i])
                # real map points gather from the landmark table; temporal
                # VO points (unattached) fall back to per-point reads
                table = next(
                    (
                        t
                        for t in (getattr(mp, "_table", None) for mp in mps_sel)
                        if t is not None
                    ),
                    None,
                )
                idxs = np.asarray(sel_i)
                if table is not None:
                    slots = table.slots_of(mps_sel)
                    att = slots >= 0
                    good = att & table.valid[np.maximum(slots, 0)]
                    ai, si = idxs[good], slots[good]
                    pw[ai] = table.pos[si]
                    mp_valid[ai] = 1
                    mp_obs[ai] = table.n_obs[si] > 0
                    rest = np.nonzero(~att)[0]
                else:
                    rest = np.arange(len(mps_sel))
                if len(rest):
                    # unattached survivors are temporal VO points: batch the
                    # attribute reads instead of per-row scalar assignments
                    rmps = [mps_sel[j] for j in rest]
                    ok = np.fromiter(
                        (not mp.bad for mp in rmps), bool, len(rmps)
                    )
                    if ok.any():
                        ri = idxs[rest[ok]]
                        pw[ri] = np.stack(
                            [mp._position for mp, o in zip(rmps, ok) if o]
                        )
                        mp_valid[ri] = 1
                        mp_obs[ri] = np.fromiter(
                            (mp.n_obs > 0 for mp, o in zip(rmps, ok) if o),
                            bool,
                            int(ok.sum()),
                        )
            occupied = _occupied_mask(cur)
            res = native.project_match_last(
                pw, last.desc, last.octave, mp_valid, mp_obs,
                tcw.R, tcw.t,
                cur.camera.fx, cur.camera.fy, cur.camera.cx, cur.camera.cy,
                cur.mbf,
                cur.min_x, cur.max_x, cur.min_y, cur.max_y,
                cur.kps_un, cur.octave, cur.desc, cur.u_right, occupied,
                cur.scale_factors, th, MATCH_TH, SAME_OCTAVE_FIRST,
                forward, backward,
                cur.min_x, cur.min_y, cur._grid_w, cur._grid_h,
            )
            if res is not None:
                out, _ = res
                hit = np.nonzero(out >= 0)[0]
                best = out[hit]
                cur.map_points[best] = last.map_points[hit]
                matches = len(hit)
                if check_rotation and matches > 0:
                    dr = last.angle[hit] - cur.angle[best]
                    rot = np.where(dr < 0, dr + 360, dr)
                    drop = best[~_rotation_mask(rot)]
                    cur.map_points[drop] = None
                    matches -= len(drop)
                return matches

    matches = 0
    rot = []
    rot_idx = []
    assigned: dict[int, int] = {}
    matched_mps: set[int] = set()
    for i_last in range(last.n):
        mp = last.map_points[i_last]
        if mp is None or mp.bad or last.outlier[i_last]:
            continue
        if map_points_only and mp.n_obs < 1:
            continue
        if mp.id in matched_mps:
            # a dual-observed point occupies two last-frame slots; after the
            # first slot matched, the second visit's best keypoint is
            # occupied and the walk would claim a wrong neighbor — visit
            # each point once per pass
            continue
        pc = tcw * mp.position
        if pc[2] < 0:
            continue
        uv = cur.camera.project(pc[None])[0]
        if not (cur.min_x < uv[0] < cur.max_x and cur.min_y < uv[1] < cur.max_y):
            continue
        last_oct = int(last.octave[i_last])
        r = th * cur.scale_factors[last_oct]
        # Same-octave candidates first: descriptors from different pyramid
        # levels of the same corner differ by ~80 bits (different blur),
        # while same-level re-detections differ by ~16 — cross-octave
        # comparisons are the dominant junk-match source.  Widen to the
        # reference's +/-1 (or forward/backward) band only when the same
        # level has no candidate.  (Deviation knob SAME_OCTAVE_FIRST;
        # False = the reference's band directly.)
        idx = (
            cur.features_in_area(uv[0], uv[1], r, last_oct, last_oct)
            if SAME_OCTAVE_FIRST
            else []
        )
        if len(idx) == 0:
            if forward:
                idx = cur.features_in_area(uv[0], uv[1], r, last_oct, -1)
            elif backward:
                idx = cur.features_in_area(uv[0], uv[1], r, 0, last_oct)
            else:
                idx = cur.features_in_area(uv[0], uv[1], r, last_oct - 1, last_oct + 1)
        if len(idx) == 0:
            continue
        ur_pred = uv[0] - cur.mbf / pc[2] if cur.mbf > 0 else -1
        best, best2, best_i = 256, 256, -1
        dists = desc_distances(mp.descriptor, cur.desc[idx])
        for k_i, i in enumerate(idx):
            cur_mp = cur.map_points[i]
            if cur_mp is not None and cur_mp.n_obs > 0:
                continue
            if cur.u_right[i] >= 0 and ur_pred >= 0:
                if abs(ur_pred - cur.u_right[i]) > r:
                    continue
            d = int(dists[k_i])
            if d < best:
                best2 = best
                best, best_i = d, i
            elif d < best2:
                best2 = d
        if nn_ratio > 0 and best > nn_ratio * best2:
            continue
        if best <= MATCH_TH and best_i >= 0:
            cur.map_points[best_i] = mp
            assigned[best_i] = i_last
            matched_mps.add(mp.id)
            matches += 1
            if rot_collect is not None:
                dr = last.angle[i_last] - cur.angle[best_i]
                rot_collect.append((cur, best_i, dr + 360 if dr < 0 else dr))
            elif check_rotation:
                dr = last.angle[i_last] - cur.angle[best_i]
                rot.append(dr + 360 if dr < 0 else dr)
                rot_idx.append(best_i)
    if rot_collect is not None:
        return matches
    if check_rotation and matches > 0:
        keep = _rotation_consistency(rot, rot_idx)
        for i in rot_idx:
            if i not in keep:
                cur.map_points[i] = None
                matches -= 1
    return matches


def search_by_bow(kf, frame, ratio: float = 0.7, check_rotation: bool = True):
    """Match keyframe map points to frame keypoints through shared vocab
    nodes (ORBmatcher1.cc:225).  Falls back to a windowless brute-force
    when feature vectors are absent (no vocabulary loaded).
    Returns (matches: dict frame_idx -> MapPoint, count)."""
    kf_pairs = kf.get_map_point_indices()
    matches: dict[int, object] = {}
    rot, rot_idx = [], []

    if kf.feat_vec is not None and getattr(frame, "feat_vec", None) is not None:
        buckets = []
        for node, kf_idx in kf.feat_vec.items():
            f_idx = frame.feat_vec.get(node)
            if f_idx:
                buckets.append((kf_idx, f_idx))
    else:
        buckets = [([i for i, _ in kf_pairs], list(range(frame.n)))]

    kf_mp = {i: mp for i, mp in kf_pairs}
    used_frame = set()
    for kf_idx, f_idx in buckets:
        f_idx = [j for j in f_idx if j not in used_frame]
        if not f_idx:
            continue
        f_desc = frame.desc[f_idx]
        for i in kf_idx:
            mp = kf_mp.get(i)
            if mp is None or mp.bad:
                continue
            dists = desc_distances(kf.desc[i], f_desc)
            o = np.argsort(dists, kind="stable")
            best = int(dists[o[0]])
            if best > TH_LOW:
                continue
            if len(o) > 1 and best > ratio * int(dists[o[1]]):
                continue
            j = f_idx[int(o[0])]
            if j in used_frame:
                continue
            matches[j] = mp
            used_frame.add(j)
            if check_rotation:
                dr = kf.angle[i] - frame.angle[j]
                rot.append(dr + 360 if dr < 0 else dr)
                rot_idx.append(j)
    if check_rotation and matches:
        keep = _rotation_consistency(rot, rot_idx)
        matches = {j: mp for j, mp in matches.items() if j in keep}
    return matches, len(matches)


def search_for_initialization(f1, f2, window: int = 100, ratio: float = 0.9,
                              check_rotation: bool = True):
    """Monocular-init matching on level-0 keypoints (ORBmatcher semantics).
    Returns array m12 (n1,) of f2 indices or -1."""
    m12 = np.full(f1.n, -1, np.int64)
    best_dist2 = np.full(f2.n, 256, np.int64)
    matched21 = np.full(f2.n, -1, np.int64)
    rot, rot_idx = [], []
    for i1 in range(f1.n):
        if f1.octave[i1] > 0:
            continue
        x, y = f1.kps_un[i1]
        idx = f2.features_in_area(x, y, window, 0, 0)
        if len(idx) == 0:
            continue
        dists = desc_distances(f1.desc[i1], f2.desc[idx])
        o = np.argsort(dists, kind="stable")
        best = int(dists[o[0]])
        second = int(dists[o[1]]) if len(o) > 1 else 256
        if best > TH_LOW or best > ratio * second:
            continue
        i2 = int(idx[o[0]])
        if matched21[i2] >= 0:  # steal only if better
            if best >= best_dist2[i2]:
                continue
            m12[matched21[i2]] = -1
        m12[i1] = i2
        matched21[i2] = i1
        best_dist2[i2] = best
        if check_rotation:
            dr = f1.angle[i1] - f2.angle[i2]
            rot.append(dr + 360 if dr < 0 else dr)
            rot_idx.append(i1)
    if check_rotation and rot:
        keep = _rotation_consistency(rot, rot_idx)
        for i1 in rot_idx:
            if i1 not in keep:
                m12[i1] = -1
    return m12


def search_for_triangulation(kf1, kf2, coarse: bool = False,
                             check_rotation: bool = False):
    """Epipolar-gated matching of un-associated keypoints between two
    keyframes (ORBmatcher2.cc:179).  Returns list of (idx1, idx2)."""
    T1w, T2w = kf1.Tcw, kf2.Tcw
    T12 = T1w * T2w.inverse()
    R12, t12 = T12.R, T12.t
    # epipole of cam1 center in kf2 image
    c1_in2 = T2w * kf1.camera_center()
    if c1_in2[2] != 0:
        ep = kf2.camera.project(c1_in2[None])[0]
    else:
        ep = np.array([1e9, 1e9])

    free1 = np.array(
        [i for i in range(kf1.n) if kf1.map_points[i] is None], np.int64
    )
    free2 = np.array(
        [i for i in range(kf2.n) if kf2.map_points[i] is None], np.int64
    )
    if len(free1) == 0 or len(free2) == 0:
        return []
    # Batched gates (was per-candidate in a per-row walk: one argsort and
    # one desc_distances per free1 feature dominated local mapping).  The
    # greedy first-come-claims-i2 semantics of the reference walk are kept:
    # all order-independent gates (Hamming, epipole proximity, epipolar
    # line) are precomputed as matrices, then a cheap sequential scan
    # resolves the used2 interaction in the original order.
    from orbslam3_tpu.native import hamming_matrix as _hm

    import os

    fisheye = getattr(kf1, "camera2", None) is not None or getattr(
        kf2, "camera2", None
    ) is not None
    if fisheye and os.environ.get("ORBSLAM3_TPU_DUAL_TRI", "1") != "1":
        # A/B kill switch: left-block-only triangulation (pre-dual behavior)
        free1 = free1[free1 < kf1.n_left]
        free2 = free2[free2 < kf2.n_left]
        if len(free1) == 0 or len(free2) == 0:
            return []
        fisheye = False
    D = _hm(kf1.desc[free1], kf2.desc[free2])  # (n1, n2)
    valid = D <= TH_LOW
    stereo1 = kf1.u_right[free1] >= 0
    stereo2 = kf2.u_right[free2] >= 0
    if not fisheye:
        # epipole-proximity cull applies only to the single-camera mono
        # case (the reference gates it on !pKF1->mpCamera2)
        dxy = ep[None, :] - kf2.kps_un[free2]
        near_ep = (dxy * dxy).sum(axis=1) < (
            100 * kf2.scale_factors[kf2.octave[free2]] ** 2
        )
        valid &= ~(~stereo1[:, None] & (~stereo2 & near_ep)[None, :])
    ai, oi = np.nonzero(valid)
    if len(ai) and not fisheye:
        valid[ai, oi] = kf1.camera.epipolar_constrain(
            kf2.camera,
            kf1.kps_un[free1[ai]],
            kf2.kps_un[free2[oi]],
            R12,
            t12,
            kf2.level_sigma2[kf2.octave[free2[oi]]],
            unc=5.991 if not coarse else 50.0,
        )
    elif len(ai):
        # fisheye: each match side may be a left- or right-camera keypoint;
        # evaluate the epipolar/triangulation constraint per side combo with
        # the combo's relative pose and cameras (the reference's
        # Tll/Tlr/Trl/Trr + pCamera selection, ORBmatcher2.cc:179 region)
        side1 = free1[ai] >= kf1.n_left
        side2 = free2[oi] >= kf2.n_left
        t1_poses = [T1w, kf1.get_right_pose() if kf1.is_fisheye else T1w]
        t2_poses = [T2w, kf2.get_right_pose() if kf2.is_fisheye else T2w]
        cams1 = [kf1.camera, kf1.camera2 or kf1.camera]
        cams2 = [kf2.camera, kf2.camera2 or kf2.camera]
        unc = 5.991 if not coarse else 50.0
        for s1 in (False, True):
            for s2 in (False, True):
                m = (side1 == s1) & (side2 == s2)
                if not m.any():
                    continue
                t12c = t1_poses[s1] * t2_poses[s2].inverse()
                valid[ai[m], oi[m]] = cams1[s1].epipolar_constrain(
                    cams2[s2],
                    kf1.kps_un[free1[ai[m]]],
                    kf2.kps_un[free2[oi[m]]],
                    t12c.R,
                    t12c.t,
                    kf2.level_sigma2[kf2.octave[free2[oi[m]]]],
                    unc=unc,
                )
    order = np.argsort(D, axis=1, kind="stable")
    counts = np.count_nonzero(D <= TH_LOW, axis=1)
    pairs = []
    used2 = np.zeros(len(free2), bool)
    rot, rot_idx = [], []
    for a in range(len(free1)):
        best_j = -1
        for o in order[a, : counts[a]]:
            if used2[o] or not valid[a, o]:
                continue
            best_j = int(free2[o])
            used2[o] = True
            break
        if best_j >= 0:
            i1 = int(free1[a])
            pairs.append((i1, best_j))
            if check_rotation:
                dr = kf1.angle[i1] - kf2.angle[best_j]
                rot.append(dr + 360 if dr < 0 else dr)
                rot_idx.append(len(pairs) - 1)
    if check_rotation and pairs:
        keep = _rotation_consistency(rot, rot_idx)
        pairs = [p for k, p in enumerate(pairs) if k in keep]
    return pairs


def search_by_projection_scw(kf, scw, map_points, matched=None,
                             th: float = 10.0, hamming_ratio: float = 1.0):
    """Sim3-guided projection matcher (ORBmatcher1.cc SearchByProjection
    (KeyFrame*, Scw, vpPoints, vpMatched, th, ratioHamming) — used by loop
    detection refinement and SearchAndFuse during loop/merge).

    scw: Sim3 world->camera candidate pose of kf.  Projects each map point
    through the DE-SCALED pose (the reference divides out s), gates by
    image bounds, distance envelope, viewing angle, predicted octave, and
    Hamming <= TH_LOW * ratio.  Returns dict kf_idx -> MapPoint (seeded
    from `matched` which is never overwritten)."""
    from orbslam3_tpu.utils.lie import SE3

    # de-scale: Rcw, tcw/s  (reference: sRcw/scale, stcw/scale)
    tcw = SE3(scw.R, scw.t / scw.s)
    ow = tcw.inverse().t
    out: dict[int, object] = dict(matched) if matched else {}
    already_mps = {mp.id for mp in out.values()}
    for mp in map_points:
        if mp is None or mp.bad or mp.id in already_mps:
            continue
        pc = tcw * mp.position
        if pc[2] <= 0:
            continue
        uv = kf.camera.project(pc[None])[0]
        if not (kf.min_x < uv[0] < kf.max_x and kf.min_y < uv[1] < kf.max_y):
            continue
        dist = np.linalg.norm(mp.position - ow)
        if not (mp.min_distance <= dist <= mp.max_distance):
            continue
        if (mp.position - ow) @ mp.normal < 0.5 * dist:
            continue
        level = mp.predict_scale(dist, kf)
        r = th * kf.scale_factors[level]
        idx = kf.features_in_area(uv[0], uv[1], r, level - 1, level + 1)
        if len(idx) == 0:
            continue
        best, best_i = 256, -1
        dists = desc_distances(mp.descriptor, kf.desc[idx])
        for k_i, i in enumerate(idx):
            if i in out:
                continue
            d = int(dists[k_i])
            if d < best:
                best, best_i = d, i
        if best_i >= 0 and best <= TH_LOW * hamming_ratio:
            out[best_i] = mp
            already_mps.add(mp.id)
    return out


def search_by_sim3(kf1, kf2, s12, th: float = 7.5):
    """Mutual Sim3-guided matching between two keyframes
    (ORBmatcher::SearchBySim3 role): project kf2's map points into kf1
    through S12 and kf1's into kf2 through S21; keep only agreements.
    Returns dict kf1_idx -> kf2 MapPoint (new matches only)."""
    from orbslam3_tpu.utils.lie import Sim3

    s1w = Sim3.from_se3(kf1.Tcw)
    s2w = Sim3.from_se3(kf2.Tcw)
    scw1 = (s12 * s2w).normalized()          # world -> cam1 via candidate
    scw2 = (s12.inverse() * s1w).normalized()  # world -> cam2
    mps1 = [mp for _, mp in kf1.get_map_point_indices()]
    mps2 = [mp for _, mp in kf2.get_map_point_indices()]
    m1 = search_by_projection_scw(kf1, scw1, mps2, th=th)
    m2 = search_by_projection_scw(kf2, scw2, mps1, th=th)
    # mutual agreement: kf1 idx i matched to mp2; kf2 side must match mp2's
    # kf2 index back to the mp1 observed at kf1 idx i
    idx2_of_mp2 = {}
    for j, mp in kf2.get_map_point_indices():
        idx2_of_mp2[mp.id] = j
    mp1_at_idx1 = {i: mp for i, mp in kf1.get_map_point_indices()}
    out = {}
    for i, mp2 in m1.items():
        j = idx2_of_mp2.get(mp2.id)
        if j is None:
            continue
        mp1_back = m2.get(j)
        mp1_here = mp1_at_idx1.get(i)
        if mp1_back is not None and mp1_here is not None and mp1_back.id == mp1_here.id:
            out[i] = mp2
    return out


def _fuse_prefilter(kf, tcw, ow, map_points, cam=None):
    """Vectorized projection/frustum/distance/view-cos/level gates shared
    by fuse and fuse_scw; returns (cand, survivors, uv_all, z, levels).
    `cam` overrides the projection model (right-camera fuse pass)."""
    if cam is None:
        cam = kf.camera
    cand = [
        mp
        for mp in map_points
        if mp is not None and not mp.bad and kf not in mp.observations
    ]
    if not cand:
        return cand, np.zeros(0, np.int64), None, None, None
    pw = np.stack([mp.position for mp in cand])
    mind = np.asarray([mp.min_distance for mp in cand])
    maxd = np.asarray([mp.max_distance for mp in cand])
    normals = np.stack([mp.normal for mp in cand])
    pc = pw @ tcw.R.T + tcw.t
    z = pc[:, 2]
    uv_all = cam.project(np.where(z[:, None] > 1e-12, pc, [0, 0, 1.0]))
    v = pw - ow
    dist_all = np.sqrt((v * v).sum(axis=1))
    ok = (
        (z > 1e-12)
        & (kf.min_x < uv_all[:, 0]) & (uv_all[:, 0] < kf.max_x)
        & (kf.min_y < uv_all[:, 1]) & (uv_all[:, 1] < kf.max_y)
        & (mind <= dist_all) & (dist_all <= maxd)
        & ((v * normals).sum(axis=1) >= 0.5 * dist_all)
    )
    levels = np.clip(
        np.ceil(
            np.log(np.maximum(maxd / np.maximum(dist_all, 1e-9), 1e-12))
            / kf.log_scale_factor
        ),
        0,
        kf.n_levels - 1,
    ).astype(np.int64)
    return cand, np.nonzero(ok)[0], uv_all, z, levels


def fuse_scw(kf, scw, map_points, th: float = 4.0):
    """Sim3-guided fuse (ORBmatcher2.cc Fuse(KeyFrame*, Scw, vpPoints, th,
    vpReplacePoint) — used by LoopClosing::SearchAndFuse,
    /root/reference/src/LoopClosing3.cc:367): project each loop/merge point
    through the CORRECTED Sim3 pose; on a hit, an existing map point is
    replaced by the loop point, an empty slot gains an observation.
    Returns number fused."""
    from orbslam3_tpu.utils.lie import SE3

    tcw = SE3(scw.R, scw.t / scw.s)
    ow = tcw.inverse().t
    cand, survivors, uv_all, z, levels_all = _fuse_prefilter(
        kf, tcw, ow, map_points
    )
    n_fused = 0
    for j in survivors:
        mp = cand[j]
        if mp.bad or kf in mp.observations:  # may change as we fuse
            continue
        uv = uv_all[j]
        level = int(levels_all[j])
        r = th * kf.scale_factors[level]
        idx = kf.features_in_area(uv[0], uv[1], r, level - 1, level + 1)
        if len(idx) == 0:
            continue
        best, best_i = 256, -1
        dists = desc_distances(mp.descriptor, kf.desc[idx])
        for k_i, i in enumerate(idx):
            d = int(dists[k_i])
            if d < best:
                best, best_i = d, i
        if best <= TH_LOW and best_i >= 0:
            existing = kf.map_points[best_i]
            if existing is not None and not existing.bad:
                existing.replace(mp)
            else:
                mp.add_observation(kf, best_i)
                kf.add_map_point(mp, best_i)
            n_fused += 1
    return n_fused


def fuse(kf, map_points, th: float = 3.0):
    """Project map points into the keyframe and fuse duplicates
    (ORBmatcher2.cc:420).  Returns number fused/added.

    The projection/frustum/distance/view-cos gates run as one vectorized
    prefilter over the whole candidate batch (they reject the vast majority;
    the per-survivor grid walk + chi2/Hamming stays scalar).  Fisheye
    keyframes run a second pass over the right camera (the reference Fuse's
    bRight loop): right-grid hits carry global indices >= n_left, so the
    association lands as a right-camera observation of the same point."""
    import os

    n = _fuse_pass(kf, map_points, th, right=False)
    if (
        getattr(kf, "camera2", None) is not None
        and os.environ.get("ORBSLAM3_TPU_DUAL_FUSE", "1") == "1"
    ):
        n += _fuse_pass(kf, map_points, th, right=True)
    return n


def _fuse_pass(kf, map_points, th: float, right: bool):
    if right:
        tcw = kf.get_right_pose()
        ow = tcw.inverse().t
        cam = kf.camera2
    else:
        tcw = kf.Tcw
        ow = kf.camera_center()
        cam = kf.camera
    cand, survivors, uv_all, z, levels_all = _fuse_prefilter(
        kf, tcw, ow, map_points, cam
    )
    n_fused = 0
    for j in survivors:
        mp = cand[j]
        if mp.bad or kf in mp.observations:  # may change as we fuse
            continue
        uv = uv_all[j]
        level = int(levels_all[j])
        r = th * kf.scale_factors[level]
        idx = kf.features_in_area(uv[0], uv[1], r, level - 1, level + 1, right)
        if len(idx) == 0:
            continue
        ur_pred = uv[0] - kf.mbf / z[j] if (kf.mbf > 0 and not right) else -1
        best, best_i = 256, -1
        dists = desc_distances(mp.descriptor, kf.desc[idx])
        for k_i, i in enumerate(idx):
            # chi2 gate on reprojection
            kp = kf.kps_un[i]
            inv_s2 = kf.inv_level_sigma2[kf.octave[i]]
            if kf.u_right[i] >= 0 and ur_pred >= 0:
                e = (uv[0] - kp[0]) ** 2 + (uv[1] - kp[1]) ** 2 + (
                    ur_pred - kf.u_right[i]
                ) ** 2
                if e * inv_s2 > 7.8:
                    continue
            else:
                e = (uv[0] - kp[0]) ** 2 + (uv[1] - kp[1]) ** 2
                if e * inv_s2 > 5.99:
                    continue
            d = int(dists[k_i])
            if d < best:
                best, best_i = d, i
        if best <= TH_LOW and best_i >= 0:
            existing = kf.map_points[best_i]
            if existing is not None and not existing.bad:
                if existing.n_obs > mp.n_obs:
                    mp.replace(existing)
                else:
                    existing.replace(mp)
            else:
                mp.add_observation(kf, best_i)
                kf.add_map_point(mp, best_i)
            n_fused += 1
    return n_fused
