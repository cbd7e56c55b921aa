"""Smoke test of the stereo SLAM path on one GPU (or four, with --multi 4).

    python chip_smoke.py             # phases (a)-(e) on one card
    python chip_smoke.py --multi 4   # only the frame-parallel path on four

Phases, each printed as one `phase ...` line:
  (a) environment: card name and power limit, JAX versions, XLA_FLAGS, the
      compile-cache directory, the native host libraries (required);
  (b) stage parity against the NumPy oracle at 752x480, 8 levels, scale
      1.2, 1200 features: pyramid, blur, FAST score and NMS maps and the
      composite two-threshold detection bit-exact; IC angles and rBRIEF
      within the platform-trig tolerances; LR stereo matches; the window
      gathers bit-exact; every matrix product of the compiled front-end
      with bf16 operands;
  (c) 120 synthetic EuRoC-shape frames through System.track_stereo: every
      frame tracked, ATE < 1 cm; the prefetched and the batched (B=8)
      paths give features bit-equal to the synchronous path;
  (d) one frame through each other device program a user can reach:
      mono (1x and the 5x init extractor), RGB-D, fisheye stereo;
  (e) one jax.profiler trace of a few stereo frames: the five device ops
      that took longest, and the FAST and window-gather stage times.

Refuses to run unless JAX's default backend is a GPU.  The last line of
standard output is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
and is printed only when every phase passed; otherwise the exit code is 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 480, 752          # EuRoC cam0 geometry
N_FEATURES = 1200        # EuRoC.yaml ORBextractor.nFeatures
# EuRoC cam0 intrinsics and baseline (EuRoC.yaml Camera1.*, Stereo.b)
EUROC_K = (458.654, 457.296, 367.215, 248.375)
EUROC_BASELINE = 0.110074


def _params(n_features=N_FEATURES):
    from orbslam3_tpu.oracle.orb_cpu import PyramidParams

    return PyramidParams(n_features=n_features, scale_factor=1.2, n_levels=8)


def _camera(h, w):
    from orbslam3_tpu.cameras.models import Pinhole

    fx, fy, cx, cy = EUROC_K
    s = w / W  # keep the EuRoC field of view at reduced test sizes
    return Pinhole([fx * s, fy * s, cx * s, cy * s])


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------- (a)
def environment() -> dict:
    import jax
    import jaxlib

    from orbslam3_tpu import native
    from orbslam3_tpu.native import hostops
    from orbslam3_tpu.utils.compile_cache import setup_compile_cache

    info = {
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
        "compile_cache_dir": setup_compile_cache(),
        "native": native.available(),
        "hostops": hostops.available(),
    }
    for mod in ("cv2", "yaml"):
        try:
            __import__(mod)
            info[mod] = True
        except ImportError:
            info[mod] = False
    _check(info["native"], "native host library unavailable (g++ build failed)")
    _check(info["hostops"], "native hostops extension unavailable")
    return info


def gpu_name_and_power() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [l.strip() for l in out.stdout.splitlines() if l.strip()]


# ---------------------------------------------------------------- (b)
def _stereo_frame(h, w, seed=3):
    from orbslam3_tpu.utils.synth import stereo_sequence

    img_l, img_r, _ = stereo_sequence(1, _camera(h, w), EUROC_BASELINE, h, w, seed=seed)[0]
    return img_l, img_r


def stage_parity(h=H, w=W, n_features=N_FEATURES, check_hlo=True) -> dict:
    """Device stages vs the NumPy oracle on one synthetic stereo frame."""
    import jax
    import jax.numpy as jnp

    from orbslam3_tpu.frontend import stereo_frame as sf
    from orbslam3_tpu.ops import fast as df
    from orbslam3_tpu.ops import pyramid as dp
    from orbslam3_tpu.ops.extractor import detection_crops, extract_features_jit
    from orbslam3_tpu.oracle import orb_cpu as oc
    from orbslam3_tpu.oracle import stereo_cpu

    params = _params(n_features)
    img_l, img_r = _stereo_frame(h, w)
    res = {}

    # pyramid, blur, FAST score and NMS maps: bit-exact per level
    pyr_dev = [np.asarray(l) for l in dp.build_pyramid(jnp.asarray(img_l), params)]
    pyr_ref = oc.build_pyramid(img_l, params)
    _check(len(pyr_dev) == len(pyr_ref), "pyramid level count")
    for lvl, (a, b) in enumerate(zip(pyr_dev, pyr_ref)):
        _check(a.shape == b.shape and np.array_equal(a, b), f"pyramid level {lvl}")
        _check(np.array_equal(np.asarray(dp.gaussian_blur7_u8(jnp.asarray(b))),
                              oc.gaussian_blur7_u8(b)), f"blur level {lvl}")
        for th in (params.ini_th_fast, params.min_th_fast):
            sd = df.fast_score_map(jnp.asarray(b), th)
            sr = oc.fast_score_map(b, th)
            _check(np.array_equal(np.asarray(sd), sr), f"FAST score level {lvl} th {th}")
            _check(np.array_equal(np.asarray(df.nms3(sd)), oc.nms3(sr)),
                   f"NMS level {lvl} th {th}")
    res["pyramid_blur_fast_nms_levels_bit_exact"] = len(pyr_ref)

    # the composite two-threshold detection the main program runs
    active, crops = detection_crops([jnp.asarray(l) for l in pyr_ref], params)
    maps = jax.jit(
        lambda cs: df.detect_two_threshold_multi(
            cs, params.ini_th_fast, params.min_th_fast)
    )(crops)
    n_corners = 0
    for lvl, m, crop in zip(active, maps, crops):
        m = np.asarray(m)
        want = oc.fast_keypoints_two_threshold(
            np.asarray(crop), params.ini_th_fast, params.min_th_fast)
        ys, xs = np.nonzero(m)
        got = np.stack([xs, ys, m[ys, xs]], axis=1).astype(np.float32)
        _check(np.array_equal(got[np.lexsort(got.T[::-1])],
                              want[np.lexsort(want.T[::-1])]),
               f"composite two-threshold detection level {lvl}")
        n_corners += len(want)
    res["composite_detect_corners_bit_exact"] = n_corners

    # IC angles and rBRIEF at the device's keypoints (tests/test_extractor)
    feats = {k: np.asarray(v) for k, v in
             extract_features_jit(jnp.asarray(img_l), params)._asdict().items()}
    total = exact = 0
    max_ang = max_bits = 0.0
    for lvl in range(params.n_levels):
        sel = np.nonzero(feats["valid"] & (feats["octave"] == lvl))[0]
        if len(sel) == 0:
            continue
        pts = np.rint(feats["xy"][sel] * params.inv_scale_factors[lvl]).astype(np.float32)
        want_ang = oc.ic_angles(pyr_ref[lvl], pts)
        d = np.abs(want_ang - feats["angle"][sel])
        max_ang = max(max_ang, float(np.minimum(d, 360 - d).max()))
        want_desc = oc.brief_descriptors(
            oc.gaussian_blur7_u8(pyr_ref[lvl]), pts, want_ang, raw=pyr_ref[lvl])
        bits = np.unpackbits(want_desc ^ feats["desc"][sel], axis=1).sum(1)
        max_bits = max(max_bits, int(bits.max()))
        total += len(sel)
        exact += int((bits == 0).sum())
    _check(total > 0.8 * n_features, f"only {total} keypoints")
    _check(max_ang < 1e-3, f"IC angle off by {max_ang} deg")
    _check(max_bits <= 8 and exact / total >= 0.95,
           f"descriptors: {exact}/{total} exact, max {max_bits} bits")
    res.update(keypoints=total, angle_max_err_deg=max_ang,
               desc_exact_fraction=exact / total, desc_max_bits=max_bits)

    # LR stereo matches vs the oracle matcher (tests/test_stereo)
    out = jax.tree.map(np.asarray, sf.extract_and_match_stereo(
        np.stack([img_l, img_r]), params))
    vl, vr = out.left.valid, out.right.valid
    kps = [np.stack([f.xy[:, 0], f.xy[:, 1], f.octave, f.angle], 1)[v]
           for f, v in ((out.left, vl), (out.right, vr))]
    u_ref, d_ref = stereo_cpu.compute_stereo_matches(
        kps[0], out.left.desc[vl], kps[1], out.right.desc[vr],
        pyr_ref, oc.build_pyramid(img_r, params), params.scale_factors,
        sf.DEFAULT_MBF, sf.DEFAULT_MBF / sf.DEFAULT_FX)
    u_dev, d_dev = out.u_right[vl], out.depth[vl]
    m_ref, m_dev = u_ref >= 0, u_dev >= 0
    _check(np.array_equal(m_dev, m_ref), "stereo matched sets differ")
    _check(m_ref.sum() > 20, f"only {m_ref.sum()} stereo matches")
    _check(np.allclose(u_dev[m_dev], u_ref[m_ref], rtol=0, atol=1e-4), "u_right")
    _check(np.allclose(d_dev[m_dev], d_ref[m_ref], rtol=1e-5, atol=0), "depth")
    res["stereo_matches"] = int(m_ref.sum())

    # window gathers vs NumPy indexing at composite scale, clamps included
    res["gathered_windows"] = gather_parity(2 * h + 200, w + 300, 2 * n_features)

    if check_hlo:
        res["matrix_products"] = hlo_products(h, w, params)
    return res


def gather_parity(h, w, k, seed=11) -> int:
    """gather_windows / sample_windows / window_moments vs NumPy."""
    import jax.numpy as jnp

    from orbslam3_tpu.oracle.orb_cpu import ic_moment_weights
    from orbslam3_tpu.ops.patches import gather_windows, sample_windows, window_moments

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w), np.uint8)
    n = 0
    for nr, nc in ((11, 11), (11, 21), (31, 31), (37, 37)):
        row0 = rng.integers(-8, h - nr + 8, k).astype(np.int32)
        col0 = rng.integers(-8, w - nc + 8, k).astype(np.int32)
        r = np.clip(row0, 0, h - nr)
        c = np.clip(col0, 0, w - nc)
        want = np.stack([img[a : a + nr, b : b + nc] for a, b in zip(r, c)])
        got = np.asarray(gather_windows(
            jnp.asarray(img), jnp.asarray(row0), jnp.asarray(col0), nr, nc))
        _check(np.array_equal(got.astype(np.int32), want), f"gather_windows {nr}x{nc}")
        n += k
    ridx = rng.integers(0, 37, (k, 512)).astype(np.int32)
    cidx = rng.integers(0, 37, (k, 512)).astype(np.int32)
    got = np.asarray(sample_windows(
        jnp.asarray(img), jnp.asarray(r), jnp.asarray(c),
        jnp.asarray(ridx), jnp.asarray(cidx), 37, 37))
    _check(np.array_equal(got, img[r[:, None] + ridx, c[:, None] + cidx]),
           "sample_windows")
    w10, w01 = ic_moment_weights()
    nr = w10.shape[0]
    r = np.clip(r, 0, h - nr)
    c = np.clip(c, 0, w - nr)
    m10, m01 = window_moments(jnp.asarray(img), jnp.asarray(r), jnp.asarray(c),
                              w10.astype(np.float32), w01.astype(np.float32))
    pat = np.stack([img[a : a + nr, b : b + nr] for a, b in zip(r, c)]).astype(np.int64)
    _check(np.array_equal(np.asarray(m10), (pat * w10).sum((1, 2)))
           and np.array_equal(np.asarray(m01), (pat * w01).sum((1, 2))),
           "window_moments")
    return n


def hlo_products(h, w, params) -> dict:
    """Matrix products of the compiled stereo front-end: every one must
    take bf16 operands (an f32 product may run in TF32 on this card)."""
    import jax

    from orbslam3_tpu.frontend import stereo_frame as sf
    from tools.dump_hlo import dot_signatures, full_precision_products

    txt = sf.extract_and_match_stereo_packed.lower(
        jax.ShapeDtypeStruct((2, h, w), np.uint8), params,
        sf.DEFAULT_MBF, sf.DEFAULT_FX,
    ).compile().as_text()
    sigs = dot_signatures(txt)
    bad = full_precision_products(sigs)
    _check(sigs and not bad, f"full-precision products: {bad}")
    return {f"{op}({','.join(i)})->{o}": n for (op, i, o), n in sorted(sigs.items())}


# ---------------------------------------------------------------- (c)
def _features_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def system_e2e(h=H, w=W, n_features=N_FEATURES, n_frames=120, batch=8,
               min_tracked=1.0, max_ate=0.01) -> dict:
    """Synthetic EuRoC-shape sequence through System's stereo entry points."""
    from orbslam3_tpu.frontend import stereo_frame as sf
    from orbslam3_tpu.slam.system import System
    from orbslam3_tpu.slam.tracking import TrackingState
    from orbslam3_tpu.utils.synth import ate_rmse, stereo_sequence

    camera = _camera(h, w)
    mbf = camera.fx * EUROC_BASELINE
    params = _params(n_features)
    frames = stereo_sequence(n_frames, camera, EUROC_BASELINE, h, w, seed=1)

    def make():
        return System(camera, mbf, params, sequential=True, max_frames=20)

    # synchronous path, recording the features each frame was tracked with
    sync = make()
    feats_sync = []
    extract = sync._extract_stereo
    sync._extract_stereo = lambda l, r: feats_sync.append(extract(l, r)) or feats_sync[-1]
    est, gt, times, ok_states = [], [], [], 0
    for k, (il, ir, tcw) in enumerate(frames):
        t0 = time.perf_counter()
        pose = sync.track_stereo(il, ir, k / 20.0)
        times.append((time.perf_counter() - t0) * 1e3)
        ok_states += sync.get_tracking_state() == TrackingState.OK
        if pose is not None:
            est.append(pose)
            gt.append(tcw)
    sync.shutdown()
    tracked = ok_states / n_frames
    ate = ate_rmse(est, gt) if len(est) >= 2 else float("inf")
    steady = np.asarray(times[1:])  # frame 0 includes compilation
    res = {
        "tracked_fraction": tracked, "ate_rmse_m": ate,
        "frame_ms_median": float(np.median(steady)),
        "frame_ms_p99": float(np.percentile(steady, 99)),
        "frame_ms_samples": len(steady),
        "first_frame_ms": times[0],
    }

    # prefetched path (depth 1): handle k+1 dispatched before frame k tracks
    pre = make()
    handles = [pre.prefetch_stereo(frames[0][0], frames[0][1])]
    same_pre = True
    for k in range(n_frames):
        if k + 1 < n_frames:
            handles.append(pre.prefetch_stereo(frames[k + 1][0], frames[k + 1][1]))
        h_k = handles[k]
        same_pre &= _features_equal(sf.unpack_host_features(np.asarray(h_k[0])), feats_sync[k])
        pre.track_stereo_prefetched(h_k, k / 20.0)
        handles[k] = None
    pre.shutdown()

    # batched path: one scan-batched dispatch per window of `batch` frames
    bat = make()
    same_bat = True
    for k0 in range(0, n_frames, batch):
        window = frames[k0 : k0 + batch]
        for j, hd in enumerate(bat.prefetch_stereo_batch([(l, r) for l, r, _ in window])):
            same_bat &= _features_equal(
                sf.unpack_host_features(np.asarray(hd[0])), feats_sync[k0 + j])
            bat.track_stereo_prefetched(hd, (k0 + j) / 20.0)
    bat.shutdown()
    res.update(prefetched_bit_equal=bool(same_pre), batched_bit_equal=bool(same_bat))
    _check(tracked >= min_tracked, f"tracked fraction {tracked}")
    _check(ate < max_ate, f"ATE {ate} m")
    _check(same_pre, "prefetched features differ from the synchronous path")
    _check(same_bat, "batched features differ from the synchronous path")
    return res


# ---------------------------------------------------------------- (d)
def other_programs(h=H, w=W, n_features=N_FEATURES) -> dict:
    """One frame through the mono (1x and 5x init), RGB-D and fisheye
    programs."""
    import jax.numpy as jnp

    from orbslam3_tpu.frontend.fisheye import extract_fisheye_pair
    from orbslam3_tpu.ops.extractor import extract_features_jit
    from orbslam3_tpu.slam.system import System
    from orbslam3_tpu.utils.synth import rgbd_sequence

    camera = _camera(h, w)
    params = _params(n_features)
    img_l, img_r = _stereo_frame(h, w)
    res = {}
    for name, p in (("mono_1x", params), ("mono_5x_init", _params(5 * n_features))):
        f = extract_features_jit(jnp.asarray(img_l), p)
        n = int(np.asarray(f.valid).sum())
        _check(n > 0 and np.isfinite(np.asarray(f.xy)).all(), name)
        res[name + "_keypoints"] = n
    mono = System(camera, 0.0, params, sensor=System.MONOCULAR)
    mono.track_monocular(img_l, 0.0)  # uninitialised: runs the 5x extractor
    mono.shutdown()
    img, depth, _ = rgbd_sequence(1, camera, h, w, seed=2)[0]
    rgbd = System(camera, camera.fx * 0.08, params, sensor=System.RGBD)
    rgbd.track_rgbd(img, depth, 0.0)
    res["rgbd_keypoints"] = len(rgbd.tracker.last_frame.kps)
    rgbd.shutdown()
    fl, fr = extract_fisheye_pair(img_l, img_r, params, (0.0, w - 1.0), (0.0, w - 1.0))
    _check(len(fl["kps"]) > 0 and len(fr["kps"]) > 0, "fisheye pair")
    res["fisheye_keypoints"] = [len(fl["kps"]), len(fr["kps"])]
    return res


# ---------------------------------------------------------------- (e)
def trace_frames(h=H, w=W, n_features=N_FEATURES, n_frames=4) -> dict:
    """Profile a few stereo frames through the packed front-end."""
    import jax

    from orbslam3_tpu.frontend import stereo_frame as sf
    from orbslam3_tpu.utils.synth import stereo_sequence
    from tools.attribute_trace import hlo_scope_map
    from tools.trace_ops import TRACE_COMPILER_OPTIONS, parse_xplane

    camera = _camera(h, w)
    params = _params(n_features)
    mbf = camera.fx * EUROC_BASELINE
    frames = stereo_sequence(n_frames, camera, EUROC_BASELINE, h, w, seed=4)
    pairs = [np.stack([l, r]) for l, r, _ in frames]
    exe = sf.extract_and_match_stereo_packed.lower(
        pairs[0], params, mbf, camera.fx
    ).compile(compiler_options=TRACE_COMPILER_OPTIONS)
    np.asarray(exe(pairs[0]))
    log_dir = os.path.join(HERE, ".traces", "chip_smoke_%d" % int(time.time()))
    jax.profiler.start_trace(log_dir)
    for p in pairs:
        np.asarray(exe(p))
    jax.profiler.stop_trace()
    rows, busy_us, window_us, path = parse_xplane(log_dir)
    scopes = hlo_scope_map(exe.as_text())

    def stage_us(*names):
        return sum(d for op, d in rows.items()
                   if any(n in scopes.get(op, "") for n in names)) / n_frames

    top = sorted(rows.items(), key=lambda kv: -kv[1])[:5]
    res = {
        "trace": os.path.relpath(path, HERE),
        "device_us_per_frame": sum(rows.values()) / n_frames,
        "device_busy_share_of_window": busy_us / window_us,
        "fast_detect_us_per_frame": stage_us("fast_detect"),
        # window_moments and sample_windows hold a gather_windows scope
        "gather_us_per_frame": stage_us(
            "gather_windows", "sample_windows", "window_moments"),
        "top5_ops_us_per_frame": [(op, d / n_frames) for op, d in top],
    }
    _check(res["fast_detect_us_per_frame"] > 0, "no device time under fast_detect")
    return res


# ---------------------------------------------------------------- main
def _run_phase(name, fn, failed) -> None:
    t0 = time.perf_counter()
    try:
        res = fn()
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s) "
              + json.dumps(res, default=str), flush=True)
    except Exception:
        failed.append(name)
        print(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)", flush=True)
        traceback.print_exc()
        sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", type=int, default=0, metavar="N",
                    help="run only the frame-parallel path on N cards")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX's default backend is {jax.default_backend()!r}, "
              "not 'gpu'; refusing to run", file=sys.stderr)
        return 2
    import orbslam3_tpu

    if os.path.dirname(os.path.dirname(os.path.abspath(orbslam3_tpu.__file__))) != HERE:
        print("chip_smoke: orbslam3_tpu is not the package beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)  # tools/ and __graft_entry__
    from orbslam3_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    failed: list = []
    if args.multi:
        from __graft_entry__ import dryrun_multichip

        _run_phase(f"multi_{args.multi}", lambda: {
            "digests": dryrun_multichip(args.multi).tolist()}, failed)
    else:
        _run_phase("a_environment", environment, failed)
        _run_phase("b_stage_parity", stage_parity, failed)
        _run_phase("c_system_e2e", system_e2e, failed)
        _run_phase("d_other_programs", other_programs, failed)
        _run_phase("e_trace", trace_frames, failed)
    for line in gpu_name_and_power():
        print(f"card: {line}", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
