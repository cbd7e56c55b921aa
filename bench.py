"""Benchmark: steady-state stereo ORB extraction + matching on the GPU.

Prints one JSON line per measurement and, last, the headline:
  {"metric": ..., "value": N, "unit": "ms", "vs_baseline": N, "device": {...}}

Baseline: the reference's measured 38.53 ms/frame ORB extraction on EuRoC
MH01 stereo (ExecMean.txt:6, see BASELINE.md).  `vs_baseline` is the speedup
factor (baseline / ours; >1 means faster than the reference).

Benchmarks the headline per-frame front-end: stereo pair (2x 752x480, 8
levels, 1000 features/camera) extraction through the fused device pipeline,
plus left-right descriptor matching.  Every line names the device it ran
on; a run without a GPU fails, and so does a run in which any phase fails.
"""

import json
import os
import sys
import time
import traceback

import numpy as np

BASELINE_EXTRACT_MS = 38.53  # reference ExecMean.txt:6 (+ 7.74 stereo match, :7)
HEADLINE_METRIC = "stereo_orb_extract_match_ms_per_frame"


def make_frame(seed: int, h: int = 480, w: int = 752) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (
        120 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0) + rng.normal(0, 18, (h, w))
    ).clip(0, 255)
    for _ in range(120):
        cx, cy = int(rng.integers(20, w - 20)), int(rng.integers(20, h - 20))
        r = int(rng.integers(3, 14))
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = int(rng.integers(0, 256))
    return img.astype(np.uint8)


def _init_jax():
    """JAX with the persistent compile cache; refuses to run off the GPU."""
    import jax

    from orbslam3_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX's backend is {jax.default_backend()!r}"
        )
    return jax


def _device(jax) -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def _build_run(jax, params, n: int):
    """Scan program over n stereo pairs; digest defeats DCE."""
    import jax.numpy as jnp

    from orbslam3_tpu.frontend import stereo_frame as sf

    pairs = jax.device_put(
        np.stack(
            [np.stack([make_frame(2 * i), make_frame(2 * i + 1)]) for i in range(n)]
        )
    )

    @jax.jit
    def run(ps):
        out = sf.extract_and_match_stereo_sequence.__wrapped__(
            ps, params, sf.DEFAULT_MBF, sf.DEFAULT_FX
        )
        acc = jnp.float32(0)
        for leaf in jax.tree.leaves(out):
            acc = acc + leaf.astype(jnp.float32).sum()
        return acc

    return run, pairs


def _median_wall_ms(run, pairs, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(run(pairs))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _emit(line: dict, device: dict) -> None:
    print(json.dumps({**line, "device": device}), flush=True)


def _headline(jax, params, state, device):
    """Stage A: n=128 frames in ONE lax.scan dispatch, median wall / n;
    B1: slope between scan lengths 8 and 128 (dispatch cost cancels)."""
    n = 128
    run, pairs = _build_run(jax, params, n)
    np.asarray(run(pairs))  # compile + warmup
    wall = min(_median_wall_ms(run, pairs, 3), _median_wall_ms(run, pairs, 3))
    state["headline_ms"] = wall / n
    run8, pairs8 = _build_run(jax, params, 8)
    np.asarray(run8(pairs8))
    wall8 = _median_wall_ms(run8, pairs8, 3)
    _emit({
        "metric": "stereo_extract_match_slope_ms_per_frame",
        "value": (wall - wall8) / (n - 8),
        "unit": "ms",
        "note": "(wall(128)-wall(8))/120; per-dispatch cost cancels",
    }, device)


def _batch1(jax, params, state, device):
    """B2: one stereo pair per dispatch, host->device copy included."""
    import jax.numpy as jnp

    from orbslam3_tpu.frontend import stereo_frame as sf

    @jax.jit
    def run_one(pair):
        out = sf.extract_and_match_stereo.__wrapped__(
            pair, params, sf.DEFAULT_MBF, sf.DEFAULT_FX
        )
        acc = jnp.float32(0)
        for leaf in jax.tree.leaves(out):
            acc = acc + leaf.astype(jnp.float32).sum()
        return acc

    one_host = np.stack([make_frame(0), make_frame(1)])
    np.asarray(run_one(jax.device_put(one_host)))  # compile
    b1 = []
    for _ in range(20):
        t0 = time.perf_counter()
        np.asarray(run_one(jax.device_put(one_host)))
        b1.append((time.perf_counter() - t0) * 1e3)
    _emit({
        "metric": "stereo_batch1_latency_ms",
        "value": float(np.median(b1)),
        "p90": float(np.percentile(b1, 90)),
        "samples": len(b1),
        "unit": "ms",
    }, device)


def _full_system(jax, params, state, device):
    """B5: device front-end + host tracking/mapping through the prefetch
    pipeline (async dispatch + async device->host copy), depth 1."""
    from orbslam3_tpu.cameras.models import Pinhole
    from orbslam3_tpu.slam.system import System
    from orbslam3_tpu.utils.synth import ate_rmse, stereo_sequence

    fx, h, w, baseline, n_frames = 350.0, 480, 752, 0.12, 80
    camera = Pinhole([fx, fx, w / 2, h / 2])
    frames = stereo_sequence(n_frames, camera, baseline, h, w, seed=1)
    sysm = System(camera, fx * baseline, params, sequential=False)
    est, gt, times = [], [], []
    handle = sysm.prefetch_stereo(frames[0][0], frames[0][1])
    for kf in range(n_frames):
        t0 = time.perf_counter()
        nxt = (
            sysm.prefetch_stereo(frames[kf + 1][0], frames[kf + 1][1])
            if kf + 1 < n_frames else None
        )
        pose = sysm.track_stereo_prefetched(handle, kf / 20.0)
        handle = nxt
        if kf >= 10:
            times.append((time.perf_counter() - t0) * 1e3)
        if pose is not None:
            est.append(pose)
            gt.append(frames[kf][2])
    sysm.shutdown()
    _emit({
        "metric": "slam_system_ms_per_frame_pipelined",
        "value": float(np.median(times)),
        "p90": float(np.percentile(times, 90)),
        "samples": len(times),
        "unit": "ms",
        "tracked": len(est),
        "frames": n_frames,
        "ate_rmse_m": float(ate_rmse(est, gt)) if len(est) >= 2 else None,
    }, device)


def _batched(jax, params, state, device):
    """B6: scan-batched front-end (B frames per dispatch), slope over scan
    rounds so per-dispatch cost cancels."""
    import jax.numpy as jnp

    from orbslam3_tpu.frontend import stereo_frame as sf

    B, m_hi, m_lo = 8, 16, 2
    batch_np = np.stack(
        [np.stack([make_frame(1000 + 2 * i), make_frame(1001 + 2 * i)])
         for i in range(m_hi * B)]
    ).reshape(m_hi, B, 2, 480, 752)

    def build(m):
        data = jax.device_put(batch_np[:m])

        @jax.jit
        def run(bs):
            def body(c, bp):
                out = sf.extract_and_match_stereo_packed_batch.__wrapped__(
                    bp, params, sf.DEFAULT_MBF, sf.DEFAULT_FX
                )
                return c + out.astype(jnp.float32).sum(), None

            return jax.lax.scan(body, jnp.float32(0), bs)[0]

        return run, data

    run_hi, data_hi = build(m_hi)
    run_lo, data_lo = build(m_lo)
    np.asarray(run_hi(data_hi))
    np.asarray(run_lo(data_lo))
    per_batch_ms = (
        _median_wall_ms(run_hi, data_hi, 3) - _median_wall_ms(run_lo, data_lo, 3)
    ) / (m_hi - m_lo)
    _emit({
        "metric": "stereo_frames_per_sec_batch%d" % B,
        "value": 1000.0 * B / per_batch_ms,
        "unit": "frames/s",
        "batch_ms": per_batch_ms,
    }, device)


def _attribution(jax, params, state, device):
    """B8: per-source-file device time from a profiler trace joined with
    the optimized HLO's source metadata."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tools.attribute_trace import hlo_source_map
    from tools.trace_ops import build_run, capture, parse_xplane

    run8, pairs8 = build_run()
    log_dir = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".traces",
        "bench_attr_%d" % int(time.time()),
    )
    smap = hlo_source_map(capture(run8, pairs8, log_dir).as_text())
    rows, busy_us, window_us, _path = parse_xplane(log_dir)
    per_file: dict = {}
    for name, dur in rows.items():
        key = smap.get(name)
        f = os.path.basename(key[0]) if key else "<unattributed>"
        per_file[f] = per_file.get(f, 0.0) + dur
    nfr = 8
    _emit({
        "metric": "in_program_stage_us_per_frame",
        "value": sum(per_file.values()) / nfr,
        "unit": "us/frame",
        "device_idle_share": 1.0 - busy_us / window_us,
        "per_file": {
            f: d / nfr for f, d in sorted(per_file.items(), key=lambda kv: -kv[1])
        },
        "note": "device-op us per source file (profiler trace x optimized-HLO metadata), n=8 scan",
    }, device)


PHASES = (
    ("headline", _headline),
    ("batch1", _batch1),
    ("full_system", _full_system),
    ("batched", _batched),
    ("attribution", _attribution),
)


def main() -> int:
    jax = _init_jax()
    from orbslam3_tpu.oracle.orb_cpu import PyramidParams

    params = PyramidParams(n_features=1000)
    device = _device(jax)
    state: dict = {}
    failed = []
    for name, phase in PHASES:
        try:
            phase(jax, params, state, device)
        except Exception:  # a failed phase is reported, then fails the run
            traceback.print_exc()
            failed.append(name)
    v = state.get("headline_ms")
    _emit({
        "metric": HEADLINE_METRIC,
        "value": v,
        "unit": "ms",
        "vs_baseline": None if v is None else BASELINE_EXTRACT_MS / v,
        "failed_phases": failed,
    }, device)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
