"""A/B: FAST raw score as XLA's fusion of the roll formulation
(ops.fast.raw_score_xla) vs the Pallas kernel through Triton
(ops.fast.raw_score_triton), on the stereo composite path.

Prints JSON lines: per tile shape, the kernel's and XLA's parity with the
NumPy oracle and the per-stereo-frame wall time of (a) pyramid + composite FAST
detection and (b) the whole packed stereo front-end, each as a 64-frame
lax.scan (wall / 64), in the order xla, triton, triton, xla.

Usage: python tools/fast_ab.py [--interpret]
"""

import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam3_tpu.ops import fast as F  # noqa: E402


def _frames(n):
    from bench import make_frame

    return np.stack(
        [np.stack([make_frame(2 * i), make_frame(2 * i + 1)]) for i in range(n)]
    )


def _programs(params, score_fn):
    """(detect-only scan, full packed front-end scan) traced with
    ops.fast.raw_score_map replaced by `score_fn`."""
    from orbslam3_tpu.frontend import stereo_frame as sf
    from orbslam3_tpu.ops.extractor import detection_crops
    from orbslam3_tpu.ops.pyramid import build_pyramid

    def detect(pair):
        crops = []
        for cam in range(2):
            crops += detection_crops(build_pyramid(pair[cam], params), params)[1]
        maps = F.detect_two_threshold_multi(
            crops, params.ini_th_fast, params.min_th_fast
        )
        return sum(m.astype(jnp.float32).sum() for m in maps)

    def full(pair):
        return sf._pack_features(
            sf._extract_and_match_stereo_impl(pair, params)
        ).sum()

    def scan_of(fn):
        @jax.jit
        def run(pairs):
            orig = F.raw_score_map
            F.raw_score_map = score_fn
            try:
                return jax.lax.scan(lambda c, p: (c + fn(p), None), 0.0, pairs)[0]
            finally:
                F.raw_score_map = orig

        return run

    return scan_of(detect), scan_of(full)


def _time(run, data, reps=5):
    np.asarray(run(data))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(run(data))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    from orbslam3_tpu.oracle.orb_cpu import PyramidParams, fast_score_map
    from orbslam3_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    interpret = "--interpret" in sys.argv
    n = 4 if interpret else 64
    h, w = (96, 128) if interpret else (480, 752)
    params = PyramidParams(n_features=64 if interpret else 1200)
    data = jax.device_put(_frames(n)[:, :, :h, :w])
    dev = jax.devices()[0]
    # parity against the NumPy oracle at the frame's own shape (XLA:GPU
    # has compiled the roll formulation wrongly at 480x752)
    probe_np = np.random.default_rng(0).integers(0, 256, (h, w), np.uint8)
    probe = jnp.asarray(probe_np)
    want = fast_score_map(probe_np, 1)

    def bit_exact(fn):
        raw = np.asarray(jax.jit(fn)(probe))
        return bool(np.array_equal(np.where(raw >= 1, raw, 0), want))

    xla_exact = bit_exact(F.raw_score_xla)
    tiles = [(16, 64)] if interpret else [(8, 64), (16, 64)]
    xla_det, xla_full = _programs(params, F.raw_score_xla)
    for tile in tiles:
        F.TRITON_TILE = tile
        fn = functools.partial(F.raw_score_triton, interpret=interpret)
        exact = bit_exact(fn)
        tri_det, tri_full = _programs(params, fn)
        res = {}
        for name, run in (("xla", xla_det), ("triton", tri_det),
                          ("triton", tri_det), ("xla", xla_det)):
            res.setdefault("detect_" + name, []).append(_time(run, data) / n * 1e3)
        for name, run in (("xla", xla_full), ("triton", tri_full),
                          ("triton", tri_full), ("xla", xla_full)):
            res.setdefault("frame_" + name, []).append(_time(run, data) / n * 1e3)
        print(json.dumps({
            "metric": "fast_raw_score_ab_ms_per_stereo_frame",
            "tile": list(tile), "triton_bit_exact": exact,
            "xla_bit_exact": xla_exact,
            **res, "frames_per_scan": n, "shape": [h, w],
            "features": params.n_features,
            "device": {"platform": dev.platform, "kind": dev.device_kind},
        }), flush=True)


if __name__ == "__main__":
    main()
