"""User-facing demo: ORB feature extraction on JAX's default backend.

Usage: python examples/demo_extract.py
"""
import time

import numpy as np
import jax

from orbslam3_tpu.oracle.orb_cpu import PyramidParams
from orbslam3_tpu.ops.extractor import (
    extract_features_jit,
    extract_features_stereo_jit,
    split_lapping,
)
from orbslam3_tpu.utils.compile_cache import setup_compile_cache


def make_frame(seed: int, h: int = 480, w: int = 752) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (120 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0) + rng.normal(0, 18, (h, w))).clip(0, 255)
    for _ in range(120):
        cx, cy = int(rng.integers(20, w - 20)), int(rng.integers(20, h - 20))
        r = int(rng.integers(3, 14))
        img[(xx - cx) ** 2 + (yy - cy) ** 2 < r * r] = int(rng.integers(0, 256))
    return img.astype(np.uint8)


def main():
    # first run pays the full compile; reruns hit the persistent cache
    setup_compile_cache()
    print("backend:", jax.default_backend(), "devices:", jax.devices())
    params = PyramidParams(n_features=1000)
    img = make_frame(0)

    t0 = time.perf_counter()
    feat = extract_features_jit(img, params)
    jax.block_until_ready(feat)
    t1 = time.perf_counter()
    print(f"mono: first call (compile+run) {t1 - t0:.2f}s")

    for _ in range(3):
        img2 = make_frame(1)
        t0 = time.perf_counter()
        feat = extract_features_jit(img2, params)
        jax.block_until_ready(feat)
        print(f"mono steady-state: {(time.perf_counter() - t0) * 1e3:.2f} ms")

    n_valid = int(np.asarray(feat.valid).sum())
    print(f"keypoints: {n_valid}/{feat.max_keypoints} valid")
    oct_counts = np.bincount(np.asarray(feat.octave)[np.asarray(feat.valid)], minlength=8)
    print("per-octave:", oct_counts.tolist())
    print("sample kp:", np.asarray(feat.xy)[np.asarray(feat.valid)][:3].tolist())
    print("sample desc bytes:", np.asarray(feat.desc)[np.asarray(feat.valid)][0][:8].tolist())

    # stereo batch of 2 + lapping split
    pair = np.stack([make_frame(2), make_frame(3)])
    t0 = time.perf_counter()
    sfeat = extract_features_stereo_jit(pair, params)
    jax.block_until_ready(sfeat)
    print(f"stereo pair (compile+run): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    sfeat = extract_features_stereo_jit(pair, params)
    jax.block_until_ready(sfeat)
    print(f"stereo steady-state: {(time.perf_counter() - t0) * 1e3:.2f} ms")
    left = {k: np.asarray(v)[0] for k, v in sfeat._asdict().items()}
    order, mono_idx = split_lapping(left, (100.0, 400.0))
    print(f"lapping split: {len(order)} valid, mono_index={mono_idx}")


if __name__ == "__main__":
    main()
