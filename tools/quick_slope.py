"""Headline + slope measurement only (stages A/B1 of bench.py), for A/B work."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402


def main():
    jax = bench._init_jax()
    from orbslam3_tpu.oracle.orb_cpu import PyramidParams

    params = PyramidParams(n_features=1000)
    n = 128
    t0 = time.perf_counter()
    run128, pairs128 = bench._build_run(jax, params, n)
    np.asarray(run128(pairs128))
    print(f"compile+warm n=128: {time.perf_counter() - t0:.1f}s", flush=True)
    w128 = min(bench._median_wall_ms(run128, pairs128, 3),
               bench._median_wall_ms(run128, pairs128, 3))
    run8, pairs8 = bench._build_run(jax, params, 8)
    np.asarray(run8(pairs8))
    w8 = bench._median_wall_ms(run8, pairs8, 3)
    print(f"headline {w128 / n:.3f} ms/frame   slope {(w128 - w8) / (n - 8):.3f} ms/frame", flush=True)


if __name__ == "__main__":
    main()
