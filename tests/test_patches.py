"""One-hot window gathers (ops/patches.py) vs NumPy indexing, bit-exact."""

import numpy as np
import pytest
import jax.numpy as jnp

from orbslam3_tpu.oracle.orb_cpu import ic_moment_weights
from orbslam3_tpu.ops.patches import gather_windows, sample_windows, window_moments

H, W = 213, 331


def _img(seed):
    return np.random.default_rng(seed).integers(0, 256, (H, W), np.uint8)


@pytest.mark.parametrize("k,nr,nc", [(40, 11, 21), (7, 31, 31), (64, 37, 37), (1, 5, 5)])
def test_gather_windows_matches_slicing(k, nr, nc):
    rng = np.random.default_rng(11 + k)
    img = _img(11)
    row0 = rng.integers(0, H - nr + 1, k).astype(np.int32)
    col0 = rng.integers(0, W - nc + 1, k).astype(np.int32)
    got = np.asarray(gather_windows(jnp.asarray(img), jnp.asarray(row0),
                                    jnp.asarray(col0), nr, nc))
    assert got.shape == (k, nr, nc)
    want = np.stack([img[r : r + nr, c : c + nc] for r, c in zip(row0, col0)])
    assert np.array_equal(got.astype(np.int32), want)


def test_gather_windows_clamps_out_of_bounds():
    img = np.random.default_rng(3).integers(0, 256, (64, 160), np.uint8)
    row0 = np.array([-5, 60, 0], np.int32)   # clamped to [0, 64-11]
    col0 = np.array([200, -1, 3], np.int32)  # clamped to [0, 160-21]
    got = np.asarray(gather_windows(jnp.asarray(img), jnp.asarray(row0),
                                    jnp.asarray(col0), 11, 21))
    r = np.clip(row0, 0, 64 - 11)
    c = np.clip(col0, 0, 160 - 21)
    for i in range(3):
        assert np.array_equal(got[i].astype(np.int32), img[r[i] : r[i] + 11, c[i] : c[i] + 21])


@pytest.mark.parametrize("k,nr,nc,s", [(40, 37, 37, 512), (9, 11, 21, 128), (1, 37, 37, 256)])
def test_sample_windows_matches_indexing(k, nr, nc, s):
    rng = np.random.default_rng(7 + k)
    img = _img(7)
    row0 = rng.integers(0, H - nr + 1, k).astype(np.int32)
    col0 = rng.integers(0, W - nc + 1, k).astype(np.int32)
    ridx = rng.integers(0, nr, (k, s)).astype(np.int32)
    cidx = rng.integers(0, nc, (k, s)).astype(np.int32)
    got = np.asarray(sample_windows(
        jnp.asarray(img), jnp.asarray(row0), jnp.asarray(col0),
        jnp.asarray(ridx), jnp.asarray(cidx), nr, nc))
    want = img[row0[:, None] + ridx, col0[:, None] + cidx].astype(np.float32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [1, 9, 64])
def test_window_moments_match_weighted_sums(k):
    """IC moments: integer-valued f32 products < 2^12, sums < 2^24 -> exact."""
    w10, w01 = ic_moment_weights()
    nr, nc = w10.shape
    rng = np.random.default_rng(11 + k)
    img = _img(11)
    row0 = rng.integers(0, H - nr + 1, k).astype(np.int32)
    col0 = rng.integers(0, W - nc + 1, k).astype(np.int32)
    m10, m01 = window_moments(jnp.asarray(img), jnp.asarray(row0), jnp.asarray(col0),
                              w10.astype(np.float32), w01.astype(np.float32))
    pat = np.stack([img[r : r + nr, c : c + nc] for r, c in zip(row0, col0)]).astype(np.int64)
    assert np.array_equal(np.asarray(m10), (pat * w10).sum((1, 2)))
    assert np.array_equal(np.asarray(m01), (pat * w01).sum((1, 2)))
