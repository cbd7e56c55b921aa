"""Composite FAST detection (all levels, both cameras, one pass) vs the
oracle's per-level two-threshold detector, bit-exact.

The composite packs crops onto TILE-aligned shelves, zeroes each crop's
3-px ring frame, scores once, applies the per-tile two-threshold retry and
a strict 3x3 NMS.  Every crop's slice of the result must equal the map the
oracle builds for that crop alone.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from orbslam3_tpu.ops import fast as F
from orbslam3_tpu.oracle import orb_cpu as oc


def _oracle_map(crop, ini_th, min_th):
    out = np.zeros(crop.shape, np.int32)
    for x, y, s in oc.fast_keypoints_two_threshold(crop, ini_th, min_th):
        out[int(y), int(x)] = int(s)
    return out


def _random_crops(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, s, np.uint8) for s in shapes]


def _retry_crop():
    # flat image with a few weak corners: ini_th finds nothing in most
    # tiles, so the min_th retry decides the output
    rng = np.random.default_rng(17)
    crop = np.full((64, 256), 120, np.uint8)
    crop[8, 8] = 140    # weak corner: passes min_th only
    crop[40, 200] = 250  # strong corner: flips its tile to hi
    return [crop + rng.integers(0, 3, crop.shape).astype(np.uint8)]


def _pyramid_crops(small_image):
    params = oc.PyramidParams(n_features=300)
    b = oc.FAST_BORDER
    return [l[b : l.shape[0] - b, b : l.shape[1] - b]
            for l in oc.build_pyramid(small_image, params)]


CASES = {
    "single_level": lambda img: _random_crops(7, [(96, 160)]),
    "single_strip": lambda img: _random_crops(11, [(32, 128)]),
    "multi_level_shelves": lambda img: _random_crops(13, [(96, 224), (64, 96), (32, 64)]),
    "levels_descending": lambda img: _random_crops(19, [(96, 160), (72, 120), (48, 80)]),
    "retry_tiles": lambda img: _retry_crop(),
    "odd_65x130": lambda img: _random_crops(5, [(65, 130)]),
    "odd_96x746": lambda img: _random_crops(5, [(96, 746)]),
    "odd_57x57": lambda img: _random_crops(5, [(57, 57)]),
    "pyramid_levels": _pyramid_crops,
    "stereo_pair_levels": lambda img: _pyramid_crops(img) + _pyramid_crops(img[:, ::-1].copy()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_composite_detection_matches_oracle(case, small_image):
    crops = CASES[case](small_image)
    ini_th, min_th = (60, 7) if case == "retry_tiles" else (20, 7)
    got = F.detect_two_threshold_multi([jnp.asarray(c) for c in crops], ini_th, min_th)
    for i, (g, crop) in enumerate(zip(got, crops)):
        want = _oracle_map(crop, ini_th, min_th)
        g = np.asarray(g)
        assert g.shape == want.shape
        assert np.array_equal(g, want), (i, np.argwhere(g != want)[:5])


@pytest.mark.parametrize("shape", [(65, 130), (96, 746), (57, 57)])
def test_raw_score_matches_oracle_odd_sizes(shape):
    """raw_score_map thresholded == the oracle's score map, any threshold."""
    img = np.random.default_rng(5).integers(0, 255, shape, np.uint8)
    raw = np.asarray(F.raw_score_map(jnp.asarray(img)))
    for th in (1, 7, 20):
        assert np.array_equal(np.where(raw >= th, raw, 0), oc.fast_score_map(img, th))
