"""The synthetic world is the same with and without OpenCV."""

import numpy as np
import pytest

from orbslam3_tpu.utils.synth import _smooth_noise, fill_polygon, make_texture


def _cv2_texture(cv2, size, seed):
    """make_texture's polygons drawn by cv2.fillPoly (the reference)."""
    rng = np.random.default_rng(seed)
    img = (
        120
        + 55 * _smooth_noise(size, 48, rng)
        + 30 * _smooth_noise(size, 192, rng)
        + rng.normal(0, 8, (size, size))
    )
    img8 = np.clip(img, 0, 255).astype(np.uint8)
    for _ in range(size):
        cx, cy = rng.integers(12, size - 12, 2)
        n_v = int(rng.integers(3, 7))
        radius = rng.uniform(2.5, 11.0)
        angs = np.sort(rng.uniform(0, 2 * np.pi, n_v))
        pts = np.stack(
            [cx + radius * np.cos(angs), cy + radius * rng.uniform(0.4, 1.6) * np.sin(angs)],
            axis=1,
        ).astype(np.int32)
        cv2.fillPoly(img8, [pts], int(rng.integers(0, 256)))
    return img8


@pytest.mark.parametrize("size,seed", [(512, 0), (512, 12), (1024, 1), (256, 7)])
def test_texture_matches_cv2_fillpoly(size, seed):
    cv2 = pytest.importorskip("cv2")
    assert np.array_equal(make_texture(size, seed), _cv2_texture(cv2, size, seed))


def test_fill_polygon_clips_like_cv2():
    """make_texture's polygons keep 12 px from the left and right edges but
    may reach past the top and bottom ones; drawn into a small image."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    crossing = 0
    for _ in range(300):
        cx, cy = int(rng.integers(12, 36)), int(rng.integers(-6, 46))
        n_v = int(rng.integers(3, 7))
        r = rng.uniform(2.5, 11.0)
        angs = np.sort(rng.uniform(0, 2 * np.pi, n_v))
        pts = np.stack(
            [cx + r * np.cos(angs), cy + r * rng.uniform(0.4, 1.6) * np.sin(angs)], 1
        ).astype(np.int32)
        crossing += bool((pts[:, 1] < 0).any() or (pts[:, 1] >= 40).any())
        a = np.zeros((40, 48), np.uint8)
        b = a.copy()
        cv2.fillPoly(a, [pts], 200)
        fill_polygon(b, pts, 200)
        assert np.array_equal(a, b), pts.tolist()
    assert crossing > 50  # the clipped case is exercised
