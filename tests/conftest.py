"""Test configuration: a virtual 8-device CPU mesh and the compile cache.

Run the tests on the CPU with JAX_PLATFORMS=cpu.  Multi-device sharding
tests run on the virtual mesh; tests marked `gpu` skip unless JAX's
default backend is a GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest

from orbslam3_tpu.utils.compile_cache import DEFAULT_DIR, setup_compile_cache

# CPU-backend XLA compiles dominate the fast tier's wall clock; the
# persistent cache (keyed by HLO hash) cuts repeat runs to the test logic
setup_compile_cache()


@pytest.fixture
def gpu_backend():
    """Skip unless JAX runs on a GPU (decided at run time, never at import,
    so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend; `python chip_smoke.py` covers it")


@pytest.fixture(scope="session", autouse=True)
def _extraction_memo():
    """On-disk memo for device feature extraction during tests.

    The e2e tiers drive hundreds of DETERMINISTIC synthetic frames through
    the fused extractor; on the CPU backend each dispatch costs ~0.5-1.5 s,
    which dominates the slow tier's wall clock.  Inputs are bit-identical
    across runs, so outputs are too (integer/fixed-point kernels) — memoize
    them keyed by input-bytes + params.  Extraction correctness itself is
    covered by the extractor/FAST/BRIEF/pyramid test files, which call the
    ops directly and never hit this cache.  Set ORBSLAM3_TPU_NO_EXTRACT_CACHE=1
    to disable (e.g. when changing the device pipeline).
    """
    if os.environ.get("ORBSLAM3_TPU_NO_EXTRACT_CACHE"):
        yield
        return
    import hashlib
    import pickle
    import tempfile

    from orbslam3_tpu.frontend import stereo_frame as sf_mod
    from orbslam3_tpu.ops import extractor as ex_mod

    cache_dir = os.path.join(DEFAULT_DIR, "test_features")
    os.makedirs(cache_dir, exist_ok=True)

    # a pipeline-code digest in every key: editing the device pipeline
    # invalidates the memo, so cached outputs can never mask a regression
    pkg = os.path.dirname(os.path.dirname(ex_mod.__file__))
    code_h = hashlib.sha1()
    for sub in ("ops", "frontend"):
        d = os.path.join(pkg, sub)
        for name in sorted(os.listdir(d)):
            if name.endswith(".py"):
                with open(os.path.join(d, name), "rb") as f:
                    code_h.update(f.read())
    code_digest = code_h.hexdigest()

    def _memo(tag, fn, key_parts):
        h = hashlib.sha1(tag.encode())
        h.update(code_digest.encode())
        for part in key_parts:
            if isinstance(part, np.ndarray):
                h.update(np.ascontiguousarray(part).tobytes())
                h.update(str(part.shape).encode())
                h.update(str(part.dtype).encode())
            else:
                h.update(repr(part).encode())
        path = os.path.join(cache_dir, h.hexdigest() + ".pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        out = fn()
        out = jax.tree.map(np.asarray, out)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, path)  # atomic for concurrent runs
        return out

    orig_stereo = sf_mod.extract_and_match_stereo
    orig_packed = sf_mod.extract_and_match_stereo_packed
    orig_mono = ex_mod.extract_features_jit

    def stereo_memo(pair, params, mbf=sf_mod.DEFAULT_MBF, fx=sf_mod.DEFAULT_FX):
        pair = np.asarray(pair)
        return _memo("stereo", lambda: orig_stereo(pair, params, mbf, fx),
                     [pair, params, float(mbf), float(fx)])

    def packed_memo(pair, params, mbf=sf_mod.DEFAULT_MBF, fx=sf_mod.DEFAULT_FX):
        pair = np.asarray(pair)
        return _memo("packed", lambda: orig_packed(pair, params, mbf, fx),
                     [pair, params, float(mbf), float(fx)])

    def mono_memo(img, params):
        img = np.asarray(img)
        return _memo("mono", lambda: orig_mono(img, params), [img, params])

    sf_mod.extract_and_match_stereo = stereo_memo
    sf_mod.extract_and_match_stereo_packed = packed_memo
    ex_mod.extract_features_jit = mono_memo
    try:
        yield
    finally:
        sf_mod.extract_and_match_stereo = orig_stereo
        sf_mod.extract_and_match_stereo_packed = orig_packed
        ex_mod.extract_features_jit = orig_mono


@pytest.fixture(scope="session")
def test_image():
    """Deterministic structured synthetic frame (EuRoC-like 752x480)."""
    rng = np.random.default_rng(7)
    h, w = 480, 752
    yy, xx = np.mgrid[0:h, 0:w]
    img = (
        120
        + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
        + rng.normal(0, 18, (h, w))
    ).clip(0, 255)
    for _ in range(80):
        cx = int(rng.integers(20, w - 20))
        cy = int(rng.integers(20, h - 20))
        r = int(rng.integers(3, 14))
        m = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        img[m] = int(rng.integers(0, 256))
    return img.astype(np.uint8)


@pytest.fixture(scope="session")
def small_image():
    rng = np.random.default_rng(3)
    h, w = 240, 320
    yy, xx = np.mgrid[0:h, 0:w]
    img = (128 + 80 * np.sin(xx / 13.0) * np.sin(yy / 17.0) + rng.normal(0, 12, (h, w))).clip(0, 255)
    return img.astype(np.uint8)
