"""The Triton FAST score kernel (ops.fast.raw_score_triton): parity with the
oracle in interpret mode, the choice of kernel by backend, and its lowering
for CUDA.  The compiled kernel runs on the card in `chip_smoke.py` phase b
and in the `gpu` test below."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam3_tpu.ops import fast as F
from orbslam3_tpu.oracle import orb_cpu as oc

triton_interpret = jax.jit(functools.partial(F.raw_score_triton, interpret=True))


def _assert_matches_oracle(raw, img):
    assert raw.shape == img.shape and raw.dtype == np.int32
    for th in (1, 7, 20):
        assert np.array_equal(np.where(raw >= th, raw, 0), oc.fast_score_map(img, th)), th


@pytest.mark.parametrize("shape", [(8, 64), (57, 57), (65, 130), (96, 746), (5, 300)])
def test_triton_score_matches_oracle_interpret(shape):
    """Tile multiples, ragged edges, and images thinner than the frame."""
    img = np.random.default_rng(shape[0]).integers(0, 256, shape, np.uint8)
    _assert_matches_oracle(np.asarray(triton_interpret(jnp.asarray(img))), img)


def _composite_crops(small_image):
    params = oc.PyramidParams(n_features=300)
    b = oc.FAST_BORDER
    crops = [l[b : l.shape[0] - b, b : l.shape[1] - b]
             for l in oc.build_pyramid(small_image, params)]
    return crops + [c[:, ::-1].copy() for c in crops]


def _detect(crops):
    return [np.asarray(m) for m in F.detect_two_threshold_multi(
        [jnp.asarray(c) for c in crops], 20, 7)]


@pytest.mark.parametrize("backend,kernel", [("gpu", "triton"), ("cpu", "xla")])
def test_backend_chooses_the_kernel(monkeypatch, small_image, backend, kernel):
    """On a GPU the composite detection scores with the Triton kernel (run
    here in interpret mode), elsewhere with XLA; the maps are the same."""
    calls = []

    def spy(name, fn):
        def wrapped(img):
            calls.append(name)
            return fn(img)
        return wrapped

    monkeypatch.setattr(F, "raw_score_triton", spy("triton", triton_interpret))
    monkeypatch.setattr(F, "raw_score_xla", spy("xla", F.raw_score_xla))
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    crops = _composite_crops(small_image)
    got = _detect(crops)
    assert calls == [kernel]  # one score pass over the whole composite
    monkeypatch.undo()
    for g, want in zip(got, _detect(crops)):
        assert np.array_equal(g, want)


def test_triton_kernel_inside_shard_map():
    """The frame-parallel fleet program runs the kernel on each device's
    shard under shard_map (__graft_entry__).  The Pallas interpreter's
    ref slicing does not pass shard_map's varying-axes check, so this
    parity run turns the check off; the compiled kernel keeps it on
    (next test)."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    imgs = jnp.asarray(np.random.default_rng(4).integers(0, 256, (4, 40, 70), np.uint8))
    per_device = jax.jit(jax.shard_map(
        lambda b: triton_interpret(b[0])[None], mesh=mesh,
        in_specs=P("data"), out_specs=P("data"), check_vma=False,
    ))
    got = np.asarray(per_device(imgs))
    for i in range(4):
        assert np.array_equal(got[i], np.asarray(F.raw_score_xla(imgs[i])))


def test_triton_kernel_output_varies_over_the_mesh_axis():
    """Under shard_map with the varying-axes check on, the compiled
    kernel's output varies over the data axis like the image it reads."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    per_device = jax.jit(jax.shard_map(
        lambda b: F.raw_score_triton(b[0])[None], mesh=mesh,
        in_specs=P("data"), out_specs=P("data"),
    ))
    exp = jax.export.export(
        per_device,
        platforms=["cuda"],
        disabled_checks=[
            jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(jax.ShapeDtypeStruct((4, 40, 70), jnp.uint8,
                           sharding=NamedSharding(mesh, P("data"))))
    assert "fast_raw_score" in exp.mlir_module()


def test_triton_kernel_lowers_for_cuda():
    """Pallas lowers the kernel to Triton IR without a GPU; the compiler
    on the card takes it from there."""
    exp = jax.export.export(
        jax.jit(F.raw_score_triton),
        platforms=["cuda"],
        disabled_checks=[
            jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(jax.ShapeDtypeStruct((480, 752), jnp.uint8))
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text and "fast_raw_score" in text


@pytest.mark.gpu
def test_triton_score_matches_oracle_on_gpu(gpu_backend):
    img = np.random.default_rng(1).integers(0, 256, (480, 752), np.uint8)
    _assert_matches_oracle(np.asarray(jax.jit(F.raw_score_triton)(jnp.asarray(img))), img)


@pytest.mark.gpu
def test_xla_roll_formulation_miscompiles_at_480x752_on_gpu(gpu_backend):
    """Pins the reason raw_score_map does not score with XLA on a GPU:
    XLA:GPU compiles raw_score_xla wrongly for a 480x752 image under jit,
    while op by op it is exact.  If this test fails, XLA now compiles it
    right, and the choice of kernel in raw_score_map is open again."""
    img = np.random.default_rng(0).integers(0, 256, (480, 752), np.uint8)
    want = oc.fast_score_map(img, 1)

    def n_wrong(raw):
        raw = np.asarray(raw)
        return int((np.where(raw >= 1, raw, 0) != want).sum())

    with jax.disable_jit():
        assert n_wrong(F.raw_score_xla(jnp.asarray(img))) == 0
    assert n_wrong(jax.jit(F.raw_score_xla)(jnp.asarray(img))) > 0
    assert n_wrong(F.raw_score_map(jnp.asarray(img))) == 0
