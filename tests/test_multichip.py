"""Frame-parallel multichip sharding == single-device, bit-for-bit.

The multi-chip strategy (SURVEY §2d answer: frame-parallel data sharding
over a `jax.sharding.Mesh`, no hot-path collectives) must not change any
output.  Runs on the conftest-forced 8-device virtual CPU mesh; kernels are
integer/fixed-point so equality is exact.  `chip_smoke.py --multi 4` runs
the fleet program's gate on four GPUs.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from orbslam3_tpu.frontend.stereo_frame import extract_and_match_stereo
from orbslam3_tpu.oracle.orb_cpu import PyramidParams

PARAMS = PyramidParams(n_features=64)
H, W = 96, 128


def _pair(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = 120 + 50 * np.sin(xx / 9.0) * np.cos(yy / 7.0) + rng.normal(0, 15, (H, W))
    return np.stack([img.clip(0, 255), np.roll(img, 3, axis=1).clip(0, 255)]).astype(
        np.uint8
    )


@pytest.mark.slow  # ~2 min of CPU-backend compile for the vmapped program
def test_frame_parallel_sharding_bit_exact():
    n = 8
    if len(jax.devices()) < n:
        pytest.skip("virtual mesh unavailable")
    pairs = np.stack([_pair(i) for i in range(n)])
    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("data",))
    sharded = jax.device_put(pairs, NamedSharding(mesh, P("data")))

    @jax.jit
    def run(ps):
        return jax.vmap(
            lambda p: extract_and_match_stereo.__wrapped__(p, PARAMS)
        )(ps)

    out = run(sharded)
    # the frame axis really is sharded across all 8 devices
    assert len(out.left.desc.sharding.device_set) == n

    single = run(jax.device_put(pairs, jax.devices()[0]))
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(single)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow  # CPU-backend compile of the scan-batched program
def test_throughput_scan_batch_sharding_bit_exact():
    """The THROUGHPUT program (System.prefetch_stereo_batch's scan-batched
    dispatch — bench B6 / the multi-robot fleet) under shard_map: XLA
    cannot partition a lax.scan's iteration axis, so each device scans its
    LOCAL shard of the fleet batch.  Per-frame packed outputs must be
    bit-equal sharded vs unsharded (__graft_entry__.dryrun_multichip
    runs the same gate at production geometry)."""
    from orbslam3_tpu.frontend.stereo_frame import (
        extract_and_match_stereo_packed_batch,
    )

    n = 8
    if len(jax.devices()) < n:
        pytest.skip("virtual mesh unavailable")
    b_per = 2
    pairs = np.stack([_pair(100 + i) for i in range(n * b_per)])
    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("data",))

    def run(ps):
        return extract_and_match_stereo_packed_batch(ps, PARAMS)

    fleet = jax.jit(
        jax.shard_map(run, mesh=mesh, in_specs=P("data"), out_specs=P("data"))
    )
    out = np.asarray(fleet(jax.device_put(pairs, NamedSharding(mesh, P("data")))))
    single = np.asarray(run(jax.device_put(pairs, jax.devices()[0])))
    np.testing.assert_array_equal(out, single)
