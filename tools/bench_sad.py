"""A/B micro-benchmark of stereo SAD-refinement formulations on the chip."""

import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from orbslam3_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()
import jax.numpy as jnp
import numpy as np

K, WL, WW, S = 1000, 11, 21, 11

rng = np.random.default_rng(0)
PL = jnp.asarray(rng.integers(0, 256, (K, WL, WL)).astype(np.float32))
PR = jnp.asarray(rng.integers(0, 256, (K, WL, WW)).astype(np.float32))


def slope(fn, n1=64, n2=1024):
    def scan_n(n):
        @jax.jit
        def run(c0):
            def body(c, _):
                d = fn(PL + c, PR + c)
                return c + 0.0 * d.sum(), d

            _, outs = jax.lax.scan(body, c0, None, length=n)
            return outs.sum()

        return run

    r1, r2 = scan_n(n1), scan_n(n2)
    c0 = jnp.zeros((), jnp.float32)
    r1(c0).block_until_ready(); r2(c0).block_until_ready()
    t = []
    for r in (r1, r2):
        best = 1e9
        for _ in range(5):
            s = time.perf_counter()
            r(c0).block_until_ready()
            best = min(best, time.perf_counter() - s)
        t.append(best)
    return (t[1] - t[0]) / (n2 - n1) * 1e3


def v0_slices(pl, pr):
    """Original: transposed layout, 11 view-slices, per-slice (0,1) reduce."""
    pl_t = jnp.transpose(pl, (2, 1, 0))
    pr_t = jnp.transpose(pr, (2, 1, 0))
    return jnp.stack(
        [
            jnp.abs(pl_t - jax.lax.slice_in_dim(pr_t, j, j + WL, axis=0)).sum(axis=(0, 1))
            for j in range(S)
        ],
        axis=1,
    )


def v1_reshape(pl, pr):
    """Current: merged (121,K) layout, 11 slice+reshape copies."""
    pl_t = jnp.transpose(pl, (2, 1, 0))
    pr_t = jnp.transpose(pr, (2, 1, 0))
    pl2 = pl_t.reshape(WL * WL, K)
    slides = jnp.stack(
        [jax.lax.slice_in_dim(pr_t, j, j + WL, axis=0).reshape(WL * WL, K) for j in range(S)]
    )
    return jnp.abs(pl2[None] - slides).sum(axis=1).T


def v2_4d(pl, pr):
    """4D stack of free views, one (1,2)-axis reduce."""
    pl_t = jnp.transpose(pl, (2, 1, 0))
    pr_t = jnp.transpose(pr, (2, 1, 0))
    slides = jnp.stack(
        [jax.lax.slice_in_dim(pr_t, j, j + WL, axis=0) for j in range(S)]
    )  # (11, 11, 11, K)
    return jnp.abs(pl_t[None] - slides).sum(axis=(1, 2)).T


def v3_merged_slices(pl, pr):
    """One (231,K) reshape of pr, sublane-slice views per slide."""
    pl_t = jnp.transpose(pl, (2, 1, 0))
    pr2 = jnp.transpose(pr, (2, 1, 0)).reshape(WW * WL, K)
    pl2 = pl_t.reshape(WL * WL, K)
    slides = jnp.stack(
        [jax.lax.slice_in_dim(pr2, j * WL, j * WL + WL * WL, axis=0) for j in range(S)]
    )
    return jnp.abs(pl2[None] - slides).sum(axis=1).T


def v4_matmul(pl, pr):
    """abs-diff fused into a ones-contraction over the 121 window px."""
    pl_t = jnp.transpose(pl, (2, 1, 0))
    pr2 = jnp.transpose(pr, (2, 1, 0)).reshape(WW * WL, K)
    pl2 = pl_t.reshape(WL * WL, K)
    slides = jnp.stack(
        [jax.lax.slice_in_dim(pr2, j * WL, j * WL + WL * WL, axis=0) for j in range(S)]
    )  # (11, 121, K)
    a = jnp.abs(pl2[None] - slides)
    ones = jnp.ones((WL * WL,), jnp.float32)
    return jnp.einsum("jqk,q->jk", a, ones, preferred_element_type=jnp.float32).T


def v5_noT(pl, pr):
    """No transpose: (K,11,11) layout, lane slices of pr."""
    dists = jnp.stack(
        [jnp.abs(pl - jax.lax.slice_in_dim(pr, j, j + WL, axis=2)).sum(axis=(1, 2)) for j in range(S)],
        axis=1,
    )
    return dists


VARS = dict(v0=v0_slices, v1=v1_reshape, v2=v2_4d, v3=v3_merged_slices, v4=v4_matmul, v5=v5_noT)


def main():
    names = sys.argv[1:] or list(VARS)
    ref = np.asarray(v0_slices(PL, PR))
    print("backend:", jax.default_backend())
    for name in names:
        fn = VARS[name]
        got = np.asarray(fn(PL, PR))
        ok = np.array_equal(got, ref)
        ms = slope(fn)
        print(f"{name}: {ms*1e3:7.1f} us/frame  exact={ok}", flush=True)


if __name__ == "__main__":
    main()
