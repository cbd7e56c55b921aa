"""Slope-method per-stage breakdown of the stereo front-end on the real chip."""

import os
import sys
import time

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from orbslam3_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()
import jax.numpy as jnp
import numpy as np

from orbslam3_tpu.oracle.orb_cpu import PyramidParams, FAST_BORDER
from orbslam3_tpu.ops.pyramid import build_pyramid, gaussian_blur7_u8
from orbslam3_tpu.ops.fast import detect_two_threshold_multi
from orbslam3_tpu.ops.select import select_topk_grid
from orbslam3_tpu.ops.orientation import ic_angles
from orbslam3_tpu.ops.brief import brief_descriptors, brief_sampling_image
from orbslam3_tpu.ops.extractor import extract_features
from orbslam3_tpu.frontend.stereo_frame import extract_and_match_stereo

P = PyramidParams(n_features=1000)
rng = np.random.default_rng(0)
IMG = rng.integers(0, 256, (480, 752), np.uint8)
PAIR = jnp.asarray(np.stack([IMG, rng.integers(0, 256, (480, 752), np.uint8)]))


def slope(fn, n1=8, n2=40):
    def scan_n(n):
        @jax.jit
        def run(c0):
            def body(c, _):
                d = fn(c)
                return c + 0.0 * d, d

            _, outs = jax.lax.scan(body, c0, None, length=n)
            return outs.sum()

        return run

    r1, r2 = scan_n(n1), scan_n(n2)
    c0 = jnp.zeros((), jnp.float32)
    r1(c0).block_until_ready(); r2(c0).block_until_ready()
    t = []
    for r, n in ((r1, n1), (r2, n2)):
        best = 1e9
        for _ in range(3):
            s = time.perf_counter()
            r(c0).block_until_ready()
            best = min(best, time.perf_counter() - s)
        t.append(best)
    return (t[1] - t[0]) / (n2 - n1) * 1e3


def digest(tree):
    return sum(jnp.sum(x.astype(jnp.float32)) for x in jax.tree.leaves(tree))


def main():
    only = set(sys.argv[1:])  # stage names to run; empty = all
    print("backend:", jax.default_backend(), flush=True)
    img = jnp.asarray(IMG)

    def want(name):
        return not only or name in only

    def wiggle(c):  # defeat CSE across scan iterations
        return (c.astype(jnp.uint8) % 2)

    pyr = build_pyramid(img, P)
    b = FAST_BORDER
    crops = [l[b : l.shape[0] - b, b : l.shape[1] - b] for l in pyr]

    if want("pyramid"):
        print(f"pyramid : {slope(lambda c: digest(build_pyramid(img + wiggle(c), P))):.3f} ms", flush=True)
    if want("blur"):
        print(f"blur x8 : {slope(lambda c: digest([gaussian_blur7_u8(l + wiggle(c)) for l in pyr])):.3f} ms", flush=True)
    if want("fast"):
        print(f"fast    : {slope(lambda c: digest(detect_two_threshold_multi([cr + wiggle(c) for cr in crops], P.ini_th_fast, P.min_th_fast))):.3f} ms", flush=True)
    if want("fastraw"):
        from orbslam3_tpu.ops.fast import raw_score_map
        w_max = max(-(-cr.shape[1] // 32) * 32 for cr in crops)
        rows = []
        for crop in crops:
            ph = -(-crop.shape[0] // 32) * 32
            rows.append(jnp.zeros((ph, w_max), crop.dtype).at[: crop.shape[0], : crop.shape[1]].set(crop))
        comp = jnp.concatenate(rows, axis=0)
        print(f"  comp shape: {comp.shape}", flush=True)
        print(f"fastraw : {slope(lambda c: digest(raw_score_map(comp + wiggle(c)))):.3f} ms", flush=True)
        from orbslam3_tpu.ops.fast import nms3
        raw = raw_score_map(comp)
        print(f"fastnms : {slope(lambda c: digest(nms3(raw + wiggle(c).astype(raw.dtype)))):.3f} ms", flush=True)
    scores = detect_two_threshold_multi(crops, P.ini_th_fast, P.min_th_fast)
    quotas = [int(q) for q in P.features_per_level()]
    if want("select"):
        print(f"select  : {slope(lambda c: digest([select_topk_grid(s + wiggle(c).astype(s.dtype), q) for s, q in zip(scores, quotas)])):.3f} ms", flush=True)
    sels = [select_topk_grid(s, q) for s, q in zip(scores, quotas)]
    xys = [jnp.where(v[:, None], xy + b, b + 3) for (xy, _, v) in sels]
    if want("orient"):
        print(f"orient  : {slope(lambda c: digest([ic_angles(l + wiggle(c), xy) for l, xy in zip(pyr, xys)])):.3f} ms", flush=True)
    if want("brief"):
        angs = [ic_angles(l, xy) for l, xy in zip(pyr, xys)]
        samps = [brief_sampling_image(l, gaussian_blur7_u8(l)) for l in pyr]
        print(f"brief   : {slope(lambda c: digest([brief_descriptors(s + wiggle(c), xy.astype(jnp.float32), a) for s, xy, a in zip(samps, xys, angs)])):.3f} ms", flush=True)
    if want("mono"):
        print(f"mono    : {slope(lambda c: digest(extract_features(img + wiggle(c), P))):.3f} ms", flush=True)
    if want("stereo"):
        print(f"stereo  : {slope(lambda c: digest(extract_and_match_stereo(PAIR + wiggle(c), P)), n1=4, n2=24):.3f} ms", flush=True)
    if want("stereoparts"):
        from orbslam3_tpu.ops.extractor import detection_crops, extract_from_pyramid

        def upto(stage):
            def fn(c):
                pair = PAIR + wiggle(c)
                pyr_l = build_pyramid(pair[0], P)
                pyr_r = build_pyramid(pair[1], P)
                act_l, crops_l = detection_crops(pyr_l, P)
                act_r, crops_r = detection_crops(pyr_r, P)
                sl = detect_two_threshold_multi(crops_l + crops_r, P.ini_th_fast, P.min_th_fast)
                if stage == "detect":
                    return digest(sl)
                feats = [
                    extract_from_pyramid(pyr, P, dict(zip(act, s)))
                    for pyr, act, s in (
                        (pyr_l, act_l, sl[: len(act_l)]),
                        (pyr_r, act_r, sl[len(act_l):]),
                    )
                ]
                return digest(feats)
            return fn

        print(f"s:detect: {slope(upto('detect'), n1=4, n2=24):.3f} ms", flush=True)
        print(f"s:feats : {slope(upto('feats'), n1=4, n2=24):.3f} ms", flush=True)


if __name__ == "__main__":
    main()
