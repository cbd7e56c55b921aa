"""Long-sequence soak run: full SLAM on the accelerator at production geometry.

Renders an N-frame (default 400) looping sweep through the synthetic
textured world at EuRoC geometry (480x752, 8 levels, 1000 features),
drives the full System (threaded mapper + loop closing + vocabulary +
prefetch pipeline), and reports per-frame timing, tracked fraction, ATE,
and map health — scale evidence for the role the reference's committed
MH01 artifacts play (2250-frame run, 176 KFs; BASELINE.md).

Usage: python tools/soak.py [n_frames] [pipe_depth]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from orbslam3_tpu.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

from collections import deque  # noqa: E402

from orbslam3_tpu.cameras.models import Pinhole  # noqa: E402
from orbslam3_tpu.oracle.orb_cpu import PyramidParams  # noqa: E402
from orbslam3_tpu.slam.system import System  # noqa: E402
from orbslam3_tpu.utils.lie import SE3, so3_exp  # noqa: E402
from orbslam3_tpu.utils.synth import (  # noqa: E402
    ate_rmse,
    stereo_sequence,
)
from orbslam3_tpu.vocab.vocabulary import BinaryVocabulary  # noqa: E402


def main(
    n: int = 400, depth: int = 4, sequential: bool = False, fps: float = 0.0
) -> None:
    """fps > 0 paces playback at that camera rate, sleeping off any frame
    slack exactly like the reference's dataset drivers (stereo_euroc.cc
    main loop usleeps ttrack up to the inter-frame timestamp gap) — the
    mapper/loop threads get the slack the reference's design assumes.
    fps == 0 feeds flat out (a stress mode no camera produces)."""
    fx = 350.0
    h, w = 480, 752
    camera = Pinhole([fx, fx, w / 2, h / 2])
    baseline = 0.12
    mbf = fx * baseline

    def loop_pose(k: float) -> SE3:
        # two laps of a wide sweep with slow vertical bob: revisits the
        # start twice, exercising place recognition + covisibility reuse
        s = 2.0 * np.pi * k / (n / 2.0)
        t = np.array(
            [2.2 * np.sin(s), 0.05 * np.sin(0.37 * k), 0.35 * (1 - np.cos(s))]
        )
        yaw = -0.7 * np.sin(s)
        return SE3(so3_exp(np.array([0.0, yaw, 0.0])), t)

    t0 = time.time()
    frames = stereo_sequence(n, camera, baseline, h, w, seed=7, pose_fn=loop_pose)
    print(f"rendered {n} frames in {time.time()-t0:.1f}s", flush=True)

    sysm = System(camera, mbf, PyramidParams(n_features=1000), sequential=False)
    descs = [
        sysm._extract_stereo(frames[k][0], frames[k][1])["desc"]
        for k in range(0, n, max(n // 6, 1))
    ]
    voc = BinaryVocabulary.train(np.concatenate(descs), k=8, depth=3, seed=0)
    sysm.shutdown()
    sysm = System(
        camera, mbf, PyramidParams(n_features=1000),
        sequential=sequential, vocabulary=voc,
    )

    est, gt, times = [], [], []
    # per-frame forensics (VERDICT r4 weak #2): state + map identity every
    # frame, so dropped frames decompose into EPISODES with causes instead
    # of one aggregate count
    tracked = np.zeros(n, bool)
    states = []            # per-frame state names
    transitions = []       # (frame, old_state -> new_state, n_maps)
    last_state = None
    handles = deque(
        sysm.prefetch_stereo(frames[k][0], frames[k][1])
        for k in range(min(depth, n))
    )
    t_run = time.time()
    for kf in range(n):
        t1 = time.perf_counter()
        if kf + depth < n:
            handles.append(
                sysm.prefetch_stereo(frames[kf + depth][0], frames[kf + depth][1])
            )
        pose = sysm.track_stereo_prefetched(handles.popleft(), kf / 20.0)
        dt = (time.perf_counter() - t1) * 1e3
        if kf >= 10:
            times.append(dt)
        stname = sysm.get_tracking_state().name
        states.append(stname)
        if stname != last_state:
            transitions.append((kf, f"{last_state}->{stname}",
                                sysm.atlas.count_maps()))
            last_state = stname
        tracked[kf] = pose is not None
        if pose is not None:
            est.append(pose)
            gt.append(frames[kf][2])
        if fps > 0:
            slack = (kf + 1) / fps - (time.time() - t_run)
            if slack > 0:
                time.sleep(slack)
        if kf % 100 == 99:
            st = sysm.map_stats()
            print(
                f"frame {kf+1}: {stname} "
                f"KFs={st['n_keyframes']} MPs={st['n_map_points']} "
                f"maps={sysm.atlas.count_maps()} "
                f"median {np.median(times):.1f} ms",
                flush=True,
            )
    wall = time.time() - t_run
    sysm.shutdown()
    st = sysm.map_stats()
    rmse = ate_rmse(est, gt) if len(est) >= 2 else float("nan")
    # Post-hoc ATE over the REPLAYED trajectory (SaveTrajectory* semantics:
    # per-frame Tcr recomposed against final optimized KF poses, biggest
    # map).  The live per-frame log above keeps whatever coordinate frame
    # each pose was emitted in — a LOST->fork segment later welded back by
    # a map merge stays in the pre-merge frame there and poisons the
    # single-alignment ATE; the replay re-expresses it.
    traj = sysm.frame_trajectory(map_filter="biggest")
    gt_by_ts = {round(k / 20.0, 6): frames[k][2] for k in range(n)}
    est_r, gt_r = [], []
    for ts, twc in traj:
        g = gt_by_ts.get(round(ts, 6))
        if g is not None:
            est_r.append(twc.inverse())
            gt_r.append(g)
    rmse_replay = ate_rmse(est_r, gt_r) if len(est_r) >= 2 else float("nan")
    lm = sysm.local_mapper
    print(
        f"SOAK n={n} depth={depth}: tracked {int(tracked.sum())}/{n}, "
        f"ATE {rmse*1000:.2f} mm (replayed {rmse_replay*1000:.2f} mm over "
        f"{len(est_r)} frames), KFs={st['n_keyframes']} "
        f"MPs={st['n_map_points']}, maps={sysm.atlas.count_maps()}, "
        f"median {np.median(times):.2f} ms/frame, "
        f"p95 {np.percentile(times, 95):.1f} ms, wall {wall:.1f}s "
        f"({n/wall:.1f} fps), "
        f"LBA exec/abort {lm.n_lba_exec}/{lm.n_lba_abort}",
        flush=True,
    )
    import json

    print(json.dumps({
        "metric": "soak",
        "n_frames": n,
        "mode": "sequential" if sequential else "threaded",
        "fps_paced": fps,
        "tracked": int(tracked.sum()),
        "ate_mm": round(rmse * 1000, 3),
        "ate_replay_mm": round(rmse_replay * 1000, 3),
        "replay_frames": len(est_r),
        "n_keyframes": st["n_keyframes"],
        "n_maps": sysm.atlas.count_maps(),
        "median_ms": round(float(np.median(times)), 2),
        "p95_ms": round(float(np.percentile(times, 95)), 1),
        "lba_exec": lm.n_lba_exec,
        "lba_abort": lm.n_lba_abort,
    }), flush=True)
    # --- dropout episode report -----------------------------------------
    print("state transitions:", flush=True)
    for f0, tr, nm in transitions:
        print(f"  frame {f0:4d}: {tr} (maps={nm})", flush=True)
    drop = ~tracked
    edges = np.nonzero(np.diff(np.r_[0, drop.view(np.int8), 0]))[0]
    episodes = list(zip(edges[::2], edges[1::2]))  # [start, end) untracked
    print(f"dropout episodes: {len(episodes)}", flush=True)
    for a, b in episodes:
        span_states = sorted(set(states[a:b]))
        print(
            f"  frames {a}-{b-1} ({b-a} frames): states {span_states}",
            flush=True,
        )


if __name__ == "__main__":
    fps = 0.0
    for a in sys.argv:
        if a.startswith("--fps="):
            fps = float(a.split("=", 1)[1])
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 400,
        int(sys.argv[2]) if len(sys.argv) > 2 else 4,
        sequential="--sequential" in sys.argv,
        fps=fps,
    )
