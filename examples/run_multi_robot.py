"""Multi-robot SLAM: N independent System instances sharing ONE device.

A fleet of robots can share a single device: each step, every robot's stereo
pair joins one batched front-end dispatch (System.prefetch_stereo_batch —
one program + one packed (B, K, 40) fetch), and each robot's own System
consumes its row.  The reference is strictly single-session per process
(one Tracking thread, /root/reference/src/System.cc:197); this is a
capability beyond parity, built on the same public API.

Usage: python examples/run_multi_robot.py [n_robots] [n_frames]
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

from orbslam3_tpu.cameras.models import Pinhole
from orbslam3_tpu.oracle.orb_cpu import PyramidParams
from orbslam3_tpu.slam.system import System
from orbslam3_tpu.utils.synth import ate_rmse, stereo_sequence

FX, H, W = 350.0, 480, 752
FPS = 20.0


def main(n_robots=2, n_frames=60, n_features=1000, h=H, w=W):
    camera = Pinhole([FX, FX, w / 2, h / 2])
    mbf = FX * 0.12
    params = PyramidParams(n_features=n_features)
    # distinct worlds/trajectories per robot (different seeds)
    streams = [
        stereo_sequence(n_frames, camera, 0.12, h, w, seed=11 + 7 * r)
        for r in range(n_robots)
    ]
    systems = [
        System(camera, mbf, params, sequential=True, max_frames=6)
        for _ in range(n_robots)
    ]

    est = [[] for _ in range(n_robots)]
    gt = [[] for _ in range(n_robots)]
    t_frame = []
    for k in range(n_frames):
        t0 = time.perf_counter()
        pairs = [streams[r][k][:2] for r in range(n_robots)]
        # ONE device dispatch serves the whole fleet's frame k
        handles = systems[0].prefetch_stereo_batch(pairs)
        for r in range(n_robots):
            pose = systems[r].track_stereo_prefetched(handles[r], k / FPS)
            if pose is not None:
                est[r].append(pose)
                gt[r].append(streams[r][k][2])
        t_frame.append(time.perf_counter() - t0)

    med = float(np.median(t_frame) * 1e3)
    print(f"{n_robots} robots x {n_frames} frames; "
          f"median step {med:.1f} ms ({med / n_robots:.1f} ms/robot-frame)")
    for r in range(n_robots):
        n_tracked = len(est[r])
        ate = ate_rmse(est[r], gt[r]) if n_tracked > 5 else float("nan")
        stats = systems[r].map_stats()
        print(f"  robot {r}: tracked {n_tracked}/{n_frames}, "
              f"ATE {ate * 100:.2f} cm, KFs {stats['n_keyframes']}, "
              f"MPs {stats['n_map_points']}")
    for s in systems:
        s.shutdown()
    return systems, est, gt


if __name__ == "__main__":
    n_r = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    n_f = int(sys.argv[2]) if len(sys.argv) > 2 else 60
    main(n_r, n_f)
