"""Op-level device-time breakdown of the fused stereo program.

Captures a jax.profiler trace of the n=8 scan, reads the .xplane.pb with
jax.profiler.ProfileData, and prints per-op and per-category device time so
the "XLA glue" (elementwise fusions, data movement) budget is attributable
to specific HLOs instead of a single bucket.

Device events are taken from the GPU planes ("/device:GPU:N").  Each kernel
event carries the HLO op that launched it (`hlo_op` stat), which joins the
trace to the compiled HLO's metadata (tools/attribute_trace.py).

Usage: python tools/trace_ops.py [top_n]
"""

import glob
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def build_run(n=8):
    from orbslam3_tpu.frontend import stereo_frame as sf
    from orbslam3_tpu.oracle.orb_cpu import PyramidParams

    from bench import make_frame

    params = PyramidParams(n_features=1000)
    pairs = jax.device_put(
        np.stack([np.stack([make_frame(2 * i), make_frame(2 * i + 1)]) for i in range(n)])
    )

    @jax.jit
    def run(ps):
        out = sf.extract_and_match_stereo_sequence.__wrapped__(
            ps, params, sf.DEFAULT_MBF, sf.DEFAULT_FX
        )
        acc = jnp.float32(0)
        for leaf in jax.tree.leaves(out):
            acc = acc + leaf.astype(jnp.float32).sum()
        return acc

    return run, pairs


# XLA:GPU replays a program's kernels as CUDA graphs ("command buffers"),
# which the profiler shows as one opaque event; a per-op trace compiles the
# program without them.
TRACE_COMPILER_OPTIONS = {"xla_gpu_enable_command_buffer": ""}


def capture(run, pairs, log_dir):
    """Trace one call of jitted `run` on `pairs` into `log_dir`; returns
    the executable traced, whose as_text() names the traced ops."""
    exe = run.lower(pairs).compile(compiler_options=TRACE_COMPILER_OPTIONS)
    np.asarray(exe(pairs))  # warm
    jax.profiler.start_trace(log_dir)
    np.asarray(exe(pairs))
    jax.profiler.stop_trace()
    return exe


def _device_lines(plane):
    """The lines of a GPU plane that hold one event per kernel: the derived
    "XLA Ops" line when the trace has one, else the per-stream lines."""
    lines = list(plane.lines)
    ops = [l for l in lines if l.name == "XLA Ops"]
    return ops or [l for l in lines if l.name.startswith("Stream")]


def parse_xplane(log_dir):
    """Device-op durations from the newest .xplane.pb under `log_dir`.

    Returns (rows, busy_us, window_us, path): rows maps each HLO op name to
    its summed device microseconds; busy_us is the union of the kernel
    intervals and window_us the span from the first kernel start to the
    last kernel end, so 1 - busy/window is the device idle share inside
    the traced window.  Raises if the trace holds no GPU kernel event."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    path = max(paths, key=os.path.getmtime)
    data = jax.profiler.ProfileData.from_file(path)
    rows: dict = {}
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in _device_lines(plane):
            for ev in line.events:
                if ev.duration_ns <= 0:
                    continue
                name = dict(ev.stats).get("hlo_op") or ev.name
                rows[name] = rows.get(name, 0.0) + ev.duration_ns / 1e3
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        layout = {pl.name: sorted({l.name for l in pl.lines})[:12] for pl in data.planes}
        raise RuntimeError(f"no GPU kernel events in {path}; planes: {layout}")
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    return rows, busy / 1e3, window / 1e3, path


CATS = (
    ("matmul", ("dot", "conv", "einsum", "gemm", "cublas")),
    ("datamove", ("copy", "transpose", "concatenate", "pad", "slice", "reshape", "bitcast", "dynamic-update")),
    ("reduce", ("reduce", "sort", "top-k", "topk", "scan", "cumsum", "select-and-scatter")),
    ("elementwise", ("fusion", "add", "multiply", "subtract", "compare", "select", "convert", "iota", "broadcast")),
)


def categorize(name):
    low = name.lower()
    for cat, keys in CATS:
        if any(k in low for k in keys):
            return cat
    return "other"


def main():
    from orbslam3_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    top_n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    log_dir = os.path.join(_REPO, ".traces", "trace_ops_%d" % int(time.time()))
    run, pairs = build_run()
    print("backend:", jax.default_backend(), flush=True)
    capture(run, pairs, log_dir)
    rows, busy, window, path = parse_xplane(log_dir)
    total = sum(rows.values())
    print(f"trace: {path}\ntotal device-op us: {total:.0f}  busy {busy:.0f} of {window:.0f} us")
    cats = {}
    for name, dur in rows.items():
        cats[categorize(name)] = cats.get(categorize(name), 0.0) + dur
    for cat, dur in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:16s} {dur:10.0f} us  {100*dur/max(total,1):5.1f}%")
    print(f"\ntop {top_n} ops:")
    for name, dur in sorted(rows.items(), key=lambda kv: -kv[1])[:top_n]:
        print(f"  {dur:9.1f} us  {name[:130]}")


if __name__ == "__main__":
    main()
