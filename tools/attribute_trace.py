"""Attribute device-op trace time to source files/lines via HLO metadata.

Joins a tools/trace_ops.py trace with the optimized HLO's per-op
source_file metadata, printing device microseconds per source file (and
the top ops within each).  This is the noise-free way to A/B a structural
change: wall-clock jitters, but in-program op sums only change when the
program does.

Usage: python tools/attribute_trace.py  (captures trace + dumps HLO itself)
"""

import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def hlo_source_map(txt: str) -> dict:
    """op name -> (source_file, source_line) from optimized-HLO metadata."""
    out = {}
    for m in re.finditer(
        r"%([\w.\-]+) = [^\n]*?source_file=\"([^\"]+)\"(?:[^\n]*?source_line=(\d+))?",
        txt,
    ):
        out[m.group(1)] = (m.group(2), int(m.group(3) or 0))
    return out


def hlo_scope_map(txt: str) -> dict:
    """op name -> op_name metadata (the jit path with its named scopes)."""
    return {
        m.group(1): m.group(2)
        for m in re.finditer(r"%([\w.\-]+) = [^\n]*?op_name=\"([^\"]+)\"", txt)
    }


def main():
    from orbslam3_tpu.utils.compile_cache import setup_compile_cache
    from tools.trace_ops import build_run, capture, parse_xplane

    setup_compile_cache()
    run, pairs = build_run()
    log_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".traces", "attr_%d" % int(time.time()),
    )
    smap = hlo_source_map(capture(run, pairs, log_dir).as_text())
    rows, _busy, _window, path = parse_xplane(log_dir)

    n_frames = 8
    per_file: dict = {}
    per_op_file: dict = {}
    unattributed = 0.0
    for name, dur in rows.items():
        if name.startswith("jit_run") or name.startswith("while."):
            continue  # outer containers double-count their children
        key = smap.get(name)
        f = os.path.basename(key[0]) if key else None
        if f is None:
            unattributed += dur
            f = "<no-metadata>"
        per_file[f] = per_file.get(f, 0.0) + dur
        per_op_file.setdefault(f, []).append((dur, name, key[1] if key else 0))
    print(f"trace {path}")
    print(f"per-source-file device us (n={n_frames} frames; us/frame in parens):")
    for f, dur in sorted(per_file.items(), key=lambda kv: -kv[1]):
        print(f"  {f:28s} {dur:9.0f} us  ({dur/n_frames:7.1f}/frame)")
        for d, name, line in sorted(per_op_file[f], reverse=True)[:5]:
            print(f"      {d:8.1f}  {name[:60]}  :{line}")


if __name__ == "__main__":
    main()
