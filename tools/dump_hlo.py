"""Dump the optimized HLO of the n=8 fused stereo program, print the
bodies of named ops (for attributing trace-op names to source), and list
the operand and result types of every matrix product and convolution.

Usage: python tools/dump_hlo.py [op_name_substring ...]
"""

import collections
import os
import re
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = (.*?) ([\w\-]+)\(([^)]*)\)(.*)$")
_DTYPE = re.compile(r"\b([a-z]+[0-9]*)\[[0-9,]*\]")
_PRODUCT_TARGETS = ("gemm", "matmul", "conv")


def dot_signatures(hlo_text: str) -> collections.Counter:
    """Counter of (op, operand dtypes, result dtype) over the matrix
    products and convolutions in optimized HLO text: `dot` and
    `convolution` instructions (also inside fusions) and custom calls to a
    GEMM or convolution library.  Operands printed without their shapes
    are resolved through the instruction that defines them."""
    parsed = []
    dtype_of = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            name, shape, op, operands, attrs = m.groups()
            t = _DTYPE.search(shape)
            dtype_of[name] = t.group(1) if t else "?"
            parsed.append((op, operands, attrs, dtype_of[name]))
    sigs: collections.Counter = collections.Counter()
    for op, operands, attrs, result in parsed:
        if op == "custom-call":
            target = re.search(r'custom_call_target="([^"]+)"', attrs)
            if not target or not any(
                k in target.group(1).lower() for k in _PRODUCT_TARGETS
            ):
                continue
            op = target.group(1)
        elif op not in ("dot", "convolution"):
            continue
        ins = tuple(_DTYPE.findall(operands)) or tuple(
            dtype_of.get(n, "?") for n in re.findall(r"%([\w.\-]+)", operands)
        )
        sigs[(op, ins, result)] += 1
    return sigs


def full_precision_products(sigs: collections.Counter) -> list:
    """The signatures a GPU may run in TF32: any convolution, and any
    product with a float32 or float64 operand."""
    return [
        s for s in sigs
        if "conv" in s[0].lower() or any(t in ("f32", "f64") for t in s[1])
    ]


def main():
    import jax

    from orbslam3_tpu.utils.compile_cache import setup_compile_cache
    from tools.trace_ops import build_run

    setup_compile_cache()
    names = sys.argv[1:] or ["select_reduce_fusion"]
    run, pairs = build_run()
    txt = jax.jit(run.__wrapped__).lower(pairs).compile().as_text()
    out = os.path.join(_REPO, ".traces", "hlo_n8.txt")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(txt)
    print(f"wrote {out} ({len(txt)} bytes)")
    lines = txt.splitlines()
    for pat in names:
        print(f"\n=== ops matching {pat!r} ===")
        for l in lines:
            if pat in l and ("= fusion" in l or "fusion(" in l or " = " in l):
                if f"%{pat}" in l or f" {pat}" in l or pat in l.split("=")[0]:
                    print(l[:400])
    sigs = dot_signatures(txt)
    print("\n=== matrix products: (op, operands, result): count ===")
    for sig, n in sorted(sigs.items()):
        print(f"  {sig}: {n}")
    print("full-precision products:", full_precision_products(sigs))


if __name__ == "__main__":
    main()
