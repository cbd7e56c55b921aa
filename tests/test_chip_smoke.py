"""chip_smoke.py: its refusal off the GPU, its HLO product check, and its
phases at reduced sizes on the CPU (the full sizes run on the card)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tools.dump_hlo import dot_signatures, full_precision_products  # noqa: E402


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_refuses_cpu_backend():
    proc = _run(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_fails_without_the_rest_of_the_repo(tmp_path, monkeypatch, capsys):
    """A lone copy of the script, past the backend check, refuses to run
    the package it finds elsewhere."""
    import importlib.util

    import jax

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    spec = importlib.util.spec_from_file_location(
        "lone_chip_smoke", tmp_path / "chip_smoke.py")
    lone = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lone)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert lone.main(["--multi", "4"]) != 0
    out = capsys.readouterr()
    assert "not the package beside this script" in out.err
    assert '"ok": true' not in out.out


HLO = """
%fused_computation (param_0: bf16[8,256], param_1: bf16[256,8]) -> f32[8,8] {
  %param_0 = bf16[8,256]{1,0} parameter(0)
  %param_1 = bf16[256,8]{1,0} parameter(1)
  ROOT %dot.1 = f32[8,8]{1,0} dot(%param_0, %param_1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
ENTRY %main {
  %a = f32[4,4]{1,0} parameter(0)
  %gemm = (f32[4,4]{1,0}, s8[64]{0}) custom-call(f32[4,4]{1,0} %a, f32[4,4]{1,0} %a), custom_call_target="__cublas$gemm"
  %c = f32[4,4]{1,0} custom-call(f32[4,4]{1,0} %a), custom_call_target="Sharding"
}
"""


def test_dot_signatures_resolve_operands_and_flag_f32():
    sigs = dot_signatures(HLO)
    assert sigs[("dot", ("bf16", "bf16"), "f32")] == 1
    assert sigs[("__cublas$gemm", ("f32", "f32"), "f32")] == 1
    assert len(sigs) == 2  # the Sharding custom call is not a product
    assert full_precision_products(sigs) == [("__cublas$gemm", ("f32", "f32"), "f32")]


def test_stage_parity_phase_small(small_image):
    res = chip_smoke.stage_parity(240, 320, 400, check_hlo=False)
    assert res["pyramid_blur_fast_nms_levels_bit_exact"] == 8
    assert res["stereo_matches"] > 20
    assert res["desc_exact_fraction"] >= 0.95


@pytest.mark.gpu
def test_stage_parity_phase_full_size_on_gpu(gpu_backend):
    res = chip_smoke.stage_parity()
    assert res["keypoints"] > 0.8 * chip_smoke.N_FEATURES
    assert res["matrix_products"]


def test_gather_parity_counts_every_window():
    assert chip_smoke.gather_parity(90, 130, 16) == 4 * 16
