"""Contract tests for bench.py: the data-sheet peak table, the analytic FLOP
counts, and the CPU rehearsal of every measured path (one JSON line that
names the CPU and carries no device metric)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def test_peak_tflops_table():
    """device_kind -> the H100 SXM data-sheet row (dense, no sparsity)."""
    from bench import peak

    row = peak("NVIDIA H100 80GB HBM3")
    assert row == {"bf16_tflops": 989.0, "int8_tops": 1979.0, "hbm_tb_s": 3.35}


@pytest.mark.parametrize(
    "kind", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "cpu", "Quantum Chip 9000"]
)
def test_peak_table_rejects_unknown_device(kind):
    """A device the table does not list is an error, never a guessed peak
    (the PCIe H100 has other rates than the SXM part)."""
    from bench import peak

    with pytest.raises(ValueError, match="no data-sheet peaks"):
        peak(kind)


def test_analytic_flops_key_fold_discount():
    """The key-folded last layer must be counted as LN1 + a 768->128 matmul,
    not a full transformer layer (an 8.2% utilisation inflation otherwise)."""
    from bench import _analytic_backbone_flops_per_img

    from ucod_dpl_tpu.models.dino import DinoConfig

    cfg = DinoConfig.dinov2_base()
    n = (518 // cfg.patch_size) ** 2 + 1
    d = cfg.hidden_size
    full = _analytic_backbone_flops_per_img(cfg, 518)
    folded = _analytic_backbone_flops_per_img(cfg, 518, key_fold_dim=128)
    per_layer = 24 * n * d * d + 4 * n * n * d
    assert abs((full - folded) - (per_layer - 2 * n * d * 128)) < 1.0
    # magnitude sanity: ViT-B@518 is ~0.3 TFLOP/img
    assert 2.5e11 < folded < full < 3.5e11


def test_bench_refuses_cpu_without_rehearsal_flag():
    """No silent CPU fallback: without a GPU bench.py exits non-zero and
    prints no measurement line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert r.returncode != 0
    assert not [l for l in r.stdout.splitlines() if l.startswith("{")]


@pytest.mark.heavy  # subprocess e2e (~1-2 min on this host)
def test_bench_json_contract_tiny_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), "--cpu-rehearsal"],
        capture_output=True, text=True, timeout=1200, env=env,
    )
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    lines = [l for l in r.stdout.strip().splitlines() if l.startswith("{")]
    assert len(lines) == 1, r.stdout  # ONE JSON line
    d = json.loads(lines[0])
    assert d["device"]["platform"] == "cpu"
    # a rehearsal reports no device metric: no value, no utilisation, no peak
    assert d["value"] is None and "peaks" not in d and "mfu_vs_bf16_peak" not in d
    from bench import EXTRA_NAMES

    assert [m["metric"] for m in d["metrics"]] == list(EXTRA_NAMES)
    assert all(m["value"] is None for m in d["metrics"])
