"""Plumbing test for scripts/parity.py: synthetic data + the SHIPPED
reference decoder checkpoint + random backbone.  Verifies the runner
produces a structured report with published-vs-ours deltas and a failing
exit code when numbers (obviously) don't match.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from conftest import reference_available

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = "/root/reference/weights/UCOD_DPL_dinov2.safetensors"

pytestmark = [
    pytest.mark.heavy,  # subprocess e2e: excluded from the quick loop
    pytest.mark.skipif(
        not (reference_available() and os.path.exists(SHIPPED)),
        reason="shipped reference checkpoint not available",
    ),
]


def _synth(root, dataset="CHAMELEON", n=2):
    im = os.path.join(root, dataset, "im")
    gt = os.path.join(root, dataset, "gt")
    os.makedirs(im)
    os.makedirs(gt)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.random((64, 80, 3)) * 255).astype(np.uint8)).save(
            os.path.join(im, f"x{i}.jpg")
        )
        m = np.zeros((64, 80), np.uint8)
        m[20:40, 20:50] = 255
        Image.fromarray(m).save(os.path.join(gt, f"x{i}.png"))


def test_parity_runner_plumbing(tmp_path):
    _synth(str(tmp_path / "RefCOD"))
    report_path = str(tmp_path / "report.json")
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [
            sys.executable, os.path.join(REPO, "scripts", "parity.py"),
            "--data-dir", str(tmp_path / "RefCOD"),
            "--cache-dir", str(tmp_path / "cache"),
            "--work-dir", str(tmp_path / "work"),
            "--decoder-v2", SHIPPED,
            "--datasets", "CHAMELEON",
            "--allow-random-backbone",
            "--report", report_path,
            # shrink the backbone so the CPU run stays fast
        ],
        capture_output=True, text=True, timeout=900, env=env,
    )
    assert os.path.exists(report_path), r.stdout[-2000:] + r.stderr[-2000:]
    report = json.load(open(report_path))
    assert len(report) == 1
    row = report[0]
    assert row["stage"] == "UCOD-DPL" and row["dataset"] == "CHAMELEON"
    assert set(row["ours"]) == {"SMeasure", "WFM", "F_MEAN", "E_MEAN", "MAE"}
    assert row["published"]["SMeasure"] == 0.864
    assert "delta" in row and row["pass"] in (True, False)
    # random backbone cannot reproduce the published table
    assert r.returncode == (0 if row["pass"] else 1)


def test_parity_runner_strict_refuses_random(tmp_path):
    """Without --allow-random-backbone, missing weights must abort loudly —
    now at the asset-validation gate, before any eval compute is spent
    (strict in-extractor loading itself is pinned by test_serving.py)."""
    _synth(str(tmp_path / "RefCOD"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [
            sys.executable, os.path.join(REPO, "scripts", "parity.py"),
            "--data-dir", str(tmp_path / "RefCOD"),
            "--cache-dir", str(tmp_path / "cache2"),
            "--work-dir", str(tmp_path / "work2"),
            "--decoder-v2", SHIPPED,
            "--datasets", "CHAMELEON",
            "--backbone-weights", str(tmp_path / "nonexistent"),
        ],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert r.returncode != 0
    assert "ASSET PROBLEM" in (r.stdout + r.stderr)


def _run_check_assets(tmp_path, extra, sub="RefCOD"):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    return subprocess.run(
        [
            sys.executable, os.path.join(REPO, "scripts", "parity.py"),
            "--data-dir", str(tmp_path / sub),
            "--cache-dir", str(tmp_path / "cache"),
            "--datasets", "CHAMELEON",
            "--check-assets",
        ]
        + extra,
        capture_output=True, text=True, timeout=120, env=env,
    )


def test_check_assets_accepts_sane_layout(tmp_path):
    _synth(str(tmp_path / "RefCOD"))
    r = _run_check_assets(tmp_path, ["--decoder-v2", SHIPPED])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "assets: OK" in r.stdout


def test_check_assets_flags_malformed_layout(tmp_path):
    """Existing-but-malformed paths fail LOUDLY with actionable messages:
    a gt-less dataset, a garbage 'safetensors' file, an empty weights dir."""
    import shutil

    _synth(str(tmp_path / "RefCOD"))
    shutil.rmtree(str(tmp_path / "RefCOD" / "CHAMELEON" / "gt"))
    bad_ckpt = tmp_path / "bad.safetensors"
    bad_ckpt.write_bytes(b"not a safetensors file")
    (tmp_path / "weights").mkdir()
    r = _run_check_assets(
        tmp_path,
        [
            "--decoder-v2", str(bad_ckpt),
            "--backbone-weights", str(tmp_path / "weights"),
        ],
    )
    assert r.returncode == 2, r.stdout + r.stderr
    out = r.stdout
    assert "missing" in out and "gt" in out
    assert "not a readable safetensors" in out
    assert "no model.safetensors" in out
