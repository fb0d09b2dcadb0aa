"""chip_smoke.py on the CPU: it must refuse to report a result without a
GPU, and every phase must run at tiny widths (the card runs them at full
width)."""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY_ARCH = {"hidden_size": 64, "num_layers": 2, "num_heads": 4, "patch_size": 14, "image_size": 56}
TINY = chip_smoke.Spec(
    arch=TINY_ARCH, image_size=56, feature_size=8, n_train=6, n_test=2,
    source_hw=(60, 80), batch=2, attn_shapes=((2, 50), (1, 37)), heads=4,
    head_dim=16, backbone_batch=2, pseudo_label_px=56,
)


def test_chip_smoke_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "phase env FAILED" in out


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    it exits non-zero and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_write_png_roundtrip(tmp_path):
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(7, 9, 3), dtype=np.uint8)
    grey = rng.integers(0, 256, size=(5, 4), dtype=np.uint8)
    chip_smoke.write_png(str(tmp_path / "rgb.png"), rgb)
    chip_smoke.write_png(str(tmp_path / "grey.png"), grey)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "rgb.png")), rgb)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "grey.png")), grey)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """Tiny synthetic dataset; the pseudo-label CLI (which builds the stock
    DINOv2-base) gets the tiny architecture through DinoConfig."""
    from ucod_dpl_tpu.models.dino import DinoConfig

    tiny_dino = dataclasses.replace(DinoConfig.dinov2_base(), **TINY_ARCH)
    root = str(tmp_path_factory.mktemp("smoke"))
    chip_smoke.make_dataset(os.path.join(root, "RefCOD"), TINY, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DinoConfig, "dinov2_base", staticmethod(lambda: tiny_dino))
        state = {"root": root}
        yield state


def _trained(smoke):
    if "runner" not in smoke:
        chip_smoke.phase_pseudo_labels(TINY, smoke["root"])
        smoke["runner"], smoke["losses"] = chip_smoke.phase_train(TINY, smoke["root"])
    return smoke["runner"]


@pytest.mark.parametrize(
    "phase", ["attention", "backbone", "pseudo_labels", "train", "eval", "lora", "int8"]
)
def test_smoke_phase_tiny(phase, smoke):
    root = smoke["root"]
    if phase == "attention":
        chip_smoke.phase_attention(TINY)
    elif phase == "backbone":
        chip_smoke.phase_backbone(TINY, seed=0)
    elif phase == "pseudo_labels":
        chip_smoke.phase_pseudo_labels(TINY, root)
    elif phase == "train":
        _trained(smoke)
        assert len(smoke["losses"]) == 3  # 6 images / batch 2
    elif phase == "eval":
        row = chip_smoke.phase_eval(_trained(smoke))
        assert {"MAE", "SMeasure"} <= set(row)
    elif phase == "lora":
        _trained(smoke)
        chip_smoke.phase_lora(TINY, root)
    elif phase == "int8":
        chip_smoke.phase_int8(TINY, _trained(smoke), root)


@pytest.mark.heavy  # two processes, ~1 min
def test_smoke_four_card_path_tiny(tmp_path):
    """The ``--four`` path on four virtual CPU devices: a one-device child
    runs the DP path, then the parent runs it over four devices plus TP and
    SP extraction, each compared with its one-device counterpart."""
    spec = dataclasses.replace(TINY, n_train=12, batch=4)
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import chip_smoke as s\n"
        "s.WORK = %r\n"
        "spec = s.Spec(**%r)\n"
        "ref = s.run_reference_child(0, spec)\n"
        "s.compare_four(0, spec, ref)\n"
        "print('FOUR OK')\n"
    ) % (REPO, str(tmp_path), dataclasses.asdict(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "FOUR OK" in r.stdout and "dp four cards vs one" in r.stdout
