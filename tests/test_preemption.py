"""Preemption safety end-to-end (SURVEY §5.3 — the reference has none).

A real training CLI process receives SIGTERM mid-run: it must write the
full resume state (state_preempt) and exit 128+15; a second run with
--resume must restore and complete from the saved epoch.
"""

import pytest

import os
import signal
import subprocess
import sys
import time

import numpy as np

pytestmark = pytest.mark.heavy  # multi-process / e2e: excluded from the quick loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CFG = """
cfg = dict(
    mode="train",
    seed=42,
    model_cfg=dict(dim=64, feature_size=8, dis_use_features=False,
                   ema_weight=0.99,
                   lora=dict(enable=False, rank=2, alpha=4.0, lr=1e-4)),
    train_cfg=dict(
        max_epoch=10_000_000, start_finetune=-5, merge_method="dis", start_epoch=0,
        lr0=2e-4, dis_lr0=1e-3, dis_intertrain=1000, dis_epoch=1,
        step_lr_size=25, step_lr_gamma=0.95,
        save_cfg=dict(save_mode="all", save_interval=1000, start_save=0),
    ),
    val_cfg=dict(enable_val=False, look_twice=True, look_twice_th=0.95,
                 expand_type="dynamic"),
    log_cfg=dict(log_path=None, multi_rank=[0], log_interval=1),
    tpu_cfg=dict(mesh=dict(data=-1, model=1)),
    dataset_cfg=dict(
        dataset_dir=None,
        cache_dir=None,
        trainset_cfg=dict(DATASET="TINY", require_label=False,
                          image_size=(56, 56), bkg_th=0.6),
        valset_cfg=dict(DATASET="TINY", require_label=True,
                        image_size=(56, 56), keep_size=True),
        trainloader_cfg=dict(batch_size=2, shuffle=True),
        val_loader_cfg=dict(batch_size=1),
        feature_extractor_cfg=dict(
            type="dinov2", backbone="facebook/dinov2-base",
            backbone_weights="/nonexistent",
            arch=dict(hidden_size=64, num_layers=2, num_heads=4,
                      patch_size=14, image_size=56),
        ),
    ),
)
"""


def test_sigterm_checkpoints_and_resumes(tmp_path):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ref_pipeline_harness import make_synthetic_dataset
    from ucod_dpl_tpu.utils.fileio import ArrayCache

    make_synthetic_dataset(str(tmp_path / "RefCOD" / "TINY"), n=4)
    rng = np.random.default_rng(0)
    ArrayCache(str(tmp_path / "cache" / "pseudo_label_cache" / "TINY")).dump_list(
        [(rng.random((4, 4, 1)) > 0.5).astype(np.float32) for _ in range(4)]
    )
    cfg_py = tmp_path / "tiny_train.py"
    cfg_py.write_text(
        _CFG.replace(
            "log_path=None", f"log_path={str(tmp_path / 'logs')!r}"
        ).replace(
            "dataset_dir=None", f"dataset_dir={str(tmp_path / 'RefCOD')!r}"
        ).replace(
            "cache_dir=None", f"cache_dir={str(tmp_path / 'cache')!r}"
        )
    )

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONUNBUFFERED"] = "1"
    # --work_dir owns the log dir (reference parity): locate run.log and
    # the ckp dir wherever the runner derived them under tmp_path
    import glob as _glob

    def runner_log() -> str:
        parts = []
        for f in _glob.glob(str(tmp_path / "**" / "run.log"), recursive=True):
            try:
                with open(f) as fh:
                    parts.append(fh.read())
            except OSError:
                pass
        return "\n".join(parts)

    log = tmp_path / "run.out"
    with open(log, "w") as lf:
        proc = subprocess.Popen(
            [
                sys.executable, os.path.join(REPO, "scripts", "train.py"),
                "-c", str(cfg_py), "--work_dir", str(tmp_path / "work"),
            ],
            stdout=lf, stderr=subprocess.STDOUT, env=env, cwd=REPO,
        )
        # wait until the epoch loop is demonstrably running
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise AssertionError(
                    "training exited before the signal:\n" + log.read_text()[-2000:]
                )
            if "epoch 1 done" in runner_log():
                break
            time.sleep(1)
        else:
            proc.kill()
            raise AssertionError("epoch loop never started:\n" + log.read_text()[-2000:])

        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)

    assert rc == 128 + signal.SIGTERM, (rc, log.read_text()[-2000:])
    states = _glob.glob(str(tmp_path / "**" / "state_preempt.npz"), recursive=True)
    assert states, runner_log()[-2000:]
    from pathlib import Path

    ckp = Path(states[0]).parent
    assert (ckp / "state_preempt.json").exists()
    assert "state saved" in runner_log()

    # resume from the preemption state and let a short schedule finish
    import json

    with open(ckp / "state_preempt.json") as f:
        saved_epoch = int(json.load(f)["epoch"])

    text = cfg_py.read_text()
    text = text.replace("max_epoch=10_000_000", f"max_epoch={saved_epoch + 2}")
    text = text.replace(
        "save_cfg=dict(save_mode=\"all\", save_interval=1000, start_save=0)",
        "save_cfg=dict(save_mode=\"all\", save_interval=1000, start_save=0),\n        resume="
        + repr(str(ckp / "state_preempt")),
    )
    cfg_py.write_text(text)
    r = subprocess.run(
        [
            sys.executable, os.path.join(REPO, "scripts", "train.py"),
            "-c", str(cfg_py), "--work_dir", str(tmp_path / "work"),
        ],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=420,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    combined = r.stdout + r.stderr
    assert "Resumed training state" in combined, combined[-2000:]
