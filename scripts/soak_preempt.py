"""Randomized preemption soak: SIGTERM a real training CLI at random
wall-clock offsets, resume, verify every cycle ends cleanly.

The deterministic e2e test (tests/test_preemption.py) kills at a FIXED
point (right after "epoch 1 done"); signal-window bugs — a SIGTERM landing
inside an optimizer dispatch, during the checkpoint write itself, at the
eval/train boundary handoff, or before the handler is even installed —
only surface under randomized timing.  Cycles rotate through config
variants that reach the distinct signal-handling code paths: plain
training, discriminator inter-training, boundary validation (the deferred
eval-poll path), and LoRA (the joint-state checkpoint path).

    python scripts/soak_preempt.py --minutes 30 [--seed 0] [--keep]

Per cycle: launch scripts/train.py on a synthetic dataset, SIGTERM after a
random delay, then classify:
  * completed      — the schedule finished before the signal (rc 0);
  * preempted      — rc 143 + state_preempt written -> RESUME and require
                     rc 0 + "Resumed training state";
  * early-kill     — rc 143 before the loop installed the handler (no
                     state expected; nothing trained, nothing lost);
  * ANYTHING ELSE  — failure: dump the log tail, exit 1.

Exit 0 = no cycle failed.
"""

import argparse
import glob
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

_CFG = """
cfg = dict(
    mode="train",
    seed=42,
    model_cfg=dict(dim=64, feature_size=8, dis_use_features=False,
                   ema_weight=0.99,
                   lora=dict(enable={lora}, rank=2, alpha=4.0, lr=1e-4)),
    train_cfg=dict(
        max_epoch={max_epoch}, start_finetune=-5, merge_method="dis", start_epoch=0,
        lr0=2e-4, dis_lr0=1e-3, dis_intertrain={dis_intertrain}, dis_epoch=1,
        step_lr_size=25, step_lr_gamma=0.95,
        save_cfg=dict(save_mode="all", save_interval=1000, start_save=0),{resume}
    ),
    val_cfg=dict(enable_val={enable_val}, val_interval=1, start_val=0,
                 look_twice=True, look_twice_th=0.95, expand_type="dynamic",
                 save_preds=False),
    log_cfg=dict(log_path={log_path!r}, multi_rank=[0], log_interval=1),
    tpu_cfg=dict(mesh=dict(data=-1, model=1)),
    dataset_cfg=dict(
        dataset_dir={dataset_dir!r},
        cache_dir={cache_dir!r},
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

VARIANTS = (
    {"name": "plain", "dis_intertrain": 1000, "enable_val": False, "lora": False},
    {"name": "dis", "dis_intertrain": 1, "enable_val": False, "lora": False},
    {"name": "val", "dis_intertrain": 1000, "enable_val": True, "lora": False},
    {"name": "lora", "dis_intertrain": 1000, "enable_val": False, "lora": True},
)


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONUNBUFFERED"] = "1"
    return env


def _write_cfg(path, base, variant, max_epoch, resume_path=None):
    resume = ""
    if resume_path:
        resume = f"\n        resume={resume_path!r},"
    with open(path, "w") as f:
        f.write(
            _CFG.format(
                lora=variant["lora"],
                dis_intertrain=variant["dis_intertrain"],
                enable_val=variant["enable_val"],
                max_epoch=max_epoch,
                resume=resume,
                log_path=base["log_path"],
                dataset_dir=base["dataset_dir"],
                cache_dir=base["cache_dir"],
            )
        )


def _run(cfg_path, work_dir, log_file, env, kill_after=None, timeout=600):
    with open(log_file, "a") as lf:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "train.py"),
             "-c", str(cfg_path), "--work_dir", str(work_dir)],
            stdout=lf, stderr=subprocess.STDOUT, env=env, cwd=REPO,
        )
        if kill_after is not None:
            t0 = time.monotonic()
            while time.monotonic() - t0 < kill_after:
                if proc.poll() is not None:
                    return proc.returncode
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            return "TIMEOUT"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keep", action="store_true", help="keep the work dir")
    args = ap.parse_args()
    rng = random.Random(args.seed)

    root = tempfile.mkdtemp(prefix="ucod_soak_")
    print(f"soak root: {root}")
    from ref_pipeline_harness import make_synthetic_dataset

    import numpy as np

    from ucod_dpl_tpu.utils.fileio import ArrayCache

    make_synthetic_dataset(os.path.join(root, "RefCOD", "TINY"), n=4)
    prng = np.random.default_rng(0)
    ArrayCache(os.path.join(root, "cache", "pseudo_label_cache", "TINY")).dump_list(
        [(prng.random((4, 4, 1)) > 0.5).astype(np.float32) for _ in range(4)]
    )
    env = _env()
    deadline = time.monotonic() + args.minutes * 60
    counts = {"completed": 0, "preempted+resumed": 0, "early-kill": 0}
    cycle = 0
    failed = False

    while time.monotonic() < deadline and not failed:
        variant = VARIANTS[cycle % len(VARIANTS)]
        cyc_dir = os.path.join(root, f"cycle{cycle:03d}")
        os.makedirs(cyc_dir)
        base = {
            "log_path": os.path.join(cyc_dir, "logs"),
            "dataset_dir": os.path.join(root, "RefCOD"),
            "cache_dir": os.path.join(root, "cache"),
        }
        cfg_path = os.path.join(cyc_dir, "cfg.py")
        log_file = os.path.join(cyc_dir, "run.out")
        _write_cfg(cfg_path, base, variant, max_epoch=10_000_000)
        # uniform over the whole lifecycle: startup (~10-20s of imports +
        # compiles on this host), cache reads, the epoch loop, boundaries
        kill_after = rng.uniform(2.0, 45.0)
        rc = _run(cfg_path, os.path.join(cyc_dir, "work"), log_file, env,
                  kill_after=kill_after)
        states = glob.glob(os.path.join(cyc_dir, "**", "state_preempt.npz"),
                           recursive=True)

        def tail(n=2500):
            try:
                with open(log_file) as f:
                    return f.read()[-n:]
            except OSError:
                return "<no log>"

        label = f"cycle {cycle:03d} [{variant['name']}] kill@{kill_after:.1f}s rc={rc}"
        # two legal signal outcomes: the handler converted it (CLI exits
        # 128+15 after the boundary checkpoint), or it landed before the
        # loop installed the handler (default disposition: waitpid reports
        # signal death, Popen.returncode == -15, nothing trained yet)
        graceful = rc == 128 + signal.SIGTERM
        sig_death = rc == -signal.SIGTERM

        def loop_was_running():
            import re

            log = tail(25_000)
            # per-step losses are logged every step (log_interval=1): any
            # loss line or completed-epoch marker means batches ran
            return bool(re.search(r"epoch \d+ done|loss", log))

        if rc == 0:
            counts["completed"] += 1
            print(f"{label} -> completed before signal")
        elif graceful and states:
            with open(states[0].replace(".npz", ".json")) as f:
                saved_epoch = int(json.load(f)["epoch"])
            _write_cfg(cfg_path, base, variant, max_epoch=saved_epoch + 1,
                       resume_path=states[0][: -len(".npz")])
            rc2 = _run(cfg_path, os.path.join(cyc_dir, "work"), log_file, env,
                       kill_after=None)
            resumed = "Resumed training state" in open(log_file).read()
            if rc2 == 0 and resumed:
                counts["preempted+resumed"] += 1
                print(f"{label} -> preempted at epoch {saved_epoch}, resumed OK")
            else:
                print(f"FAIL {label}: resume rc={rc2} resumed_log={resumed}\n{tail()}")
                failed = True
        elif (graceful or sig_death) and not states:
            # legal ONLY before the loop runs batches — after that, a
            # SIGTERM without a checkpoint is a dropped preemption
            if loop_was_running():
                print(f"FAIL {label}: loop was running but no state written\n{tail()}")
                failed = True
            else:
                counts["early-kill"] += 1
                print(f"{label} -> killed before the loop (nothing to save)")
        else:
            print(f"FAIL {label}: unexpected outcome (states={bool(states)})\n{tail()}")
            failed = True
        if not args.keep and not failed:
            shutil.rmtree(cyc_dir, ignore_errors=True)
        cycle += 1

    print(f"soak: {cycle} cycles -> {counts}" + ("  [FAILED]" if failed else "  [OK]"))
    if not args.keep and not failed:
        shutil.rmtree(root, ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
