"""End-to-end (host-inclusive) eval throughput benchmark.

Measures the WHOLE stage-1 pipeline on a synthetic 64-image dataset:
JPEG decode -> resize/normalise -> DINO feature extraction (cache build) ->
decoder -> LookTwice (connected components, bbox expansion, crop
re-inference) -> metric scoring -> PNG mask writes.

Two numbers:
  * cache-build rate (the one-time DINO sweep, SURVEY §3.5);
  * cached-eval rate (the steady-state loop the reference runs per test set).

Prints ONE JSON line like bench.py (separate file so the driver's bench.py
contract — a single device-path metric — is untouched).
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from PIL import Image

N_IMAGES = int(os.environ.get("UCOD_BENCH_E2E_N", "64"))


def make_dataset(root: str, n: int) -> None:
    im = os.path.join(root, "BENCH", "im")
    gt = os.path.join(root, "BENCH", "gt")
    os.makedirs(im)
    os.makedirs(gt)
    rng = np.random.default_rng(0)
    for i in range(n):
        h, w = 480 + (i % 3) * 20, 640 - (i % 5) * 16
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        yy, xx = np.mgrid[:h, :w]
        cy, cx, r = rng.integers(100, h - 100), rng.integers(100, w - 100), 40 + i % 30
        blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        arr[blob] = (arr[blob] * 0.3 + 150).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(im, f"img{i:03d}.jpg"), quality=90)
        Image.fromarray((blob * 255).astype(np.uint8)).save(
            os.path.join(gt, f"img{i:03d}.png")
        )


def main():
    import jax

    from ucod_dpl_tpu.config import load_config
    from ucod_dpl_tpu.engine import Runner

    tmp = tempfile.mkdtemp(prefix="ucod_bench_e2e_")
    try:
        make_dataset(os.path.join(tmp, "RefCOD"), N_IMAGES)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        cfg = load_config(os.path.join(root, "configs/uscod/UCOD-DPL_dinov2.py"))
        cfg.mode = "eval"
        cfg.work_dir = os.path.join(tmp, "work")
        cfg.log_cfg.log_path = os.path.join(tmp, "logs")
        cfg.dataset_cfg.dataset_dir = os.path.join(tmp, "RefCOD")
        cfg.dataset_cfg.cache_dir = os.path.join(tmp, "cache")
        cfg.dataset_cfg.valset_cfg.DATASET = "BENCH"
        cfg.dataset_cfg.valset_cfg.keep_size = True
        cfg.dataset_cfg.val_loader_cfg.batch_size = 16
        if jax.default_backend() == "cpu":  # CPU rehearsal: shrink the backbone
            cfg.dataset_cfg.feature_extractor_cfg.arch = {
                "hidden_size": 768, "num_layers": 2, "num_heads": 12,
                "patch_size": 14, "image_size": 518,
            }

        # warm the extractor program first (same config+dtype+shape as the
        # cache build — the dtype is part of the jit cache key) so t_build
        # measures steady-state throughput, not the one-time XLA compile
        from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor
        from ucod_dpl_tpu.device import resolve_compute_dtype

        import inspect

        from ucod_dpl_tpu.data.dataset import CODDataset

        from ucod_dpl_tpu.parallel import build_mesh

        # the SAME mesh the Runner will use: a mesh-less warm extractor
        # compiles an unsharded-input executable that a multi-device
        # Runner's sharded inputs would not hit — the compile would land
        # inside t_build after all
        mesh = build_mesh(cfg.get("tpu_cfg", {}).get("mesh"))
        fe = FeatureExtractor(
            cfg.dataset_cfg.feature_extractor_cfg,
            compute_dtype=resolve_compute_dtype(cfg),
            mesh=mesh,
        )
        size = tuple(cfg.dataset_cfg.valset_cfg.image_size)
        # warm the exact batch shapes the cache build will compile: the
        # resolved config's override wins (runner._make_dataset passes it),
        # falling back to the constructor default — plus the ragged tail
        # batch when N does not divide evenly (a second jit cache entry)
        warm_bs = cfg.dataset_cfg.valset_cfg.get(
            "cache_build_batch",
            inspect.signature(CODDataset.__init__).parameters[
                "cache_build_batch"
            ].default,
        )
        fe.extract(np.zeros((warm_bs, *size, 3), np.float32))
        tail = N_IMAGES % warm_bs
        if tail:
            fe.extract(np.zeros((tail, *size, 3), np.float32))

        t0 = time.perf_counter()
        # the warmed extractor is SHARED with the Runner (same object, same
        # jit cache), so t_build times the cache sweep itself
        runner = Runner(cfg, mode="eval", feature_extractor=fe)
        t_build = time.perf_counter() - t0

        # warm the jitted programs once, then measure the steady-state loop
        runner.launch_val_look_twice()
        t0 = time.perf_counter()
        runner.launch_val_look_twice()
        t_eval = time.perf_counter() - t0

        dev = jax.devices()[0]
        on_card = dev.platform == "gpu"  # a CPU rehearsal reports no rate
        print(
            json.dumps(
                {
                    "metric": "end-to-end eval images/sec (features cached; "
                    "decode+decoder+LookTwice+metrics+PNG)",
                    "value": N_IMAGES / t_eval if on_card else None,
                    "unit": "img/s",
                    "cache_build_imgs_per_sec": N_IMAGES / t_build if on_card else None,
                    "n_images": N_IMAGES,
                    "device": {"platform": dev.platform, "kind": dev.device_kind,
                               "count": len(jax.devices())},
                }
            )
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
