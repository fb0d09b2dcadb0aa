"""Console entry points: the framework's CLI surface as importable functions.

The ``scripts/*.py`` files keep the reference repo's public script layout
(reference ``scripts/train.py`` / ``eval.py`` / ``LTtrain.py`` / ``LTeval.py``
/ ``generate_pseudo_label.py``) and delegate here, so the same code also
backs the installed ``ucod-*`` console commands declared in
``pyproject.toml`` — a pip-installed framework does not depend on the
repository checkout's ``sys.path`` bootstrapping.

Heavy imports (jax, the engine) stay inside the ``*_main`` bodies: argument
errors and ``--help`` must not pay backend initialisation.
"""

from __future__ import annotations

import argparse
import os

__all__ = [
    "parse_args",
    "init_cfg",
    "train_main",
    "eval_main",
    "lt_train_main",
    "lt_eval_main",
    "generate_pseudo_label_main",
]


def parse_args(description: str = "ucod-dpl-tpu", argv=None):
    """CLI argument parsing (same public flags as the reference scripts/args.py)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", "-c", help="config file path", required=True)
    parser.add_argument("--work_dir", type=str, default="work_dir", help="work dir")
    parser.add_argument("--resume", type=str, default=None, help="resume from checkpoint")
    parser.add_argument("--load_from", type=str, default=None, help="load from checkpoint")
    parser.add_argument(
        "--refiner_path", type=str, default=None, help="load refiner checkpoint"
    )
    parser.add_argument(
        "--datasets",
        type=str,
        default=None,
        help="comma-separated eval dataset names (overrides the default list)",
    )
    parser.add_argument(
        "--profile",
        action="store_true",
        help="capture a jax.profiler trace under <work_dir>/profile",
    )
    parser.add_argument(
        "--opts",
        nargs=argparse.REMAINDER,
        default=[],
        help="dotted-key config overrides: key value [key value ...]",
    )
    return parser.parse_args(argv)


def init_cfg(args, mode: str):
    """Shared entry-script plumbing: config init with work_dir derivation."""
    from ucod_dpl_tpu.config import load_config

    cfg = load_config(args.config, overrides=args.opts or None)
    cfg.mode = mode
    cfg.dataset_cfg.valset_cfg.keep_size = mode != "train"
    # load_from/refiner_path flow to the Runner constructors directly (the
    # entry scripts pass args.*) — mirroring them into dead cfg keys here
    # would mislead config authors into expecting a cfg-driven load path
    if args.resume:
        cfg.train_cfg.resume = args.resume  # consumed by TrainLoop._resume
    # work_dir derived from the config path, as the reference does
    # (scripts/train.py:14-18)
    cfg_dir = os.path.dirname(os.path.abspath(args.config))
    try:
        rel = os.path.relpath(cfg_dir, os.path.abspath("./configs"))
    except ValueError:
        rel = os.path.basename(cfg_dir)
    if rel.startswith(".."):
        rel = os.path.basename(cfg_dir)
    cfg.work_dir = os.path.join(
        args.work_dir, rel, os.path.splitext(os.path.basename(args.config))[0]
    )
    os.makedirs(cfg.work_dir, exist_ok=True)
    # logs/checkpoints live under the derived work_dir — the reference
    # overwrites log_cfg.log_path from work_dir unconditionally
    # (runner.py:133-140), so a base-config DEFAULT must not defeat
    # --work_dir.  An EXPLICIT --opts log_cfg.log_path override, however,
    # is the user speaking and wins.
    if "log_cfg.log_path" not in (args.opts or []):
        cfg.log_cfg.log_path = os.path.join(cfg.work_dir, "logs")
    return cfg


_EVAL_DEFAULT_DATASETS = ["CHAMELEON", "TE-CAMO", "TE-COD10K", "NC4K"]


def train_main(argv=None):
    """Stage-1 UCOD-DPL training (counterpart of reference scripts/train.py)."""
    args = parse_args("UCOD-DPL stage-1 training", argv)
    cfg = init_cfg(args, mode="train")

    from ucod_dpl_tpu.engine import Runner
    from ucod_dpl_tpu.utils import set_random_seed
    from ucod_dpl_tpu.utils.profiling import maybe_profile

    set_random_seed(42)
    runner = Runner(cfg, mode="train", load_from=args.load_from)
    with maybe_profile(args.profile, os.path.join(cfg.work_dir, "profile")):
        runner.launch_train()


def eval_main(argv=None):
    """Stage-1 LookTwice evaluation (counterpart of reference scripts/eval.py)."""
    args = parse_args("UCOD-DPL stage-1 eval (LookTwice)", argv)
    cfg = init_cfg(args, mode="eval")
    datasets = args.datasets.split(",") if args.datasets else _EVAL_DEFAULT_DATASETS

    from ucod_dpl_tpu.engine import Runner
    from ucod_dpl_tpu.utils import set_random_seed
    from ucod_dpl_tpu.utils.profiling import maybe_profile

    set_random_seed(42)
    results = {}
    fe = None  # built by the first Runner, shared by the rest: the backbone
    # and its jitted programs are dataset-independent, and rebuilding them
    # per test set multiplies the compile/trace startup cost by 4
    with maybe_profile(args.profile, os.path.join(cfg.work_dir, "profile")):
        for dataset in datasets:
            cfg.dataset_cfg.valset_cfg.DATASET = dataset
            print(f"running {dataset}")
            runner = Runner(
                cfg, mode="eval", load_from=args.load_from, feature_extractor=fe
            )
            fe = runner.feature_extractor
            results[dataset] = runner.launch_val_look_twice()
    for name, res in results.items():
        print(name, {k: round(v, 4) for k, v in res.items()})


def lt_train_main(argv=None):
    """CORAL stage-2 (UDLR refiner) training (counterpart of reference
    scripts/LTtrain.py — the reference's stage-2 loop was never released,
    loop_CORAL.py:38-39 is a stub; this framework completes it, see
    engine/coral_loop.LocalRefineTrainLoop)."""
    args = parse_args("CORAL stage-2 training", argv)
    cfg = init_cfg(args, mode="train")

    from ucod_dpl_tpu.engine.runner import LocalRefineRunner
    from ucod_dpl_tpu.utils import set_random_seed
    from ucod_dpl_tpu.utils.profiling import maybe_profile

    set_random_seed(42)
    with maybe_profile(args.profile, os.path.join(cfg.work_dir, "profile")):
        runner = LocalRefineRunner(
            cfg, mode="train", load_from=args.load_from, refiner_path=args.refiner_path
        )
        runner.launch_train()


def lt_eval_main(argv=None):
    """CORAL stage-2 evaluation (counterpart of reference scripts/LTeval.py)."""
    args = parse_args("CORAL stage-2 eval (UDLR)", argv)
    cfg = init_cfg(args, mode="eval")
    datasets = args.datasets.split(",") if args.datasets else _EVAL_DEFAULT_DATASETS

    from ucod_dpl_tpu.engine.runner import LocalRefineRunner
    from ucod_dpl_tpu.utils import set_random_seed
    from ucod_dpl_tpu.utils.profiling import maybe_profile

    set_random_seed(42)
    results = {}
    fe = None  # shared across test sets (see eval_main)
    with maybe_profile(args.profile, os.path.join(cfg.work_dir, "profile")):
        for dataset in datasets:
            cfg.dataset_cfg.valset_cfg.DATASET = dataset
            print(f"running {dataset}")
            runner = LocalRefineRunner(
                cfg, mode="eval", load_from=args.load_from,
                refiner_path=args.refiner_path, feature_extractor=fe,
            )
            fe = runner.feature_extractor
            results[dataset] = runner.launch_val()
    for name, res in results.items():
        print(name, {k: round(v, 4) for k, v in res.items()})


def generate_pseudo_label_main(argv=None):
    """Pseudo-label generation (counterpart of reference
    generate_pseudo_label.py).

    DINOv2-base at 224px over the training images; background segmentation
    from the last layer's CLS attention + key cosine similarity; small-
    component cleanup; dumped to the pseudo-label cache layout the datasets
    read.  Images run through the backbone in batches (the
    reference is strictly image-at-a-time) and the full background-mask
    math executes as one XLA program per batch.
    """
    parser = argparse.ArgumentParser(description="Generate pseudo labels for COD datasets")
    parser.add_argument("--dataset", type=str, default="TR-CAMO+TR-COD10K",
                        help="Dataset name(s), '+'-joined")
    parser.add_argument("--image_path", type=str, default="./datasets/RefCOD/{}/im",
                        help="Template path for images ({} = dataset name)")
    parser.add_argument("--cache_path", type=str, default="./datasets/cache/pseudo_label_cache/",
                        help="Cache output root")
    parser.add_argument("--backbone_weights", type=str, default="./weights",
                        help="Local HuggingFace weight dir for facebook/dinov2-base")
    parser.add_argument("--th_bkg", type=float, default=0.6)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--fe_type", type=str, default="dinov2", choices=["dinov1", "dinov2"])
    parser.add_argument("--overwrite", action="store_true",
                        help="Regenerate even if a complete cache exists "
                             "(e.g. after changing --th_bkg)")
    args = parser.parse_args(argv)

    import numpy as np

    from ucod_dpl_tpu.config import CfgNode
    from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu.data.transforms import image_transform
    from ucod_dpl_tpu.ops.pseudo_label import (
        compute_background_mask,
        refine_small_components,
    )
    from ucod_dpl_tpu.utils import get_logger
    from ucod_dpl_tpu.utils.fileio import ArrayCache, ImageIO

    logger = get_logger()
    fe = FeatureExtractor(
        CfgNode(
            {
                "type": args.fe_type,
                "backbone": "facebook/dinov2-base" if args.fe_type == "dinov2" else "facebook/dino-vitb8",
                "backbone_weights": args.backbone_weights,
            }
        )
    )

    image_paths = []
    for dataset in args.dataset.split("+"):
        dir_path = args.image_path.format(dataset)
        if not os.path.exists(dir_path):
            raise ValueError(f"Image path {dir_path} does not exist!")
        image_paths += ImageIO.list_dir_image(dir_path)
    image_paths = sorted(image_paths)
    logger.log(f"Found {len(image_paths)} images from {args.dataset}.")

    cache = ArrayCache(os.path.join(args.cache_path, args.dataset))
    if cache.mode == "r":
        # a complete cache opens read-only; without this the first write
        # below would raise an opaque "not in write mode" AFTER the backbone
        # warmed up — decide up front instead
        if not args.overwrite:
            logger.log(
                f"Pseudo-label cache at {cache.base_path} is already complete "
                f"({len(cache)} entries); pass --overwrite to regenerate "
                "(required after changing --th_bkg or the image set)"
            )
            return
        cache.invalidate("--overwrite requested")
    size = (args.image_size, args.image_size)
    grid = args.image_size // fe.config.patch_size

    idx = 0
    for start in range(0, len(image_paths), args.batch_size):
        chunk = image_paths[start : start + args.batch_size]
        batch = np.stack(
            [image_transform(ImageIO.read_image(p, "RGB"), size) for p in chunk]
        )
        key_tokens, _, cls_attn = fe.extract_with_attention(batch)
        bkg, _ = compute_background_mask(
            cls_attn, key_tokens, (grid, grid), th_bkg=args.th_bkg
        )
        fg = 1.0 - np.asarray(bkg)  # (B, h, w), 1 on candidate foreground
        for m in fg:
            refined = refine_small_components(m)
            cache.write(idx, refined[:, :, None].astype(np.float32))
            idx += 1
        if (start // args.batch_size) % 10 == 0:
            logger.log(f"pseudo-labels: {idx}/{len(image_paths)}")
    import hashlib

    stems = "\n".join(os.path.splitext(os.path.basename(str(p)))[0] for p in image_paths)
    cache.flush(
        meta={
            "n": idx,
            # same identity scheme as CODDataset._cache_identity: lets the
            # trainer invalidate this positional cache when the image set
            # changes underneath it
            "fingerprint": hashlib.sha1(stems.encode()).hexdigest(),
            "th_bkg": args.th_bkg,
        }
    )
    logger.log(f"Generated {idx} pseudo labels into {cache.base_path}")
