"""One-command quality-parity runner against the published reference tables.

Given pretrained DINO weights and the COD datasets, runs stage-1 (UCOD-DPL,
LookTwice) and optionally stage-2 (CORAL/UDLR) evaluation over the four
standard test sets and compares every metric against a machine-readable copy
of BASELINE.md (transcribed from the reference's published tables,
``images/performance_UCOD-DPL.png`` / ``performance_CORAL.png``,
README.md:61-71).

    python scripts/parity.py \
        --data-dir /data/RefCOD --cache-dir /data/cache \
        --backbone-weights /weights/hf \
        --decoder-v2 /root/reference/weights/UCOD_DPL_dinov2.safetensors \
        [--decoder-v1 ...] [--refiner-v2 ...] [--tolerance 0.01] \
        [--report parity_report.json] [--datasets CHAMELEON,NC4K]

Exit code 0 iff every compared metric is within ``--tolerance`` of the
published value.  ``--allow-random-backbone`` keeps the run alive without
pretrained weights (plumbing tests only — numbers will not match).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (stage, variant, dataset) -> {metric: published value}
# metric keys use OUR result-dict names: Sm=SMeasure, Fbw=WFM, Fbm=F_MEAN,
# Ephi-m=E_MEAN, M=MAE (reference metric.py:60-74 emits the same keys).
BASELINE = {}
_S1 = {
    "dinov1": {
        "CHAMELEON": (0.734, 0.625, 0.680, 0.854, 0.072),
        "TE-CAMO": (0.706, 0.621, 0.689, 0.801, 0.108),
        "TE-COD10K": (0.727, 0.577, 0.627, 0.822, 0.059),
        "NC4K": (0.761, 0.680, 0.737, 0.851, 0.074),
    },
    "dinov2": {
        "CHAMELEON": (0.864, 0.825, 0.838, 0.931, 0.031),
        "TE-CAMO": (0.793, 0.747, 0.779, 0.862, 0.077),
        "TE-COD10K": (0.834, 0.763, 0.779, 0.916, 0.031),
        "NC4K": (0.850, 0.818, 0.835, 0.923, 0.043),
    },
}
_CORAL = {
    "dinov1": {
        "CHAMELEON": (0.757, 0.660, 0.714, 0.857, 0.066),
        "TE-CAMO": (0.715, 0.635, 0.704, 0.803, 0.105),
        "TE-COD10K": (0.742, 0.600, 0.646, 0.822, 0.055),
        "NC4K": (0.775, 0.702, 0.757, 0.853, 0.070),
    },
    "dinov2": {
        "CHAMELEON": (0.882, 0.850, 0.863, 0.945, 0.027),
        "TE-CAMO": (0.811, 0.771, 0.802, 0.877, 0.071),
        "TE-COD10K": (0.842, 0.772, 0.788, 0.914, 0.027),
        "NC4K": (0.863, 0.834, 0.853, 0.926, 0.038),
    },
}
_METRIC_KEYS = ("SMeasure", "WFM", "F_MEAN", "E_MEAN", "MAE")
for variant, tbl in _S1.items():
    for ds, vals in tbl.items():
        BASELINE[("UCOD-DPL", variant, ds)] = dict(zip(_METRIC_KEYS, vals))
for variant, tbl in _CORAL.items():
    for ds, vals in tbl.items():
        BASELINE[("CORAL", variant, ds)] = dict(zip(_METRIC_KEYS, vals))

DEFAULT_DATASETS = ["CHAMELEON", "TE-CAMO", "TE-COD10K", "NC4K"]


def _load_stage_cfg(cfg_prefix: str, log_prefix: str, variant: str, args):
    from ucod_dpl_tpu.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "uscod", f"{cfg_prefix}_{variant}.py"))
    cfg.dataset_cfg.dataset_dir = args.data_dir
    cfg.dataset_cfg.cache_dir = args.cache_dir
    if args.backbone_weights:
        cfg.dataset_cfg.feature_extractor_cfg.backbone_weights = args.backbone_weights
    cfg.dataset_cfg.feature_extractor_cfg.strict_weights = not args.allow_random_backbone
    cfg.mode = "eval"
    cfg.dataset_cfg.valset_cfg.keep_size = True
    cfg.work_dir = args.work_dir
    cfg.log_cfg.log_path = os.path.join(args.work_dir, f"{log_prefix}_{variant}")
    return cfg


def run_stage1(variant: str, decoder_ckpt: str, datasets, args, report):
    from ucod_dpl_tpu.engine import Runner

    cfg = _load_stage_cfg("UCOD-DPL", "parity", variant, args)
    fe = None  # one backbone per variant, shared across the test sets
    for ds in datasets:
        cfg.dataset_cfg.valset_cfg.DATASET = ds
        runner = Runner(cfg, mode="eval", load_from=decoder_ckpt, feature_extractor=fe)
        fe = runner.feature_extractor
        result = runner.launch_val_look_twice()
        _compare(report, ("UCOD-DPL", variant, ds), result, args.tolerance)


def run_coral(variant: str, decoder_ckpt: str, refiner_ckpt: str, datasets, args, report):
    from ucod_dpl_tpu.engine.runner import LocalRefineRunner

    cfg = _load_stage_cfg("CORAL", "parity_coral", variant, args)
    fe = None
    for ds in datasets:
        cfg.dataset_cfg.valset_cfg.DATASET = ds
        runner = LocalRefineRunner(
            cfg, mode="eval", load_from=decoder_ckpt, refiner_path=refiner_ckpt,
            feature_extractor=fe,
        )
        fe = runner.feature_extractor
        result = runner.launch_val()
        _compare(report, ("CORAL", variant, ds), result, args.tolerance)


def _compare(report, key, result, tol):
    published = BASELINE.get(key)
    row = {
        "stage": key[0],
        "variant": key[1],
        "dataset": key[2],
        "ours": {k: round(float(result[k]), 4) for k in _METRIC_KEYS},
        "published": published,
    }
    if published:
        deltas = {k: round(float(result[k]) - published[k], 4) for k in _METRIC_KEYS}
        row["delta"] = deltas
        row["pass"] = all(abs(d) <= tol for d in deltas.values())
    else:
        row["pass"] = None
    report.append(row)
    status = {True: "PASS", False: "FAIL", None: "----"}[row["pass"]]
    print(f"[{status}] {key[0]} {key[1]} {key[2]}: "
          + " ".join(f"{k}={row['ours'][k]}" for k in _METRIC_KEYS)
          + (f" delta={row.get('delta')}" if published else ""))


def check_assets(args, datasets) -> list:
    """Loud asset validation: when a path EXISTS but is
    malformed, fail with an actionable message instead of a deep stack
    trace minutes into an eval.  Returns a list of problem strings."""
    problems = []

    for ds in datasets:
        ds_root = os.path.join(args.data_dir, ds)
        if not os.path.isdir(ds_root):
            problems.append(
                f"dataset {ds}: {ds_root} does not exist (expected "
                f"<data-dir>/{ds}/{{im,gt}})"
            )
            continue
        im, gt = os.path.join(ds_root, "im"), os.path.join(ds_root, "gt")
        for sub in (im, gt):
            if not os.path.isdir(sub):
                problems.append(f"dataset {ds}: missing {sub}")
        if not (os.path.isdir(im) and os.path.isdir(gt)):
            continue
        # enumerate EXACTLY like the dataset loader (image extensions only):
        # a stray README/.DS_Store must not abort a run the loader would
        # have handled fine — the gate may not be stricter than the code
        # it guards
        from ucod_dpl_tpu.utils.fileio import ImageIO

        im_stems = {p.stem for p in ImageIO.list_dir_image(im)}
        gt_stems = {p.stem for p in ImageIO.list_dir_image(gt)}
        if not im_stems:
            problems.append(f"dataset {ds}: {im} is empty")
        missing_gt = sorted(im_stems - gt_stems)
        if missing_gt:
            problems.append(
                f"dataset {ds}: {len(missing_gt)} image(s) without a gt "
                f"mask (e.g. {missing_gt[:3]})"
            )

    def _check_safetensors(path, what, want_prefixes):
        if path is None:
            return
        if not os.path.exists(path):
            problems.append(f"{what}: {path} does not exist")
            return
        try:
            from ucod_dpl_tpu.models.safetensors_io import load_file

            keys = list(load_file(path))
        except Exception as e:  # noqa: BLE001
            problems.append(f"{what}: {path} is not a readable safetensors file ({e})")
            return
        for prefix in want_prefixes:
            if not any(k.startswith(prefix) for k in keys):
                problems.append(
                    f"{what}: {path} has no '{prefix}*' tensors "
                    f"(found {sorted(keys)[:4]}...) — wrong checkpoint?"
                )

    _check_safetensors(args.decoder_v2, "--decoder-v2", ["decoder.", "decoder_ema."])
    _check_safetensors(args.decoder_v1, "--decoder-v1", ["decoder.", "decoder_ema."])
    _check_safetensors(args.refiner_v2, "--refiner-v2", [""])
    _check_safetensors(args.refiner_v1, "--refiner-v1", [""])

    if args.backbone_weights:
        bw = args.backbone_weights
        if not os.path.isdir(bw):
            problems.append(f"--backbone-weights: {bw} is not a directory")
        else:
            # FeatureExtractor resolves <dir>/<model>/model.safetensors or a
            # flat model.safetensors / pytorch_model.bin (feature_extractor.py
            # ::_candidate_weight_paths) — require at least one candidate
            cands = []
            for root, _, files in os.walk(bw):
                cands += [
                    os.path.join(root, f)
                    for f in files
                    if f in ("model.safetensors", "pytorch_model.bin")
                ]
            if not cands:
                problems.append(
                    f"--backbone-weights: no model.safetensors/"
                    f"pytorch_model.bin anywhere under {bw}"
                )
    return problems


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-dir", required=True, help="RefCOD root with <DATASET>/{im,gt}")
    ap.add_argument("--cache-dir", required=True)
    ap.add_argument("--work-dir", default="./work/parity")
    ap.add_argument("--backbone-weights", default=None,
                    help="local HF weight dir (dino-vitb8 / dinov2-base)")
    ap.add_argument("--decoder-v2", default=None, help="UCOD_DPL_dinov2.safetensors")
    ap.add_argument("--decoder-v1", default=None, help="UCOD_DPL_dinov1.safetensors")
    ap.add_argument("--refiner-v2", default=None, help="CORAL_dinov2 refiner ckpt")
    ap.add_argument("--refiner-v1", default=None)
    ap.add_argument("--datasets", default=",".join(DEFAULT_DATASETS))
    ap.add_argument("--tolerance", type=float, default=0.01)
    ap.add_argument("--report", default="parity_report.json")
    ap.add_argument("--allow-random-backbone", action="store_true",
                    help="plumbing tests only: run without pretrained weights")
    ap.add_argument("--check-assets", action="store_true",
                    help="validate dataset/weight layout and exit (0 = sane)")
    args = ap.parse_args()

    datasets = [d.strip() for d in args.datasets.split(",") if d.strip()]
    if not datasets:
        ap.error("--datasets resolved to an empty list")
    unknown = [d for d in datasets if not any(k[2] == d for k in BASELINE)]
    if unknown:
        ap.error(
            f"dataset(s) {unknown} have no published baseline entry "
            f"(known: {sorted({k[2] for k in BASELINE})}) — a typo'd name "
            "would otherwise produce '----' rows and a vacuous exit 0"
        )
    problems = check_assets(args, datasets)
    if args.check_assets:
        for p in problems:
            print(f"ASSET PROBLEM: {p}")
        print("assets:", "OK" if not problems else f"{len(problems)} problem(s)")
        sys.exit(0 if not problems else 2)
    if problems:
        for p in problems:
            print(f"ASSET PROBLEM: {p}", file=sys.stderr)
        sys.exit(
            "malformed assets — fix the paths above (or run --check-assets "
            "to iterate quickly) before burning an eval pass"
        )

    report = []
    ran = False
    for variant, dec in (("dinov2", args.decoder_v2), ("dinov1", args.decoder_v1)):
        if dec:
            run_stage1(variant, dec, datasets, args, report)
            ran = True
    for variant, dec, ref in (
        ("dinov2", args.decoder_v2, args.refiner_v2),
        ("dinov1", args.decoder_v1, args.refiner_v1),
    ):
        if dec and ref:
            run_coral(variant, dec, ref, datasets, args, report)
            ran = True
    if not ran:
        ap.error("nothing to run: pass at least --decoder-v2 or --decoder-v1")

    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
    print(f"report written to {args.report}")
    failed = [r for r in report if r["pass"] is False]
    compared = [r for r in report if r["pass"] is not None]
    if not compared:
        print("ERROR: no metric was compared against a published value")
        sys.exit(2)  # 'exit 0 iff every compared metric passed' needs >= 1
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
