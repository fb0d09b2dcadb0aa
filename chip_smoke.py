"""On-card smoke test of the UCOD-DPL stage-1 main path.

Runs, in ONE process on one NVIDIA card, the path a user takes with the
DINOv2-base config (``configs/uscod/UCOD-DPL_dinov2.py``) at its full width
(ViT-B/14: 12 layers, 768 wide, 12 heads of 64, bf16) and its own image
sizes, on a seeded synthetic dataset with randomly initialised weights:

  1. env           — JAX, devices, the card's name and power limit, the
                     compile cache, optional packages, native libraries;
  2. attention     — the backbone's attention (cuDNN flash attention) against
                     the plain XLA attention in f32 at the highest matmul
                     precision, forward at two real shapes and the gradient;
  3. backbone      — the bf16 ``dino_forward`` (key features, CLS attention,
                     the decoder's key-fold path) against the same forward in
                     f32 / highest precision;
  4. pseudo_labels — ``ucod-generate-pseudo-label`` on the train images;
  5. train         — a ``Runner`` builds the feature caches on the card, then
                     ``TrainLoop.run`` takes one epoch (3 stage-1 steps at
                     batch 16 + the discriminator pass);
  6. eval          — LookTwice evaluation of the trained decoder;
  7. lora          — one LoRA joint step at 518px through the live backbone;
  8. int8          — one ``Predictor(quantize="int8")`` batch against bf16;
  9. memory        — peak device memory.

Any failed phase exits non-zero.  The last line of standard output is one
JSON object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.

``--four`` runs only the multi-card path, on four cards: the default
data-parallel mesh (``tpu_cfg.mesh = {data: -1}``: cache build, train steps
and eval) against the same run on one card, then tensor-parallel
(``{model: 4}``) and sequence-parallel (``{seq: 4}``) extraction against the
unsharded forward, and each card's peak memory.

Usage (on a machine with the card):

    python chip_smoke.py [--seed 0] [--four]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import struct
import subprocess
import sys
import time
import traceback
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "uscod", "UCOD-DPL_dinov2.py")
WORK = os.path.join(REPO, "work", "chip_smoke")  # work/ is in .gitignore
TRAIN_SET, TEST_SET = "SMOKE-TR", "SMOKE-TE"


class SmokeFailure(RuntimeError):
    """A phase's output broke its stated bound."""


@dataclasses.dataclass(frozen=True)
class Spec:
    """Sizes of one smoke run.  ``FULL`` is what the card runs; the tests
    run the same phases at tiny widths on the CPU."""

    arch: Optional[Dict[str, int]] = None  # None: the config's DINOv2-base
    image_size: Optional[int] = None  # None: the config's 518px
    feature_size: Optional[int] = None  # None: the config's 68
    n_train: int = 48
    n_test: int = 16
    source_hw: Tuple[int, int] = (480, 640)
    batch: int = 16
    attn_shapes: Tuple[Tuple[int, int], ...] = ((16, 1370), (4, 2917))
    heads: int = 12
    head_dim: int = 64
    backbone_batch: int = 2
    pseudo_label_px: int = 224


FULL = Spec()

# bf16 keeps 8 mantissa bits (relative rounding 2**-9 ~ 2e-3 per operation):
# attention rounds its inputs, probabilities and output once each, so its
# norm-relative error sits near 2e-3 — 1e-2 leaves 4x headroom; the gradient
# adds one backward pass of roundings (2e-2).  The backbone compounds 12
# layers of bf16 activations and weights (5e-2).
ATTN_FWD_TOL = 1e-2
ATTN_GRAD_TOL = 2e-2
BACKBONE_TOL = 5e-2
INT8_MASK_AGREEMENT = 0.9  # tests/test_quant.py::test_predictor_int8_smoke
DP_LOSS_RTOL = 1e-2  # one-card vs four-card: same math, other reduction order
DP_METRIC_ATOL = 1e-2
SHARDED_TOL = 2e-2  # TP/SP extraction vs unsharded, bf16


def log(*a) -> None:
    print(*a, flush=True)


def norm_rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# synthetic dataset (PNG written with the standard library: no Pillow needed)
# ---------------------------------------------------------------------------


def write_png(path: str, arr: np.ndarray) -> None:
    """uint8 (H, W) grey or (H, W, 3) RGB -> PNG, with zlib alone."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    color = 2 if arr.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def make_dataset(root: str, spec: Spec, seed: int) -> None:
    """``root/{SMOKE-TR,SMOKE-TE}/{im,gt}``: textured backgrounds with one
    camouflaged blob each (its texture shifted slightly in colour), binary
    masks, sizes jittered around ``spec.source_hw``."""
    rng = np.random.default_rng(seed)
    for name, n in ((TRAIN_SET, spec.n_train), (TEST_SET, spec.n_test)):
        im_dir = os.path.join(root, name, "im")
        gt_dir = os.path.join(root, name, "gt")
        os.makedirs(im_dir)
        os.makedirs(gt_dir)
        for i in range(n):
            h = spec.source_hw[0] + int(rng.integers(-spec.source_hw[0] // 8, spec.source_hw[0] // 8 + 1))
            w = spec.source_hw[1] + int(rng.integers(-spec.source_hw[1] // 8, spec.source_hw[1] // 8 + 1))
            base = rng.integers(60, 190, size=3)
            img = base + rng.normal(0, 25, size=(h, w, 3))
            yy, xx = np.mgrid[:h, :w]
            cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
            ry, rx = rng.uniform(0.1, 0.25) * h, rng.uniform(0.1, 0.25) * w
            blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            img[blob] += rng.normal(0, 12, size=3)
            write_png(os.path.join(im_dir, f"{i:04d}.png"), np.clip(img, 0, 255).astype(np.uint8))
            write_png(os.path.join(gt_dir, f"{i:04d}.png"), blob.astype(np.uint8) * 255)


def smoke_config(root: str, spec: Spec):
    """The shipped stage-1 config with its dataset pointed at ``root``."""
    from ucod_dpl_tpu.config import load_config

    cfg = load_config(CONFIG)
    cfg.mode = "train"
    cfg.seed = 42
    cfg.work_dir = os.path.join(root, "work")
    cfg.log_cfg.log_path = os.path.join(root, "logs")
    dc = cfg.dataset_cfg
    dc.dataset_dir = os.path.join(root, "RefCOD")
    dc.cache_dir = os.path.join(root, "cache")
    dc.trainset_cfg.DATASET = TRAIN_SET
    dc.valset_cfg.DATASET = TEST_SET
    dc.valset_cfg.keep_size = True  # metrics at label resolution, as eval does
    dc.trainloader_cfg.batch_size = spec.batch
    dc.feature_extractor_cfg.backbone_weights = os.path.join(root, "no_weights")
    dc.feature_extractor_cfg.backbone_weight_base = os.path.join(root, "no_weights")
    if spec.arch is not None:
        dc.feature_extractor_cfg.arch = dict(spec.arch)
    if spec.image_size is not None:
        dc.trainset_cfg.image_size = (spec.image_size,) * 2
        dc.valset_cfg.image_size = (spec.image_size,) * 2
    if spec.feature_size is not None:
        cfg.model_cfg.feature_size = spec.feature_size
    cfg.model_cfg.dim = (spec.arch or {}).get("hidden_size", cfg.model_cfg.dim)
    cfg.train_cfg.max_epoch = 1
    cfg.val_cfg.enable_val = False  # eval is its own phase
    return cfg


def dino_config(spec: Spec):
    from ucod_dpl_tpu.models.dino import DinoConfig

    cfg = DinoConfig.dinov2_base()
    return dataclasses.replace(cfg, **spec.arch) if spec.arch else cfg


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env() -> Dict[str, Any]:
    import jax

    log(f"jax {jax.__version__} devices {jax.devices()}")
    import ucod_dpl_tpu
    from ucod_dpl_tpu import device
    from ucod_dpl_tpu.utils import native

    log(f"card: {device.card_name_and_power_limit()}")

    pkg = os.path.dirname(os.path.abspath(ucod_dpl_tpu.__file__))
    _check(
        pkg == os.path.join(REPO, "ucod_dpl_tpu"),
        f"ucod_dpl_tpu imported from {pkg}, not from this checkout",
    )
    device.enable_compilation_cache()
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    for mod in ("PIL", "yaml", "safetensors"):
        try:
            __import__(mod)
            log(f"optional package {mod}: present")
        except ImportError:
            log(f"optional package {mod}: absent")
    built = {
        "cclabel": native.get_lib() is not None,
        "metrics": native.get_metrics_lib() is not None,
        "imagepipe": native.get_imagepipe_lib() is not None,
    }
    log(f"native libraries built: {built}")
    log("image decode route: " + (
        "native imagepipe" if built["imagepipe"] else "Pillow (native imagepipe not built)"
    ))
    dev = jax.devices()[0]
    _check(dev.platform == "gpu", f"no GPU: JAX's first device is {dev} ({dev.platform})")
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


def phase_attention(spec: Spec) -> None:
    import jax
    import jax.numpy as jnp

    from ucod_dpl_tpu.device import attention_implementation
    from ucod_dpl_tpu.ops.attention import _xla_attention, multi_head_attention

    nh, hd = spec.heads, spec.head_dim
    scale = 1.0 / np.sqrt(hd)
    log(f"attention implementation (bf16, head {hd}): {attention_implementation(jnp.bfloat16, hd)}")

    def ref_attention(q, k, v):  # f32 XLA reference on the per-head layout
        b, l, d = q.shape
        split = lambda x: x.reshape(b, l, nh, hd).transpose(0, 2, 1, 3).reshape(b * nh, l, hd)  # noqa: E731
        o = _xla_attention(split(q), split(k), split(v), scale)
        return o.reshape(b, nh, l, hd).transpose(0, 2, 1, 3).reshape(b, l, d)

    rng = np.random.default_rng(1)
    for i, (b, l) in enumerate(spec.attn_shapes):
        q, k, v = (
            jnp.asarray(rng.standard_normal((b, l, nh * hd)), jnp.bfloat16) for _ in range(3)
        )
        got = np.asarray(
            jax.jit(lambda q, k, v: multi_head_attention(q, k, v, nh, scale=scale))(q, k, v),
            np.float32,
        )
        with jax.default_matmul_precision("highest"):
            f32 = tuple(x.astype(jnp.float32) for x in (q, k, v))
            ref = np.asarray(jax.jit(ref_attention)(*f32))
        err, mx = norm_rel(got, ref), float(np.max(np.abs(got - ref)))
        log(f"attention fwd bs{b} L={l}: max_abs {mx:.4g} norm_rel {err:.4g} (tol {ATTN_FWD_TOL})")
        _check(np.isfinite(got).all() and err < ATTN_FWD_TOL, f"attention forward bs{b} L={l}: {err}")
        if i:
            continue
        cot = jnp.asarray(rng.standard_normal((b, l, nh * hd)), jnp.float32)

        def loss(f, q, k, v):
            return jnp.sum(f(q, k, v).astype(jnp.float32) * cot)

        g = jax.jit(jax.grad(
            lambda q, k, v: loss(lambda *a: multi_head_attention(*a, nh, scale=scale), q, k, v),
            argnums=(0, 1, 2),
        ))(q, k, v)
        with jax.default_matmul_precision("highest"):
            g_ref = jax.jit(jax.grad(lambda q, k, v: loss(ref_attention, q, k, v), argnums=(0, 1, 2)))(*f32)
        g = np.concatenate([np.asarray(x, np.float32).ravel() for x in g])
        g_ref = np.concatenate([np.asarray(x).ravel() for x in g_ref])
        err, mx = norm_rel(g, g_ref), float(np.max(np.abs(g - g_ref)))
        log(f"attention grad bs{b} L={l}: max_abs {mx:.4g} norm_rel {err:.4g} (tol {ATTN_GRAD_TOL})")
        _check(np.isfinite(g).all() and err < ATTN_GRAD_TOL, f"attention gradient: {err}")


def phase_backbone(spec: Spec, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from ucod_dpl_tpu.models.dba import fg_logits_live, init_rev_decoder
    from ucod_dpl_tpu.models.dino import dino_forward, init_dino

    cfg = dino_config(spec)
    px = spec.image_size or 518
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = init_dino(k1, cfg)
    decoder = init_rev_decoder(k2, cfg.hidden_size)
    pixels = jnp.asarray(
        np.random.default_rng(seed).standard_normal((spec.backbone_batch, px, px, 3)), jnp.float32
    )

    def run(dtype):
        out = jax.jit(lambda p, x: dino_forward(p, x, cfg, want_cls_attention=True, compute_dtype=dtype))(
            params, pixels
        )
        fg, _, _ = jax.jit(
            lambda p, d, x: fg_logits_live(p, d, x, cfg, compute_dtype=dtype, size=spec.feature_size or 68)
        )(params, decoder, pixels)
        return {
            "key_features": np.asarray(out["key_features"], np.float32),
            "cls_attention": np.asarray(out["cls_attention"], np.float32),
            "key_fold_logits": np.asarray(fg, np.float32),
        }

    got = run(jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        ref = run(jnp.float32)
    for name in got:
        err = norm_rel(got[name], ref[name])
        log(f"backbone {name} {got[name].shape}: norm_rel {err:.4g} vs f32 (tol {BACKBONE_TOL})")
        _check(np.isfinite(got[name]).all(), f"backbone {name}: non-finite")
        _check(err < BACKBONE_TOL, f"backbone {name}: norm_rel {err}")


def phase_pseudo_labels(spec: Spec, root: str) -> None:
    from ucod_dpl_tpu.cli import generate_pseudo_label_main
    from ucod_dpl_tpu.utils.fileio import ArrayCache

    cache_root = os.path.join(root, "cache", "pseudo_label_cache")
    generate_pseudo_label_main([
        "--dataset", TRAIN_SET,
        "--image_path", os.path.join(root, "RefCOD", "{}", "im"),
        "--cache_path", cache_root + os.sep,
        "--backbone_weights", os.path.join(root, "no_weights"),
        "--batch_size", str(spec.batch),
        "--image_size", str(spec.pseudo_label_px),
    ])
    cache = ArrayCache(os.path.join(cache_root, TRAIN_SET))
    _check(len(cache) == spec.n_train, f"{len(cache)} pseudo-labels for {spec.n_train} images")
    labels = np.stack([cache.read(i) for i in range(len(cache))])
    _check(np.isfinite(labels).all() and labels.min() >= 0 and labels.max() <= 1, "pseudo-labels out of [0, 1]")
    log(f"pseudo-labels {labels.shape}: foreground share {labels.mean():.4f}")


def phase_train(spec: Spec, root: str):
    from ucod_dpl_tpu.engine import Runner
    from ucod_dpl_tpu.engine.train_loop import TrainLoop

    cfg = smoke_config(root, spec)
    t0 = time.perf_counter()
    runner = Runner(cfg, mode="train")
    log(
        f"feature caches built in {time.perf_counter() - t0:.1f}s "
        f"({len(runner.train_dataset)} train + {len(runner.val_dataset)} test images, "
        f"compute dtype {runner.feature_extractor.compute_dtype.__name__}, "
        f"mesh {dict(runner.mesh.shape)})"
    )
    loop = TrainLoop(cfg, runner)
    losses = []
    step = loop._train_step

    def recording_step(*args):
        state, aux = step(*args)
        losses.append(aux["loss"])
        return state, aux

    loop._train_step = recording_step
    t0 = time.perf_counter()
    loop.run()
    losses = [float(x) for x in losses]
    log(f"stage-1 train: {len(losses)} steps at batch {spec.batch} in {time.perf_counter() - t0:.1f}s, losses {losses}")
    _check(len(losses) >= 3, f"only {len(losses)} train steps")
    _check(all(np.isfinite(losses)), f"non-finite train loss: {losses}")
    return runner, losses


def phase_eval(runner) -> Dict[str, float]:
    t0 = time.perf_counter()
    result = runner.launch_val_look_twice()
    row = {k: round(float(v), 6) for k, v in result.items()}
    log(f"LookTwice eval on {TEST_SET} ({time.perf_counter() - t0:.1f}s): {row}")
    _check(all(np.isfinite(list(result.values()))), f"non-finite metric row {row}")
    return row


def phase_lora(spec: Spec, root: str) -> None:
    import jax
    import jax.numpy as jnp

    from ucod_dpl_tpu.engine import Runner
    from ucod_dpl_tpu.engine.train_loop import TrainLoop

    cfg = smoke_config(root, spec)
    cfg.model_cfg.lora.enable = True
    runner = Runner(cfg, mode="train")
    loop = TrainLoop(cfg, runner)
    batch = next(iter(runner.train_dataloader))
    _, plabels = loop._device_batch(batch, need_features=False)
    pixels = loop._device_pixels(batch)
    t0 = time.perf_counter()
    _, lora_params, _, aux = loop._lora_step(
        loop.state, loop.lora_params, loop.lora_opt_state,
        runner.feature_extractor.params, pixels, plabels,
        jnp.float32(0.0), jnp.float32(1.0),
    )
    loss, gnorm = float(aux["loss"]), float(aux["lora_grad_norm"])
    b_norm = float(sum(
        jnp.linalg.norm(entry[t]["b"]) for entry in lora_params for t in ("q", "k", "v")
    ))
    log(
        f"LoRA joint step at {pixels.shape[1]}px, batch {pixels.shape[0]} "
        f"({time.perf_counter() - t0:.1f}s incl. compile): loss {loss:.6g}, "
        f"adapter grad norm {gnorm:.6g}, adapter B-norm {b_norm:.6g}"
    )
    _check(np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0, "LoRA gradients not finite and non-zero")
    _check(b_norm > 0, "LoRA adapters did not move")
    leaves = jax.tree.leaves(lora_params)
    _check(all(bool(jnp.isfinite(x).all()) for x in leaves), "non-finite adapters")


def phase_int8(spec: Spec, runner, root: str) -> None:
    from ucod_dpl_tpu.serving import Predictor
    from ucod_dpl_tpu.utils.fileio import ImageIO

    cfg = runner.cfg
    kw = dict(
        image_size=tuple(cfg.dataset_cfg.valset_cfg.image_size),
        feature_size=cfg.model_cfg.feature_size,
        max_batch=spec.batch,
    )
    paths = ImageIO.list_dir_image(os.path.join(root, "RefCOD", TEST_SET, "im"))[: spec.batch]
    fe = runner.feature_extractor
    bf16 = Predictor(fe, runner.decoder_params, **kw)
    int8 = Predictor(fe, runner.decoder_params, quantize="int8", **kw)
    p16 = np.stack(bf16.predict(paths, soft=True))
    p8 = np.stack(int8.predict(paths, soft=True))
    agree = float(np.mean((p16 > 0.5) == (p8 > 0.5)))
    corr = float(np.corrcoef(p16.ravel(), p8.ravel())[0, 1]) if p16.std() > 0 and p8.std() > 0 else float("nan")
    log(
        f"int8 Predictor batch of {len(paths)} vs bf16: mask agreement {agree:.4f} "
        f"(bound > {INT8_MASK_AGREEMENT}), probability correlation {corr:.4f}"
    )
    _check(np.isfinite(p8).all(), "int8 predictor: non-finite probabilities")
    _check(agree > INT8_MASK_AGREEMENT, f"int8 mask agreement {agree}")


def phase_memory() -> None:
    import jax

    for d in jax.devices():
        stats = d.memory_stats() or {}
        log(f"peak_bytes_in_use {d}: {stats.get('peak_bytes_in_use')}")


# ---------------------------------------------------------------------------
# four-card path
# ---------------------------------------------------------------------------


def run_dp_path(spec: Spec, root: str, seed: int) -> Dict[str, Any]:
    """Cache build, train steps and LookTwice eval on the config's default
    mesh (every visible card on ``data``).  Returns what the one-card and
    four-card runs are compared on."""
    shutil.rmtree(root, ignore_errors=True)
    make_dataset(os.path.join(root, "RefCOD"), spec, seed)
    phase_pseudo_labels(spec, root)
    runner, losses = phase_train(spec, root)
    row = phase_eval(runner)
    feats = np.stack([runner.train_dataset.caches.get("features").read(i) for i in range(2)])
    return {"losses": losses, "metrics": row, "features": feats.astype(np.float32).tolist()}


def dp_reference_main(out_path: str, seed: int, spec_json: str) -> None:
    """The one-card side of ``--four``, run in a child that sees one card."""
    import jax

    from ucod_dpl_tpu import device

    device.enable_compilation_cache()
    _check(len(jax.devices()) == 1, f"reference run sees {jax.devices()}")
    spec = Spec(**json.loads(spec_json))
    res = run_dp_path(spec, os.path.join(WORK, "dp1"), seed)
    with open(out_path, "w") as f:
        json.dump(res, f)


def run_reference_child(seed: int, spec: Spec) -> Dict[str, Any]:
    """Runs :func:`dp_reference_main` in a child process that sees one
    device, BEFORE this process initialises JAX (a JAX process reserves most
    of a card's memory, so the two never hold the cards at once)."""
    os.makedirs(WORK, exist_ok=True)
    out = os.path.join(WORK, "dp1.json")
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split() if "device_count" not in f]
    env = dict(
        os.environ, CUDA_VISIBLE_DEVICES="0",
        XLA_FLAGS=" ".join(flags + ["--xla_force_host_platform_device_count=1"]),
    )
    code = (
        f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
        f"chip_smoke.dp_reference_main({out!r}, {seed}, {json.dumps(dataclasses.asdict(spec))!r})"
    )
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
    log(f"one-card reference run done in {time.perf_counter() - t0:.1f}s")
    with open(out) as f:
        return json.load(f)


def compare_four(seed: int, spec: Spec, ref: Dict[str, Any]) -> None:
    """The four-card side: the DP run against the one-card reference, then
    TP and SP extraction against the unsharded forward."""
    import jax

    n = len(jax.devices())
    _check(n == 4, f"the four-card path needs 4 devices, JAX sees {n}")
    log("== dp: the default mesh over four cards ==")
    got = run_dp_path(spec, os.path.join(WORK, "dp4"), seed)
    f_err = norm_rel(got["features"], ref["features"])
    l_err = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got["losses"], ref["losses"]))
    m_err = max(abs(got["metrics"][k] - ref["metrics"][k]) for k in ref["metrics"])
    log(
        f"dp four cards vs one: cached features norm_rel {f_err:.4g} (tol {SHARDED_TOL}), "
        f"losses max rel {l_err:.4g} (tol {DP_LOSS_RTOL}), metrics max abs {m_err:.4g} "
        f"(tol {DP_METRIC_ATOL}); one-card losses {ref['losses']} four-card {got['losses']}"
    )
    _check(len(got["losses"]) == len(ref["losses"]), "step counts differ")
    _check(f_err < SHARDED_TOL and l_err < DP_LOSS_RTOL and m_err < DP_METRIC_ATOL,
           "the four-card run disagrees with one card")

    log("== tp {model: 4} and sp {seq: 4} extraction vs unsharded ==")
    from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu.parallel import build_mesh

    fe_cfg = smoke_config(os.path.join(WORK, "tp_sp"), spec).dataset_cfg.feature_extractor_cfg
    px = spec.image_size or 518
    pixels = np.random.default_rng(seed).standard_normal((4, px, px, 3)).astype(np.float32)
    plain = FeatureExtractor(fe_cfg, seed=seed).extract(pixels)
    for axes in ({"data": 1, "model": 4}, {"data": 1, "seq": 4}):
        fe = FeatureExtractor(fe_cfg, seed=seed, mesh=build_mesh(axes))
        err = norm_rel(fe.extract(pixels), plain)
        log(f"extraction over {axes} vs unsharded: norm_rel {err:.4g} (tol {SHARDED_TOL})")
        _check(err < SHARDED_TOL, f"{axes} extraction disagrees: {err}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="On-card smoke test of the stage-1 main path.")
    ap.add_argument("--seed", type=int, default=0, help="seed of the synthetic data and weights")
    ap.add_argument("--four", action="store_true", help="run only the four-card path")
    args = ap.parse_args(argv)

    phase = "env"
    try:
        if args.four:
            phase = "four"
            log("== dp reference: the same run on one card ==")
            ref = run_reference_child(args.seed, FULL)
            log("== env ==")
            info = phase_env()
            compare_four(args.seed, FULL, ref)
            phase_memory()
        else:
            log("== env ==")
            info = phase_env()
            shutil.rmtree(WORK, ignore_errors=True)
            root = os.path.join(WORK, "one")
            make_dataset(os.path.join(root, "RefCOD"), FULL, args.seed)
            log(f"synthetic dataset: {FULL.n_train} train + {FULL.n_test} test PNGs under {root}")
            steps = [
                ("attention", lambda: phase_attention(FULL)),
                ("backbone", lambda: phase_backbone(FULL, args.seed)),
                ("pseudo_labels", lambda: phase_pseudo_labels(FULL, root)),
                ("train", lambda: phase_train(FULL, root)),
            ]
            runner = None
            for phase, fn in steps:
                log(f"== {phase} ==")
                t0 = time.perf_counter()
                out = fn()
                if phase == "train":
                    runner = out[0]
                log(f"-- {phase} ok ({time.perf_counter() - t0:.1f}s)")
            for phase, fn in (
                ("eval", lambda: phase_eval(runner)),
                ("lora", lambda: phase_lora(FULL, root)),
                ("int8", lambda: phase_int8(FULL, runner, root)),
                ("memory", phase_memory),
            ):
                log(f"== {phase} ==")
                t0 = time.perf_counter()
                fn()
                log(f"-- {phase} ok ({time.perf_counter() - t0:.1f}s)")
    except Exception:  # noqa: BLE001 — report which phase failed, then fail
        traceback.print_exc()
        log(f"phase {phase} FAILED")
        return 1
    from ucod_dpl_tpu.device import card_name_and_power_limit

    log(f"card: {card_name_and_power_limit()}")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
