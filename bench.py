"""Benchmark of the framework's hot paths on one NVIDIA card.

Headline: 518px live-inference eval throughput (img/s) — DINOv2-base ViT
forward in bf16 with the decoder's decoupling key-folded into the last key
projection (``models/dba.py::fg_logits_live``), decoder body, mask upsample
+ threshold: what serving and the LookTwice crop pass execute per image.

Extras (``metrics``): the 756px feature-cache build (img/s), the stage-1
train step (ms/step), the LoRA joint train step (ms/step), the opt-in int8
W8A8 eval (img/s) and an int8-vs-bf16 matmul chain at ViT MLP shapes.

Each time is the median of block_until_ready-synchronised calls after a
compile/warm-up call.  Utilisation figures divide by the card's data-sheet
peaks (``PEAKS``, keyed by ``device_kind``; an unknown device is an error),
and the card's power limit is recorded beside them: a card set below 700 W
cannot hold its top clock under load.

Prints ONE JSON line.  Without a GPU it refuses to run;
``--cpu-rehearsal`` runs every path at tiny widths on the CPU to check the
wiring and prints ``platform: cpu`` with no device metric.

    python bench.py [--cpu-rehearsal]
"""

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# NVIDIA H100 SXM data sheet: dense rates (no sparsity) at the 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "int8_tops": 1979.0, "hbm_tb_s": 3.35},
}

EXTRA_NAMES = (
    "756px feature-cache build",
    "stage-1 train step",
    "LoRA joint train step",
    "int8 W8A8 backbone",
    "int8 raw matmul chain",
)


def peak(device_kind: str) -> dict:
    """Data-sheet peak rates of ``device_kind``; raises for a device the
    table does not list (a utilisation against a guessed peak is wrong)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no data-sheet peaks for device {device_kind!r}; add its row to bench.PEAKS"
        ) from None


def _analytic_backbone_flops_per_img(
    cfg, img: int, key_fold_dim: int | None = None
) -> float:
    """Analytic FLOPs (mul+add = 2) of one ViT forward at ``img`` px:
    per layer 24*N*D^2 (qkv/proj/mlp matmuls) + 4*N^2*D (scores + p@v),
    plus the patch embed.

    ``key_fold_dim``: the live-eval composition key-folds the LAST layer
    down to ``LN1(x) @ (D, F)`` (models/dino.py::dino_forward) — its q/v
    projections, attention, MLP and final norm never run, so counting a
    full layer would inflate the utilisation by ~8%.  Decoder/upsample
    FLOPs are excluded (<1%): a slight undercount."""
    n = (img // cfg.patch_size) ** 2 + 1
    d = cfg.hidden_size
    per_layer = 24 * n * d * d + 4 * n * n * d
    patch_embed = 2 * n * (cfg.patch_size**2 * 3) * d
    total = float(cfg.num_layers * per_layer + patch_embed)
    if key_fold_dim is not None:
        total = total - per_layer + 2.0 * n * d * key_fold_dim
    return total


def _analytic_lora_joint_flops_per_img(cfg, img: int) -> float:
    """Model FLOPs of one LoRA joint train step per image: the unfolded
    backbone forward plus the backward the adaptation requires — dx through
    every linear (the base weights are frozen: no dW) and the attention
    backward (2x its forward matmuls).  Adapter dW, decoder and optimizer
    (<1%) are excluded; recompute is not model work and is not counted."""
    n = (img // cfg.patch_size) ** 2 + 1
    d = cfg.hidden_size
    lin = 24 * n * d * d
    attn = 4 * n * n * d
    patch_embed = 2 * n * (cfg.patch_size**2 * 3) * d
    fwd = cfg.num_layers * (lin + attn) + patch_embed
    bwd = cfg.num_layers * (lin + 2 * attn)
    return float(fwd + bwd)


def _median_ms(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def measure(rehearsal: bool) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ucod_dpl_tpu.config import CfgNode
    from ucod_dpl_tpu.device import (
        card_name_and_power_limit,
        default_compute_dtype,
        enable_compilation_cache,
    )
    from ucod_dpl_tpu.engine.train_step import (
        TrainState,
        make_lora_train_step,
        make_optimizer,
        make_train_step,
    )
    from ucod_dpl_tpu.models import init_discriminator
    from ucod_dpl_tpu.models.dba import fg_logits_live, init_rev_decoder
    from ucod_dpl_tpu.models.dino import DinoConfig, dino_forward, init_dino
    from ucod_dpl_tpu.models.lora import init_lora
    from ucod_dpl_tpu.ops.quant import dense_w8a8, quantize_dino_linears, quantize_linear
    from ucod_dpl_tpu.ops.resize import interpolate_bilinear_nhwc

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not rehearsal:
        raise SystemExit(f"bench.py needs a GPU (JAX's first device is {dev}); "
                         "--cpu-rehearsal checks the wiring on the CPU")
    cfg = DinoConfig.dinov2_base()
    if rehearsal:
        cfg = dataclasses.replace(cfg, num_layers=2)
    dtype = default_compute_dtype()
    rng = np.random.default_rng(0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    backbone = init_dino(k1, cfg)
    decoder = init_rev_decoder(k2, cfg.hidden_size)
    reps = 2 if rehearsal else 20

    def small(full, tiny):
        return tiny if rehearsal else full

    results = {}

    # ---- headline: 518px live eval ---------------------------------------
    batch, img = small(32, 2), 518

    @jax.jit
    def eval_step(bb, dec, pixels):
        fg, _, _ = fg_logits_live(bb, dec, pixels, cfg, compute_dtype=dtype, size=68)
        up = interpolate_bilinear_nhwc(fg, (img, img))[..., 0]
        return jnp.sum((jax.nn.sigmoid(up) > 0.5).astype(jnp.int32)), jnp.all(jnp.isfinite(fg))

    pixels = jnp.asarray(rng.standard_normal((batch, img, img, 3)), jnp.float32)
    _, finite = eval_step(backbone, decoder, pixels)
    if not bool(finite):
        raise FloatingPointError("non-finite decoder logits: refusing to time a broken forward")
    ms = _median_ms(lambda: eval_step(backbone, decoder, pixels), reps)
    results["headline"] = (batch * 1e3 / ms, _analytic_backbone_flops_per_img(cfg, img, 128), "bf16")

    # ---- 756px feature-cache build ---------------------------------------
    cb_batch, cb_img = small(8, 2), small(756, 126)
    cb_pixels = jnp.asarray(rng.standard_normal((cb_batch, cb_img, cb_img, 3)), jnp.float32)
    cache_fwd = jax.jit(lambda p, x: dino_forward(p, x, cfg, compute_dtype=dtype)["key_features"])
    ms = _median_ms(lambda: cache_fwd(backbone, cb_pixels), reps)
    results[EXTRA_NAMES[0]] = (cb_batch * 1e3 / ms, _analytic_backbone_flops_per_img(cfg, cb_img), "bf16")

    # ---- stage-1 train step (cached features, shipped config shapes) -----
    tcfg = CfgNode({
        "model_cfg": {"dim": cfg.hidden_size, "feature_size": 68, "ema_weight": 0.99,
                      "dis_use_features": False,
                      "lora": {"rank": 2, "alpha": 4.0, "remat": "none"}},
        "train_cfg": {"max_epoch": 25, "start_finetune": -5, "merge_method": "dis",
                      "lr0": 2e-4, "dis_lr0": 1e-3, "step_lr_gamma": 0.95, "step_lr_size": 25},
        "log_cfg": {"log_interval": 50},
    })
    optimizer = make_optimizer(2e-4, 0.95, 25)
    dis_optimizer = make_optimizer(1e-3, 0.95, 25)
    k3, k4, k5 = jax.random.split(jax.random.PRNGKey(7), 3)
    dec0, ema0 = init_rev_decoder(k3, cfg.hidden_size), init_rev_decoder(k4, cfg.hidden_size)
    dis_p, dis_s = init_discriminator(k5, feature_size=68, use_features=False)
    state = TrainState(
        decoder=dec0, decoder_ema=ema0, opt_state=optimizer.init(dec0),
        dis_params=dis_p, dis_stats=dis_s, dis_opt_state=dis_optimizer.init(dis_p),
        ema_step=jnp.zeros((), jnp.int32),
    )
    tr_batch = small(16, 2)
    feats = jnp.asarray(rng.standard_normal((tr_batch, 37, 37, cfg.hidden_size)), jnp.float32)
    plabels = jnp.asarray(rng.random((tr_batch, 37, 37, 1)) > 0.5, jnp.float32)
    step = jax.jit(make_train_step(tcfg, optimizer))
    ms = _median_ms(lambda: step(state, feats, plabels, jnp.float32(1.0), jnp.float32(1.0)), reps)
    results[EXTRA_NAMES[1]] = (ms, None, None)

    # ---- LoRA joint train step (live 518px backbone) ---------------------
    lora_opt = make_optimizer(1e-4, 0.95, 25)
    lora = init_lora(jax.random.PRNGKey(9), backbone, rank=2)
    lora_state = lora_opt.init(lora)
    lstep = jax.jit(make_lora_train_step(tcfg, optimizer, lora_opt, cfg, dtype))
    lr_batch, lr_img = small(16, 2), small(518, 126)
    lpixels = jnp.asarray(rng.standard_normal((lr_batch, lr_img, lr_img, 3)), jnp.float32)
    ms = _median_ms(
        lambda: lstep(state, lora, lora_state, backbone, lpixels, plabels[:lr_batch],
                      jnp.float32(1.0), jnp.float32(1.0)),
        reps,
    )
    results[EXTRA_NAMES[2]] = (ms, lr_batch * _analytic_lora_joint_flops_per_img(cfg, lr_img), "bf16")

    # ---- int8 W8A8 eval ---------------------------------------------------
    qparams = jax.jit(quantize_dino_linears)(backbone)

    @jax.jit
    def int8_step(bb, qp, dec, px):
        fg, _, _ = fg_logits_live(bb, dec, px, cfg, compute_dtype=dtype, size=68, quant=qp)
        up = interpolate_bilinear_nhwc(fg, (img, img))[..., 0]
        return jnp.sum((jax.nn.sigmoid(up) > 0.5).astype(jnp.int32))

    ms = _median_ms(lambda: int8_step(backbone, qparams, decoder, pixels), reps)
    results[EXTRA_NAMES[3]] = (batch * 1e3 / ms, _analytic_backbone_flops_per_img(cfg, img, 128), "int8")

    # ---- int8 vs bf16 matmul chain at ViT MLP shapes ---------------------
    n_tok = small(16 * 1370, 512)
    x0 = jnp.asarray(rng.standard_normal((n_tok, 768)), dtype)
    w1 = {"w": jnp.asarray(rng.standard_normal((768, 3072)) * 0.02, jnp.float32),
          "b": jnp.zeros((3072,), jnp.float32)}
    w2 = {"w": jnp.asarray(rng.standard_normal((3072, 768)) * 0.02, jnp.float32),
          "b": jnp.zeros((768,), jnp.float32)}
    q1, q2 = quantize_linear(w1), quantize_linear(w2)
    chain_bf16 = jax.jit(lambda x: jnp.dot(jnp.dot(x, w1["w"].astype(dtype)), w2["w"].astype(dtype)))
    chain_int8 = jax.jit(lambda x: dense_w8a8(dense_w8a8(x, q1, dtype), q2, dtype))
    ms_bf16 = _median_ms(lambda: chain_bf16(x0), reps)
    ms_int8 = _median_ms(lambda: chain_int8(x0), reps)
    results[EXTRA_NAMES[4]] = (ms_bf16 / ms_int8, None, None)

    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    out = {
        "metric": "images/sec at 518px eval (dinov2-base + DBA decoder, bf16)",
        "unit": "img/s",
        "device": device,
        "metrics": [],
    }
    units = {EXTRA_NAMES[0]: "img/s", EXTRA_NAMES[1]: "ms/step", EXTRA_NAMES[2]: "ms/step",
             EXTRA_NAMES[3]: "img/s", EXTRA_NAMES[4]: "x speedup"}
    if rehearsal:  # wiring check only: no number is a device metric
        out["value"] = None
        out["metrics"] = [{"metric": n, "unit": units[n], "value": None} for n in EXTRA_NAMES]
        return out

    pk = peak(dev.device_kind)
    out["power_limit"] = card_name_and_power_limit()
    out["peaks"] = pk

    def util(rate_per_s, flops, kind):
        p = pk["int8_tops"] if kind == "int8" else pk["bf16_tflops"]
        return rate_per_s * flops / (p * 1e12)

    value, flops, kind = results["headline"]
    out["value"] = value
    out["flops_per_img"] = flops
    out["mfu_vs_bf16_peak"] = util(value, flops, kind)
    for name in EXTRA_NAMES:
        value, flops, kind = results[name]
        entry = {"metric": name, "unit": units[name], "value": value}
        if flops is not None and units[name] == "img/s":
            entry["util_vs_peak"] = util(value, flops, kind)
        elif flops is not None:  # ms/step with model FLOPs per step
            entry["mfu_vs_bf16_peak"] = util(1e3 / value, flops, kind)
        out["metrics"].append(entry)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Hot-path benchmark on one NVIDIA card.")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny widths on the CPU: checks wiring, reports no device metric")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.cpu_rehearsal)))


if __name__ == "__main__":
    main()
