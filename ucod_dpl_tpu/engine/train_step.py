"""Pure jitted training steps for UCOD-DPL stage 1.

Rebuilds the reference training algorithm (``engine/runner/loop_UCOD_DPL.py``)
as two jitted SPMD functions over an explicit :class:`TrainState`:

  * :func:`make_train_step` — teacher(EMA) forward, student forward with
    orthogonality loss, APM pseudo-label merge via the discriminator
    (``merge_pseudo_label``, loop:257-272), BCE-with-logits losses
    (loop:164-173), AdamW update with the per-batch StepLR schedule
    (loop:179), EMA teacher update with the alpha ramp (loop:186-191);
  * :func:`make_discriminator_step` — the discriminator inter-training epoch
    body (``Discriminator_epoch``, loop:230-255).

Reference quirks kept deliberately (documented for parity):
  * the adversarial term enters the decoder loss through *binarised* student
    masks, so it carries no gradient — it only shifts the reported loss;
  * ``global_step`` advances twice per batch (loop:143 + loop:182), which is
    what the EMA alpha ramp sees, and resets at the finetune switch;
  * the LR scheduler steps once per *batch*, so lr = lr0 * gamma^(batch//25).

Fixed vs the reference (SURVEY §2.4): gradients are actually synchronised
across data-parallel devices — GSPMD inserts the psum that the reference's
post-``prepare`` ``.module`` unwrap silently bypassed (runner.py:368-369).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from ucod_dpl_tpu.models.dba import RevDecoderParams, rev_decoder_forward
from ucod_dpl_tpu.models.discriminator import discriminator_forward
from ucod_dpl_tpu.ops import interpolate_bilinear


class TrainState(NamedTuple):
    decoder: RevDecoderParams
    decoder_ema: RevDecoderParams
    opt_state: Any
    dis_params: Dict[str, Any]
    dis_stats: Dict[str, Any]
    dis_opt_state: Any
    ema_step: jnp.ndarray  # the reference's double-incrementing global_step


def make_optimizer(lr0: float, gamma: float, step_size: int) -> optax.GradientTransformation:
    """AdamW (torch defaults) with the reference's per-batch StepLR decay."""

    def schedule(count):
        return lr0 * gamma ** (count // step_size)

    return optax.adamw(
        learning_rate=schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01
    )


def bce_with_logits(logits: jnp.ndarray, targets: jnp.ndarray) -> jnp.ndarray:
    """Mean BCEWithLogitsLoss (numerically stable)."""
    x, z = logits, targets
    return jnp.mean(jnp.maximum(x, 0) - x * z + jnp.log1p(jnp.exp(-jnp.abs(x))))


def bce_probs(probs: jnp.ndarray, targets: jnp.ndarray) -> jnp.ndarray:
    """Mean BCELoss on probabilities, log clamped at -100 like torch."""
    logp = jnp.maximum(jnp.log(probs), -100.0)
    log1mp = jnp.maximum(jnp.log1p(-probs), -100.0)
    return -jnp.mean(targets * logp + (1.0 - targets) * log1mp)


def _to_feature_size(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """(B, h, w, c) -> (B, size, size, c) bilinear (loop:152-154)."""
    return interpolate_bilinear(jnp.transpose(x, (0, 3, 1, 2)), (size, size)).transpose(
        0, 2, 3, 1
    )


def _stage1_decoder_loss(
    dec_params,
    state: TrainState,
    f: jnp.ndarray,  # (B, fs, fs, C) features at feature_size
    pl: jnp.ndarray,  # (B, fs, fs, 1) pseudo-labels at feature_size
    teacher_bin: jnp.ndarray,
    epoch: jnp.ndarray,
    adv_coeff: jnp.ndarray,
    use_dis_merge: bool,
    denom: float,
    f_apm: jnp.ndarray = None,
):
    """The stage-1 student loss (loop:164-173 + merge_pseudo_label
    loop:257-272) — shared between the cached-feature step and the
    live-backbone LoRA step.

    ``f_apm``: features fed to the discriminator/APM (defaults to ``f``).
    The LoRA step passes stop_gradient(f) here — the APM merge produces the
    training TARGET, and a target must not backpropagate into the live
    backbone (with cached features, as in the reference, no gradient can
    flow there anyway)."""
    if f_apm is None:
        f_apm = f
    fg, bg_rev, ortho = rev_decoder_forward(dec_params, f, with_loss=True)

    if use_dis_merge:
        # APM: discriminator-scored blend of fixed pseudo-labels and
        # teacher predictions (merge_pseudo_label, loop:257-272).
        student_bin = jax.lax.stop_gradient(
            (jax.nn.sigmoid(fg) > 0.5).astype(jnp.float32)
        )
        p_s, _ = discriminator_forward(
            state.dis_params, state.dis_stats, student_bin, f_apm
        )
        p_p, _ = discriminator_forward(
            state.dis_params, state.dis_stats, (pl > 0.5).astype(jnp.float32), f_apm
        )
        w = 0.5 * (1.0 + jnp.cos(jnp.abs(p_s - p_p) * jnp.pi)) + epoch / denom
        w = jnp.clip(w, 0.0, 1.0)[:, :, None, None]  # (B,1,1,1)
        merged = pl * (1.0 - w) + teacher_bin * w
        dis_loss = bce_probs(p_s, jnp.zeros_like(p_s))
    else:
        merged = pl
        dis_loss = jnp.float32(0.0)
        w = jnp.zeros((1, 1, 1, 1))
        p_s = p_p = jnp.zeros((1, 1))

    loss = bce_with_logits(fg, merged)
    # adversarial term: gradient-free through the binarisation, kept
    # for loss parity with the reference (loop:167-169)
    loss = loss - adv_coeff * dis_loss
    loss = loss + bce_with_logits(bg_rev, 1.0 - merged)
    loss = loss + ortho
    aux = {
        "dis_loss": dis_loss,
        "ortho_loss": ortho,
        "merge_weight": jnp.mean(w),
        "p_s": jnp.mean(p_s),
        "p_p": jnp.mean(p_p),
    }
    return loss, aux


def make_train_step(cfg, optimizer: optax.GradientTransformation):
    """Build the jitted stage-1 train step."""
    feature_size = cfg.model_cfg.feature_size
    ema_weight = cfg.model_cfg.ema_weight
    use_dis_merge = cfg.train_cfg.get("merge_method", "dis") == "dis"
    denom = cfg.train_cfg.max_epoch + cfg.train_cfg.get("start_finetune", -5)
    if denom == 0:
        # the APM merge weight divides by this; denom == 0 makes epoch/denom
        # = 0/0 = NaN at epoch 0 and silently NaN-poisons every parameter
        # from the first step — fail fast instead (negative denom is a
        # clipped ramp and stays finite)
        raise ValueError(
            f"train_cfg.max_epoch ({cfg.train_cfg.max_epoch}) + start_finetune "
            f"({cfg.train_cfg.get('start_finetune', -5)}) must be nonzero (the "
            "APM merge ramp divides by it); adjust max_epoch or start_finetune"
        )

    def step(
        state: TrainState,
        features: jnp.ndarray,  # (B, fh, fw, C) cached key features
        pseudo_labels: jnp.ndarray,  # (B, ph, pw, 1) in [0, 1]
        epoch: jnp.ndarray,  # f32 scalar, current epoch
        adv_coeff: jnp.ndarray,  # f32 scalar: 1.0 normally, 0.0 in finetune
    ) -> Tuple[TrainState, Dict[str, jnp.ndarray]]:
        f = _to_feature_size(features, feature_size)
        pl = _to_feature_size(pseudo_labels.astype(jnp.float32), feature_size)

        teacher_fg, _, _ = rev_decoder_forward(state.decoder_ema, f, with_loss=False)
        teacher_bin = (jax.nn.sigmoid(teacher_fg) > 0.5).astype(jnp.float32)

        def loss_fn(dec_params):
            return _stage1_decoder_loss(
                dec_params, state, f, pl, teacher_bin, epoch, adv_coeff,
                use_dis_merge, denom,
            )

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.decoder)
        updates, new_opt_state = optimizer.update(grads, state.opt_state, state.decoder)
        new_decoder = optax.apply_updates(state.decoder, updates)

        # EMA after the optimizer step; alpha ramps on the global step, which
        # the reference advances twice per batch (loop:143 + loop:182)
        alpha = jnp.minimum(1.0 - 1.0 / (state.ema_step + 1.0), ema_weight)
        new_ema = jax.tree.map(
            lambda e, p: alpha * e + (1.0 - alpha) * p, state.decoder_ema, new_decoder
        )

        new_state = state._replace(
            decoder=new_decoder,
            decoder_ema=new_ema,
            opt_state=new_opt_state,
            ema_step=state.ema_step + 2,
        )
        aux["loss"] = loss
        return new_state, aux

    return step


def make_lora_train_step(
    cfg,
    optimizer: optax.GradientTransformation,
    lora_optimizer: optax.GradientTransformation,
    dino_cfg,
    compute_dtype,
    sp_shard=None,
):
    """Stage-1 train step with a live LoRA-adapted backbone.

    The working realisation of the reference's broken end-to-end intent
    (``models/modules/full_model.py:47-72`` — peft r=2 alpha=4 on q/k/v):
    pixels -> LoRA-adapted DINO key features -> the same stage-1 student
    loss; gradients flow to BOTH the decoder and the adapters (the dense
    backbone stays frozen via stop_gradient).  The backbone's attention is
    differentiated by its own implementation's backward (cuDNN's on the
    GPU, ops/attention.py), and layer activations follow the remat mode.

    ``sp_shard``: optional ``(Mesh, axis)`` — run the adapted backbone
    sequence-parallel (ring attention, ``parallel/sp.py``); the ring
    carries its own flash-style VJP, so adapter gradients flow through it
    and per-chip activation memory drops by the ring size.  This is the
    scaling lever for HIGH-RESOLUTION fine-tuning (756px+), where the
    reference's only option was shrinking the batch on one GPU.
    """
    feature_size = cfg.model_cfg.feature_size
    ema_weight = cfg.model_cfg.ema_weight
    use_dis_merge = cfg.train_cfg.get("merge_method", "dis") == "dis"
    denom = cfg.train_cfg.max_epoch + cfg.train_cfg.get("start_finetune", -5)
    if denom == 0:
        # the APM merge weight divides by this; denom == 0 makes epoch/denom
        # = 0/0 = NaN at epoch 0 and silently NaN-poisons every parameter
        # from the first step — fail fast instead (negative denom is a
        # clipped ramp and stays finite)
        raise ValueError(
            f"train_cfg.max_epoch ({cfg.train_cfg.max_epoch}) + start_finetune "
            f"({cfg.train_cfg.get('start_finetune', -5)}) must be nonzero (the "
            "APM merge ramp divides by it); adjust max_epoch or start_finetune"
        )
    lc = cfg.model_cfg.lora
    rank = int(lc.get("rank", 2))
    alpha = float(lc.get("alpha", 4.0))
    # bool (False=none / True=layer) or one of "none"/"layer"/"dots" —
    # "dots" saves matmul outputs and replays only elementwise chains in
    # the backward (models/dino.py::dino_forward remat modes)
    remat = lc.get("remat", True)
    if not isinstance(remat, str):
        remat = bool(remat)

    from ucod_dpl_tpu.models.lora import lora_forward

    def step(
        state: TrainState,
        lora_params,
        lora_opt_state,
        backbone_params,
        pixels: jnp.ndarray,  # (B, H, W, 3) normalised images
        pseudo_labels: jnp.ndarray,
        epoch: jnp.ndarray,
        adv_coeff: jnp.ndarray,
    ):
        pl = _to_feature_size(pseudo_labels.astype(jnp.float32), feature_size)

        def loss_fn(params):
            dec_params, lora_p = params
            out = lora_forward(
                jax.lax.stop_gradient(backbone_params), lora_p, pixels,
                dino_cfg, rank=rank, alpha=alpha,
                compute_dtype=compute_dtype, remat=remat, sp_shard=sp_shard,
            )
            f = _to_feature_size(out["key_features"].astype(jnp.float32), feature_size)
            f_sg = jax.lax.stop_gradient(f)
            teacher_fg, _, _ = rev_decoder_forward(
                state.decoder_ema, f_sg, with_loss=False
            )
            teacher_bin = (jax.nn.sigmoid(teacher_fg) > 0.5).astype(jnp.float32)
            return _stage1_decoder_loss(
                dec_params, state, f, pl, teacher_bin, epoch, adv_coeff,
                use_dis_merge, denom, f_apm=f_sg,
            )

        (loss, aux), (dec_grads, lora_grads) = jax.value_and_grad(
            loss_fn, has_aux=True
        )((state.decoder, lora_params))

        updates, new_opt_state = optimizer.update(
            dec_grads, state.opt_state, state.decoder
        )
        new_decoder = optax.apply_updates(state.decoder, updates)
        l_updates, new_lora_opt = lora_optimizer.update(
            lora_grads, lora_opt_state, lora_params
        )
        new_lora = optax.apply_updates(lora_params, l_updates)

        alpha_ema = jnp.minimum(1.0 - 1.0 / (state.ema_step + 1.0), ema_weight)
        new_ema = jax.tree.map(
            lambda e, p: alpha_ema * e + (1.0 - alpha_ema) * p,
            state.decoder_ema, new_decoder,
        )
        new_state = state._replace(
            decoder=new_decoder,
            decoder_ema=new_ema,
            opt_state=new_opt_state,
            ema_step=state.ema_step + 2,
        )
        aux["loss"] = loss
        aux["lora_grad_norm"] = optax.global_norm(lora_grads)
        return new_state, new_lora, new_lora_opt, aux

    return step


def make_discriminator_step(cfg, dis_optimizer: optax.GradientTransformation):
    """Build the jitted discriminator inter-training step
    (Discriminator_epoch, loop:230-255): student masks are 'fake' (0),
    pseudo-labels are 'real' (1)."""
    feature_size = cfg.model_cfg.feature_size

    def step(
        state: TrainState,
        features: jnp.ndarray,
        pseudo_labels: jnp.ndarray,
    ) -> Tuple[TrainState, Dict[str, jnp.ndarray]]:
        f = _to_feature_size(features, feature_size)
        fg, _, _ = rev_decoder_forward(state.decoder, f, with_loss=False)
        student_bin = (jax.nn.sigmoid(fg) > 0.5).astype(jnp.float32)
        pl = _to_feature_size(pseudo_labels.astype(jnp.float32), feature_size)
        pl_bin = (pl > 0.5).astype(jnp.float32)

        def loss_fn(dis_params):
            probs_student, stats1 = discriminator_forward(
                dis_params, state.dis_stats, student_bin, f
            )
            probs_pseudo, stats2 = discriminator_forward(dis_params, stats1, pl_bin, f)
            probs = jnp.concatenate([probs_student, probs_pseudo], axis=0)
            targets = jnp.concatenate(
                [jnp.zeros_like(probs_student), jnp.ones_like(probs_pseudo)], axis=0
            )
            return bce_probs(probs, targets), stats2

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.dis_params
        )
        updates, new_opt = dis_optimizer.update(
            grads, state.dis_opt_state, state.dis_params
        )
        new_params = optax.apply_updates(state.dis_params, updates)
        new_state = state._replace(
            dis_params=new_params, dis_stats=new_stats, dis_opt_state=new_opt
        )
        return new_state, {"dis_train_loss": loss}

    return step
