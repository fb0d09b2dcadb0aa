"""End-to-end learnability: on linearly-separable synthetic features the
full stage-1 algorithm (teacher/student/APM/discriminator) must fit the
pseudo-labels."""

import pytest

import numpy as np

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.engine.train_step import make_optimizer, make_train_step
from ucod_dpl_tpu.models.dba import rev_decoder_forward

from test_train import DIM, FS, _init_state, _train_cfg

pytestmark = pytest.mark.heavy  # wall-clock-heavy convergence runs (single-process):
# hundreds of optimizer steps per test; excluded from the quick loop


def _separable_batch(seed=0, b=8, grid=16):
    """Features whose first channels carry the mask signal."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((b, grid, grid, 1), np.float32)
    for i in range(b):
        y, x = rng.integers(2, grid - 6, size=2)
        masks[i, y : y + 5, x : x + 5] = 1.0
    feats = rng.standard_normal((b, grid, grid, DIM)).astype(np.float32) * 0.1
    feats[..., :8] += masks * 3.0  # strong foreground signature
    return jnp.asarray(feats), jnp.asarray(masks)


def test_stage1_fits_separable_data():
    cfg = _train_cfg()
    # direct pseudo-label supervision: with a *random* discriminator the APM
    # weight saturates at ~1 (|p_s - p_p| ~ 0) and the student would chase
    # the random teacher — the reference mitigates this by pre-training the
    # discriminator each dis_intertrain epoch; here we isolate decoder
    # learnability from that dynamic.
    cfg.train_cfg.merge_method = "none"
    optimizer = make_optimizer(5e-3, 0.95, 1000)
    dis_optimizer = make_optimizer(1e-3, 0.95, 1000)
    step = jax.jit(make_train_step(cfg, optimizer))
    state = _init_state(cfg, optimizer, dis_optimizer)
    feats, masks = _separable_batch()

    losses = []
    for i in range(60):
        state, aux = step(state, feats, masks, jnp.float32(0.0), jnp.float32(1.0))
        losses.append(float(aux["loss"]))
    assert losses[-1] < losses[0], (losses[0], losses[-1])

    # student prediction quality on the training batch
    from ucod_dpl_tpu.ops import interpolate_bilinear

    f = interpolate_bilinear(jnp.transpose(feats, (0, 3, 1, 2)), (FS, FS)).transpose(
        0, 2, 3, 1
    )
    fg, bg_rev, _ = rev_decoder_forward(state.decoder, f, with_loss=False)
    pred = np.asarray(jax.nn.sigmoid(fg[..., 0])) > 0.5
    target = (
        np.asarray(
            interpolate_bilinear(jnp.transpose(masks, (0, 3, 1, 2)), (FS, FS))
        )[:, 0]
        > 0.5
    )
    iou = (pred & target).sum() / max((pred | target).sum(), 1)
    assert iou > 0.5, iou

    # reverse branch learned the complement
    bg_pred = np.asarray(jax.nn.sigmoid(bg_rev[..., 0])) > 0.5
    bg_iou = (bg_pred & ~target).sum() / max((bg_pred | ~target).sum(), 1)
    assert bg_iou > 0.5, bg_iou

    # EMA teacher converged towards the student
    fg_t, _, _ = rev_decoder_forward(state.decoder_ema, f, with_loss=False)
    pred_t = np.asarray(jax.nn.sigmoid(fg_t[..., 0])) > 0.5
    agree = (pred_t == pred).mean()
    assert agree > 0.8, agree


# ---------------------------------------------------------------------------
# Stage 2: the invented CORAL trainer must have
# empirical grounding — train the SparseRefiner with the shipped
# IoU-weighted distillation loss (UDLR.py:52-75 semantics, the same loss
# engine/coral_loop.LocalRefineTrainLoop optimises) on synthetic data where
# high-res windows genuinely carry more detail than the coarse path, and
# QUANTIFY that the refined output beats the coarse decoder's prediction.
# ---------------------------------------------------------------------------

S2_DIM = 32
WL = 8  # window length
WS = 2  # 2x2 windows -> 16x16 canvas


def _canvas_scene(seed, b=8):
    """(features_canvas, masks) at canvas res: thin crosses whose 2px arms
    are destroyed by the 2x feature downsampling of the coarse path but
    remain intact in the per-window high-res features."""
    rng = np.random.default_rng(seed)
    size = WS * WL
    masks = np.zeros((b, size, size, 1), np.float32)
    for i in range(b):
        y, x = rng.integers(3, size - 10, size=2)
        masks[i, y + 3 : y + 5, x : x + 8] = 1.0  # horizontal 2px arm
        masks[i, y : y + 8, x + 3 : x + 5] = 1.0  # vertical 2px arm
    feats = rng.standard_normal((b, size, size, S2_DIM)).astype(np.float32) * 0.1
    feats[..., :8] += masks * 3.0
    return feats, masks


def _fit_decoder(seed=0):
    """Quick stage-1 fit at window resolution: decoder decodes the feature
    signature into mask logits (the frozen 'teacher' of stage 2)."""
    from ucod_dpl_tpu.config import CfgNode
    from test_train import _init_state

    cfg = CfgNode({
        "model_cfg": {"dim": S2_DIM, "feature_size": WL, "ema_weight": 0.99,
                      "dis_use_features": False},
        "train_cfg": {"max_epoch": 25, "start_finetune": -5,
                      "merge_method": "none"},
    })
    optimizer = make_optimizer(5e-3, 0.95, 1000)
    dis_optimizer = make_optimizer(1e-3, 0.95, 1000)
    step = jax.jit(make_train_step(cfg, optimizer))
    state = _init_state(cfg, optimizer, dis_optimizer, dim=S2_DIM, fs=WL)
    rng = np.random.default_rng(7)
    masks = np.zeros((8, WL, WL, 1), np.float32)
    for i in range(8):
        y, x = rng.integers(1, WL - 4, size=2)
        masks[i, y : y + 3, x : x + 3] = 1.0
    feats = rng.standard_normal((8, WL, WL, S2_DIM)).astype(np.float32) * 0.1
    feats[..., :8] += masks * 3.0
    for _ in range(80):
        state, _ = step(
            state, jnp.asarray(feats), jnp.asarray(masks),
            jnp.float32(0.0), jnp.float32(1.0),
        )
    return state.decoder


def _iou(pred_bin, target_bin):
    inter = (pred_bin & target_bin).sum()
    union = (pred_bin | target_bin).sum()
    return inter / max(union, 1)


def _stage2_setup():
    """Shared fixture: frozen decoder, low/high-res features, coarse preds,
    window targets — exactly as LocalRefineTrainLoop builds them."""
    from ucod_dpl_tpu.ops import interpolate_bilinear

    decoder = _fit_decoder()
    feats_c, masks = _canvas_scene(seed=1)
    b = feats_c.shape[0]

    # low-res path: 2x-downsampled canvas features (boundary detail lost)
    l_feat = np.asarray(
        interpolate_bilinear(
            jnp.transpose(jnp.asarray(feats_c), (0, 3, 1, 2)), (WL, WL)
        ).transpose(0, 2, 3, 1)
    )
    # high-res path: each window is an exact (WL, WL) crop of the canvas
    h_feat = np.stack(
        [
            np.stack(
                [
                    feats_c[k, i * WL : (i + 1) * WL, j * WL : (j + 1) * WL]
                    for i in range(WS)
                    for j in range(WS)
                ]
            )
            for k in range(b)
        ]
    )  # (B, ws^2, WL, WL, C) in the forward's row-major tile order

    l_feat_j = jnp.asarray(l_feat)
    h_feat_j = jnp.asarray(h_feat)
    coarse, _, _ = rev_decoder_forward(decoder, l_feat_j, with_loss=False)

    # window targets exactly as LocalRefineTrainLoop builds them: the frozen
    # decoder on each window's high-res features, binarised
    h_flat = h_feat_j.reshape(b * WS * WS, WL, WL, S2_DIM)
    tgt_logits, _, _ = rev_decoder_forward(decoder, h_flat, with_loss=False)
    h_targets = (jax.nn.sigmoid(tgt_logits) > 0.5).astype(jnp.float32)
    return l_feat_j, h_feat_j, coarse, h_targets, masks


def _train_refiner(setup, loss_fn_builder, steps=150, seed=3):
    """Train a fresh SparseRefiner with the given loss on the shared
    fixture; returns (final forward output, losses, refined/coarse IoUs)."""
    import optax

    from ucod_dpl_tpu.models.udlr import init_sparse_refiner, sparse_refiner_forward
    from ucod_dpl_tpu.ops import interpolate_bilinear

    l_feat_j, h_feat_j, coarse, h_targets, masks = setup
    refiner = init_sparse_refiner(jax.random.PRNGKey(seed), dim=S2_DIM, num_heads=4)
    trainable = {k: v for k, v in refiner.items() if k != "num_heads"}
    opt = optax.adamw(2e-3)
    opt_state = opt.init(trainable)
    loss_of_out = loss_fn_builder()

    def loss_fn(params):
        out = sparse_refiner_forward(
            params, l_feat_j, h_feat_j, coarse, window_size=WS, threshold=0.0015,
            num_heads=4,
        )
        return loss_of_out(out, coarse, h_targets)

    @jax.jit
    def train_step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(steps):
        trainable, opt_state, loss = train_step(trainable, opt_state)
        losses.append(float(loss))

    out = sparse_refiner_forward(
        trainable, l_feat_j, h_feat_j, coarse, window_size=WS, threshold=0.0015,
        num_heads=4,
    )
    size = WS * WL
    refined_bin = np.asarray(jax.nn.sigmoid(out.outputs[..., 0])) > 0.5
    coarse_up = np.asarray(
        interpolate_bilinear(jnp.transpose(coarse, (0, 3, 1, 2)), (size, size))
    )[:, 0]
    coarse_bin = 1 / (1 + np.exp(-coarse_up)) > 0.5
    target_bin = masks[..., 0] > 0.5
    return out, losses, _iou(refined_bin, target_bin), _iou(coarse_bin, target_bin), (
        refined_bin, coarse_bin, masks
    )


import pytest as _pytest


@_pytest.fixture(scope="module")
def stage2_setup():
    return _stage2_setup()


@_pytest.fixture(scope="module")
def trained_with_ge(stage2_setup):
    """One full-objective training run shared by the convergence test and
    the ablation (same seed/data — retraining it per test doubled the
    file's wall-clock for zero coverage)."""
    from ucod_dpl_tpu.models.udlr import refiner_train_loss

    return _train_refiner(
        stage2_setup,
        lambda: lambda o, c, t: refiner_train_loss(o, c, t, window_size=WS),
    )


def test_stage2_refiner_beats_coarse(trained_with_ge):
    out, losses, iou_refined, iou_coarse, (refined_bin, coarse_bin, masks) = (
        trained_with_ge
    )
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0], (
        losses[0], losses[-1],
    )
    mae_refined = np.abs(refined_bin.astype(np.float64) - masks[..., 0]).mean()
    mae_coarse = np.abs(coarse_bin.astype(np.float64) - masks[..., 0]).mean()

    # the refined prediction must QUANTIFIABLY beat the coarse one
    assert iou_refined > iou_coarse + 0.02, (iou_refined, iou_coarse)
    assert mae_refined < mae_coarse, (mae_refined, mae_coarse)
    # and at least one window was actually selected + re-predicted
    assert float(jnp.sum(out.mask)) > 0


def test_ge_ensemble_term_ablation(stage2_setup, trained_with_ge):
    """The GE ensemble term must be LOAD-BEARING: the shipped
    distillation loss alone (cal_ex_loss, UDLR.py:52-75) gives the
    GatedEnsembler fuser NO gradient, so the fused output stays at random
    init and cannot beat the coarse prediction; adding
    ``refiner_ensemble_loss`` (our completion of the unreleased upstream
    trainer) makes it win.  This pins the documented ablation with numbers
    instead of prose (recorded in ROADMAP.md)."""
    from ucod_dpl_tpu.models.udlr import refiner_distillation_loss

    _, _, iou_with, iou_coarse, _ = trained_with_ge
    _, _, iou_without, iou_coarse2, _ = _train_refiner(
        stage2_setup,
        lambda: lambda o, c, t: refiner_distillation_loss(o, c, t, window_size=WS),
    )
    assert iou_coarse == iou_coarse2  # same frozen decoder / data
    # with the term: refined beats coarse (as in the main test); without it
    # the random-init fuser's output must NOT beat coarse — if it ever does,
    # the term stopped being load-bearing and the documented ablation is
    # stale
    assert iou_with > iou_coarse + 0.02, (iou_with, iou_coarse)
    assert iou_without < iou_coarse + 0.02, (iou_without, iou_coarse)
    assert iou_with > iou_without + 0.05, (iou_with, iou_without)
    print(
        f"GE ablation: coarse IoU={iou_coarse:.3f}, with GE term="
        f"{iou_with:.3f}, distillation-only={iou_without:.3f}"
    )
