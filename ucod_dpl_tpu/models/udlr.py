"""UDLR SparseRefiner (CORAL stage 2) — EntropySelector + HRE/CSF + GatedEnsembler.

JAX rebuild of ``models/UDLR.py``, ``models/modules/{ASR,HRE,CSF,
GE_pix_level}.py`` and the cross-attention block of ``models/modules/mlp.py``.

Key redesign (SURVEY §7.7): the reference gathers a *ragged* set of
high-entropy windows with boolean indexing and scatters results back with a
Python loop (ASR.py:13-20, HRE.py:18-39) — shapes change per batch, which is
hostile to XLA.  Here every one of the ``window_size**2`` windows runs
through the CSF cross-attention in one fixed-shape batched call and invalid
windows are masked out; since the reference's window tiles never overlap
(positions are grid-aligned, HRE.concate_windows stride == window size), the
scatter-average degenerates to a masked reshape — bit-identical results with
zero dynamic shapes.

Parameter names map 1:1 onto the reference's safetensors checkpoints
(``HRE.CSF.attn.*``, ``GE.fuser.*``; runner.py:531-551).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ucod_dpl_tpu.ops import adaptive_avg_pool2d, avg_pool2d, interpolate_bilinear

HI = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _linear_init(key, d_in, d_out):
    k1, k2 = jax.random.split(key)
    s = 1.0 / np.sqrt(d_in)
    return {
        "w": jax.random.uniform(k1, (d_in, d_out), minval=-s, maxval=s, dtype=jnp.float32),
        "b": jax.random.uniform(k2, (d_out,), minval=-s, maxval=s, dtype=jnp.float32),
    }


def _ln_init(d):
    return {"scale": jnp.ones((d,), jnp.float32), "bias": jnp.zeros((d,), jnp.float32)}


def init_sparse_refiner(key: jax.Array, dim: int = 768, num_heads: int = 8) -> Dict[str, Any]:
    keys = jax.random.split(key, 10)
    # torch MultiheadAttention: xavier-uniform in_proj, out_proj kaiming-ish
    e = dim
    bound = np.sqrt(6.0 / (e + e))
    in_proj_w = jax.random.uniform(
        keys[0], (3 * e, e), minval=-bound, maxval=bound, dtype=jnp.float32
    )
    csf = {
        "attn": {
            "norm_q": _ln_init(e),
            "norm_kv": _ln_init(e),
            "in_proj_w": in_proj_w,
            "in_proj_b": jnp.zeros((3 * e,), jnp.float32),
            "out": _linear_init(keys[1], e, e),
            "norm_mlp": _ln_init(e),
            "fc1": _linear_init(keys[2], e, 4 * e),
            "fc2": _linear_init(keys[3], 4 * e, e),
        },
        "dw_conv": {
            "w": jax.random.uniform(
                keys[4], (7, 7, 1, e), minval=-np.sqrt(6.0 / (49 * 6)), maxval=np.sqrt(6.0 / (49 * 6))
            ).astype(jnp.float32),
            "b": jnp.zeros((e,), jnp.float32),
        },
        "mask_dec": _linear_init(keys[5], e, 1),
    }
    ge = {
        "alpha": jnp.float32(0.5),  # kept for checkpoint compat; unused in fwd
        "fuser0": _linear_init(keys[6], 1, 64),
        "fuser2": _linear_init(keys[7], 64, 1),
    }
    return {"csf": csf, "ge": ge, "num_heads": np.int32(num_heads)}


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

def _layernorm(x, p, eps=1e-5):
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean((x - mean) ** 2, axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]


def _dense(x, p):
    return jnp.dot(x, p["w"], precision=HI) + p["b"]


def _mha(q, kv, in_proj_w, in_proj_b, out, num_heads):
    """torch nn.MultiheadAttention (batch_first) cross-attention."""
    b, lq, e = q.shape
    lk = kv.shape[1]
    hd = e // num_heads
    wq, wk, wv = in_proj_w[:e], in_proj_w[e : 2 * e], in_proj_w[2 * e :]
    bq, bk, bv = in_proj_b[:e], in_proj_b[e : 2 * e], in_proj_b[2 * e :]
    qh = (jnp.dot(q, wq.T, precision=HI) + bq).reshape(b, lq, num_heads, hd)
    kh = (jnp.dot(kv, wk.T, precision=HI) + bk).reshape(b, lk, num_heads, hd)
    vh = (jnp.dot(kv, wv.T, precision=HI) + bv).reshape(b, lk, num_heads, hd)
    scores = jnp.einsum("bqhd,bkhd->bhqk", qh, kh, precision=HI) / np.sqrt(hd)
    probs = jax.nn.softmax(scores, axis=-1)
    ctx = jnp.einsum("bhqk,bkhd->bqhd", probs, vh, precision=HI).reshape(b, lq, e)
    return _dense(ctx, out)


def cross_attention_block(p, query, context, num_heads):
    """CrossAttentionBlock (mlp.py:116-148): pre-norm cross-attn + MLP."""
    q = _layernorm(query, p["norm_q"])
    kv = _layernorm(context, p["norm_kv"])
    attn_out = _mha(q, kv, p["in_proj_w"], p["in_proj_b"], p["out"], num_heads)
    x = query + attn_out
    h = _layernorm(x, p["norm_mlp"])
    h = _dense(h, p["fc1"])
    h = jax.nn.gelu(h, approximate=False)
    h = _dense(h, p["fc2"])
    return x + h


def csf_forward(p, l_inputs, h_inputs, num_heads):
    """CSF (CSF.py:38-43): cross-attn (h as query, l as context) + depthwise
    7x7 + 1x1 mask head.  Inputs NHWC (N, H, W, C); returns (N, H, W, 1)."""
    n, h, w, c = h_inputs.shape
    q = h_inputs.reshape(n, h * w, c)
    ctx = l_inputs.reshape(n, -1, c)
    out = cross_attention_block(p["attn"], q, ctx, num_heads)
    out = out.reshape(n, h, w, c)
    out = jax.lax.conv_general_dilated(
        out,
        p["dw_conv"]["w"],
        window_strides=(1, 1),
        padding=((3, 3), (3, 3)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c,
        precision=HI,
    ) + p["dw_conv"]["b"]
    return _dense(out, p["mask_dec"])


def entropy_select(preds: jnp.ndarray, window_size: int, threshold: float):
    """EntropySelector (ASR.py:41-51): per-window mean prediction entropy.

    preds: (B, H, W, 1) — probabilities if in [0,1], else logits.
    Returns (mask (B, ws, ws) bool, entropy (B, H, W, 1))."""
    in_range = jnp.all((preds >= 0) & (preds <= 1))
    probs = jnp.where(in_range, preds, jax.nn.sigmoid(preds))
    entropy = -probs * jnp.log(jnp.maximum(probs, 1e-5))
    scores = adaptive_avg_pool2d(
        jnp.transpose(entropy, (0, 3, 1, 2)), (window_size, window_size)
    )[:, 0]
    return scores > threshold, entropy


def gated_ensemble(p, l1: jnp.ndarray, l2: jnp.ndarray):
    """GatedEnsembler (GE_pix_level.py:16-26): entropy/fg-ratio gate blend +
    1x1 fuser. l1/l2: (B, H, W, 1) logits; l1 resized to l2's size."""
    h, w = l2.shape[1:3]
    l1 = interpolate_bilinear(jnp.transpose(l1, (0, 3, 1, 2)), (h, w)).transpose(
        0, 2, 3, 1
    )
    probs = jax.nn.sigmoid(l1)
    fg_g = jnp.mean(probs, axis=(1, 2, 3), keepdims=True)
    fg_l = avg_pool2d(jnp.transpose(probs, (0, 3, 1, 2)), 19, stride=1, padding=9)
    fg_l = jnp.transpose(fg_l, (0, 2, 3, 1))
    en = -fg_l * jnp.log(jnp.maximum(fg_l, 1e-5))
    en = 1.0 - en / jnp.max(en)  # batch-global max, as the reference
    weight = (en + fg_g) / 2.0
    y = l1 * weight + l2 * (1.0 - weight)
    fused = _dense(jax.nn.relu(_dense(y, p["fuser0"])), p["fuser2"])
    return fused, weight


# ---------------------------------------------------------------------------
# SparseRefiner
# ---------------------------------------------------------------------------

class RefinerOutput(NamedTuple):
    outputs: jnp.ndarray  # (B, H*ws, W*ws, 1) fused logits
    h_preds: jnp.ndarray  # (B, H*ws, W*ws, 1) scattered window predictions
    window_preds: jnp.ndarray  # (B*ws^2, h, w, 1) all window predictions
    mask: jnp.ndarray  # (B, ws, ws) selected-window mask
    entropy: jnp.ndarray
    ge_weight: jnp.ndarray


def sparse_refiner_forward(
    params: Dict[str, Any],
    l_features: jnp.ndarray,  # (B, h, w, C) low-res features
    h_features: jnp.ndarray,  # (B, ws^2, h, w, C) per-window high-res features
    preds: jnp.ndarray,  # (B, h, w, 1) coarse predictions (logits or probs)
    window_size: int,
    threshold: float,
    num_heads: int = 8,
) -> RefinerOutput:
    """SparseRefiner.forward (UDLR.py:77-86), fixed-capacity formulation."""
    b, ws2, h, w, c = h_features.shape
    ws = window_size
    assert ws2 == ws * ws

    mask, entropy = entropy_select(preds, ws, threshold)  # (B, ws, ws)

    # every window through CSF in one batched call; l-features broadcast as
    # context for each of its image's windows (the repeat_interleave of
    # ASR.window_sets made dense)
    l_rep = jnp.repeat(l_features, ws2, axis=0)  # (B*ws^2, h, w, C)
    h_flat = h_features.reshape(b * ws2, h, w, c)
    window_preds = csf_forward(params["csf"], l_rep, h_flat, num_heads)  # (B*ws2,h,w,1)

    # masked scatter onto the canvas: tiles are non-overlapping, so this is a
    # reshape; unselected tiles get the reference's 0/(0+1e-6)=0
    sel = mask.reshape(b, ws2, 1, 1, 1).astype(window_preds.dtype)
    tiles = window_preds.reshape(b, ws, ws, h, w, 1) * sel.reshape(b, ws, ws, 1, 1, 1)
    canvas = tiles.transpose(0, 1, 3, 2, 4, 5).reshape(b, ws * h, ws * w, 1)
    denom = (
        mask.reshape(b, ws, ws, 1, 1).astype(jnp.float32) + 1e-6
    )
    denom = jnp.broadcast_to(denom, (b, ws, ws, h, w)).transpose(0, 1, 3, 2, 4).reshape(
        b, ws * h, ws * w, 1
    )
    h_preds = canvas / denom

    outputs, ge_w = gated_ensemble(params["ge"], preds, h_preds)
    return RefinerOutput(outputs, h_preds, window_preds, mask, entropy, ge_w)


def binary_iou_batch(preds: jnp.ndarray, targets: jnp.ndarray, threshold=0.5):
    """binary_iou (UDLR.py:26-42) over (N, h, w, 1) tensors -> (N,)."""
    p = preds[..., 0]
    t = targets[..., 0]
    needs_sig = jnp.max(p) > 1
    p = jnp.where(needs_sig, jax.nn.sigmoid(p), p)
    pb = (p > threshold).astype(jnp.int32)
    tb = t.astype(jnp.int32)
    inter = jnp.sum(pb & tb, axis=(1, 2)).astype(jnp.float32)
    union = jnp.sum(pb | tb, axis=(1, 2)).astype(jnp.float32)
    return inter / (union + 1e-6)


def refiner_distillation_loss(
    out: RefinerOutput,
    coarse_preds: jnp.ndarray,  # (B, h, w, 1)
    h_targets: jnp.ndarray,  # (B*ws^2, h, w, 1) high-res window targets
    window_size: int,
) -> jnp.ndarray:
    """IoU-weighted BCE distillation (cal_ex_loss, UDLR.py:52-75), with the
    ragged selection replaced by masking over the fixed window set."""
    ws = window_size
    b = coarse_preds.shape[0]
    n, h, w, _ = out.window_preds.shape

    # coarse predictions upsampled and cut into the same window tiles
    up = interpolate_bilinear(
        jnp.transpose(coarse_preds, (0, 3, 1, 2)), (h * ws, w * ws)
    )
    l_bin = (jax.nn.sigmoid(up) > 0.5).astype(jnp.float32)  # (B,1,H,W)
    l_tiles = (
        l_bin.reshape(b, 1, ws, h, ws, w).transpose(0, 2, 4, 1, 3, 5).reshape(n, h, w, 1)
    )

    ious = jnp.clip(binary_iou_batch(h_targets, l_tiles) * 1.5, 0.0, 1.0)
    ious = jax.lax.stop_gradient(ious)[:, None, None, None]

    x = out.window_preds
    bce_h = jnp.maximum(x, 0) - x * h_targets + jnp.log1p(jnp.exp(-jnp.abs(x)))
    bce_l = jnp.maximum(x, 0) - x * l_tiles + jnp.log1p(jnp.exp(-jnp.abs(x)))
    per_elem = ious * bce_h + (1.0 - ious) * bce_l  # (N, h, w, 1)

    sel = out.mask.reshape(n).astype(jnp.float32)[:, None, None, None]
    num_sel = jnp.maximum(jnp.sum(sel), 1.0)
    # mean over selected windows' elements, then /2 (UDLR.py:74)
    return jnp.sum(per_elem * sel) / (num_sel * h * w) / 2.0


def refiner_ensemble_loss(
    out: RefinerOutput,
    coarse_preds: jnp.ndarray,  # (B, h, w, 1)
    h_targets: jnp.ndarray,  # (B*ws^2, h, w, 1)
    window_size: int,
) -> jnp.ndarray:
    """Output-level BCE for the GatedEnsembler.

    The shipped distillation loss (cal_ex_loss, UDLR.py:52-75) supervises
    only the per-window predictions — the GE fuser receives NO gradient from
    it and would stay at random init in a trainer built on it alone (found
    empirically by test_learnability.py::test_stage2_refiner_beats_coarse).
    The upstream trainer was never released, so how GE trained is undefined;
    this term completes our trainer: the fused output is pushed toward the
    composite target — high-res window targets where windows were selected,
    the binarised coarse prediction elsewhere."""
    ws = window_size
    b = coarse_preds.shape[0]
    n, h, w, _ = out.window_preds.shape

    tiles_t = h_targets.reshape(b, ws, ws, h, w, 1)
    canvas_t = tiles_t.transpose(0, 1, 3, 2, 4, 5).reshape(b, ws * h, ws * w, 1)

    up = interpolate_bilinear(
        jnp.transpose(coarse_preds, (0, 3, 1, 2)), (h * ws, w * ws)
    )
    coarse_bin = (jax.nn.sigmoid(up) > 0.5).astype(jnp.float32).transpose(0, 2, 3, 1)

    selmap = out.mask.reshape(b, ws, ws, 1, 1).astype(jnp.float32)
    selmap = jnp.broadcast_to(selmap, (b, ws, ws, h, w)).transpose(
        0, 1, 3, 2, 4
    ).reshape(b, ws * h, ws * w, 1)
    target = jax.lax.stop_gradient(selmap * canvas_t + (1.0 - selmap) * coarse_bin)

    x = out.outputs
    bce = jnp.maximum(x, 0) - x * target + jnp.log1p(jnp.exp(-jnp.abs(x)))
    return jnp.mean(bce)


def refiner_train_loss(
    out: RefinerOutput,
    coarse_preds: jnp.ndarray,
    h_targets: jnp.ndarray,
    window_size: int,
) -> jnp.ndarray:
    """The full stage-2 trainer objective: shipped window-level distillation
    + the GE ensemble term (see refiner_ensemble_loss for why both)."""
    return refiner_distillation_loss(
        out, coarse_preds, h_targets, window_size
    ) + refiner_ensemble_loss(out, coarse_preds, h_targets, window_size)


# ---------------------------------------------------------------------------
# checkpoint IO (reference name compatibility)
# ---------------------------------------------------------------------------

_NAME_MAP = {
    "HRE.CSF.attn.norm_q.weight": ("csf", "attn", "norm_q", "scale"),
    "HRE.CSF.attn.norm_q.bias": ("csf", "attn", "norm_q", "bias"),
    "HRE.CSF.attn.norm_kv.weight": ("csf", "attn", "norm_kv", "scale"),
    "HRE.CSF.attn.norm_kv.bias": ("csf", "attn", "norm_kv", "bias"),
    "HRE.CSF.attn.attn.in_proj_weight": ("csf", "attn", "in_proj_w"),
    "HRE.CSF.attn.attn.in_proj_bias": ("csf", "attn", "in_proj_b"),
    "HRE.CSF.attn.attn.out_proj.weight": ("csf", "attn", "out", "w", "T"),
    "HRE.CSF.attn.attn.out_proj.bias": ("csf", "attn", "out", "b"),
    "HRE.CSF.attn.norm_mlp.weight": ("csf", "attn", "norm_mlp", "scale"),
    "HRE.CSF.attn.norm_mlp.bias": ("csf", "attn", "norm_mlp", "bias"),
    "HRE.CSF.attn.mlp.0.weight": ("csf", "attn", "fc1", "w", "T"),
    "HRE.CSF.attn.mlp.0.bias": ("csf", "attn", "fc1", "b"),
    "HRE.CSF.attn.mlp.2.weight": ("csf", "attn", "fc2", "w", "T"),
    "HRE.CSF.attn.mlp.2.bias": ("csf", "attn", "fc2", "b"),
    "HRE.CSF.depthwise_conv.weight": ("csf", "dw_conv", "w", "DW"),
    "HRE.CSF.depthwise_conv.bias": ("csf", "dw_conv", "b"),
    "HRE.CSF.mask_dec.weight": ("csf", "mask_dec", "w", "CONV1"),
    "HRE.CSF.mask_dec.bias": ("csf", "mask_dec", "b"),
    "GE.alpha": ("ge", "alpha"),
    "GE.fuser.0.weight": ("ge", "fuser0", "w", "CONV1"),
    "GE.fuser.0.bias": ("ge", "fuser0", "b"),
    "GE.fuser.2.weight": ("ge", "fuser2", "w", "CONV1"),
    "GE.fuser.2.bias": ("ge", "fuser2", "b"),
}


def _set_nested(d, path, value):
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def load_refiner_checkpoint(path: str, num_heads: int = 8) -> Dict[str, Any]:
    """Load a reference-format SparseRefiner safetensors checkpoint."""
    from ucod_dpl_tpu.models.safetensors_io import load_file

    flat = load_file(path)
    missing = [name for name in _NAME_MAP if name not in flat]
    if missing:
        # a silent partial load would surface much later as an opaque
        # KeyError inside the jitted refiner trace — fail at the source
        # (truncated file, or a non-refiner checkpoint passed via
        # --refiner_path)
        raise ValueError(
            f"Refiner checkpoint {path} is missing {len(missing)}/"
            f"{len(_NAME_MAP)} tensors (e.g. {missing[:3]}); is this a "
            "SparseRefiner checkpoint?"
        )
    params: Dict[str, Any] = {"num_heads": np.int32(num_heads)}
    for name, spec in _NAME_MAP.items():
        arr = flat[name]
        transform = spec[-1] if spec[-1] in ("T", "DW", "CONV1") else None
        path_keys = spec[:-1] if transform else spec
        if transform == "T":  # torch Linear (out, in) -> (in, out)
            arr = arr.T
        elif transform == "DW":  # torch depthwise (C, 1, 7, 7) -> HWIO (7,7,1,C)
            arr = np.transpose(arr, (2, 3, 1, 0))
        elif transform == "CONV1":  # torch 1x1 conv (O, I, 1, 1) -> (I, O)
            arr = arr[:, :, 0, 0].T
        _set_nested(params, path_keys, jnp.asarray(arr))
    return params


def save_refiner_checkpoint(path: str, params: Dict[str, Any]) -> None:
    """Save in the reference's safetensors name layout."""
    import os


    def get_nested(d, keys):
        for k in keys:
            d = d[k]
        return d

    flat: Dict[str, np.ndarray] = {}
    for name, spec in _NAME_MAP.items():
        transform = spec[-1] if spec[-1] in ("T", "DW", "CONV1") else None
        path_keys = spec[:-1] if transform else spec
        arr = np.asarray(get_nested(params, path_keys), dtype=np.float32)
        if transform == "T":
            arr = arr.T
        elif transform == "DW":
            arr = np.transpose(arr, (3, 2, 0, 1))
        elif transform == "CONV1":
            arr = arr.T[:, :, None, None]
        flat[name] = np.ascontiguousarray(arr)
    from ucod_dpl_tpu.models.safetensors_io import save_file_atomic

    save_file_atomic(flat, path)
