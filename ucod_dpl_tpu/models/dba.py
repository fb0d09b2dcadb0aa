"""Dual-Branch Adversarial (DBA) decoder — JAX rebuild of the
reference ``RevDecoder`` (``models/modules/DBA.py:5-59``).

Pure functions over an explicit parameter pytree.  Layout is NHWC; every
1x1 convolution is expressed as a channel matmul so the whole forward is a
handful of contractions XLA fuses with the gating math.

The orthogonality loss is algebraically reformulated: the reference
materialises the (B, L, L) branch Gram matrix (L = H*W = 4624 at the 68x68
feature size) purely to take the mean of its squared off-diagonal.  Using
``||F1 F2^T||_F^2 = sum((F1^T F1) * (F2^T F2))`` the same scalar is computed
from two (C, C) Grams (C = 64) plus an (L,) row-dot — O(L C^2) FLOPs and
O(C^2) memory instead of O(L^2 C) / O(L^2).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

EMBED_DIM = 64


class RevDecoderParams(NamedTuple):
    """Parameters of one decoder tower (student or EMA teacher)."""

    decoupling_w: jnp.ndarray  # (feature_dim, 2*EMBED_DIM)
    decoupling_b: jnp.ndarray  # (2*EMBED_DIM,)
    learnable_embedding: jnp.ndarray  # (2, EMBED_DIM)
    conv_out_fg_w: jnp.ndarray  # (EMBED_DIM, 1)
    conv_out_fg_b: jnp.ndarray  # (1,)
    conv_out_bg_w: jnp.ndarray  # (EMBED_DIM, 1)
    conv_out_bg_b: jnp.ndarray  # (1,)


def _conv1x1_init(key, fan_in: int, fan_out: int):
    """torch nn.Conv2d default init: kaiming-uniform(a=sqrt(5)) weight,
    uniform(+-1/sqrt(fan_in)) bias."""
    wkey, bkey = jax.random.split(key)
    bound_w = jnp.sqrt(1.0 / fan_in)  # kaiming uniform with a=sqrt(5), 1x1 kernel
    w = jax.random.uniform(wkey, (fan_in, fan_out), minval=-bound_w, maxval=bound_w)
    bound_b = 1.0 / jnp.sqrt(fan_in)
    b = jax.random.uniform(bkey, (fan_out,), minval=-bound_b, maxval=bound_b)
    return w.astype(jnp.float32), b.astype(jnp.float32)


def init_rev_decoder(key: jax.Array, feature_dim: int = 768) -> RevDecoderParams:
    k1, k2, k3, k4 = jax.random.split(key, 4)
    dw, db = _conv1x1_init(k1, feature_dim, 2 * EMBED_DIM)
    fw, fb = _conv1x1_init(k2, EMBED_DIM, 1)
    bw, bb = _conv1x1_init(k3, EMBED_DIM, 1)
    emb = jax.random.normal(k4, (2, EMBED_DIM), dtype=jnp.float32)
    return RevDecoderParams(dw, db, emb, fw, fb, bw, bb)


def orthogonal_loss_from_features(f1: jnp.ndarray, f2: jnp.ndarray) -> jnp.ndarray:
    """mean over (B, L, L) of squared off-diagonal of ``f1 @ f2^T``.

    Equivalent to the reference's ``calc_orthogonal_loss`` (DBA.py:25-29)
    without materialising the L x L Gram: Frobenius term via (C, C) Grams,
    diagonal via an (L,) row-dot.
    """
    hi = jax.lax.Precision.HIGHEST
    b, l, _ = f1.shape
    g1 = jnp.einsum("blc,bld->bcd", f1, f1, precision=hi)
    g2 = jnp.einsum("blc,bld->bcd", f2, f2, precision=hi)
    fro_sq = jnp.sum(g1 * g2, axis=(1, 2))  # (B,)
    diag = jnp.sum(f1 * f2, axis=-1)  # (B, L)
    diag_sq = jnp.sum(diag**2, axis=-1)  # (B,)
    return jnp.sum(fro_sq - diag_sq) / (b * l * l)


def rev_decoder_forward(
    params: RevDecoderParams,
    x: jnp.ndarray,
    *,
    with_loss: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray | None]:
    """Forward pass.

    Args:
      params: decoder parameters.
      x: features, NHWC ``(B, H, W, feature_dim)``.
      with_loss: compute the inter-branch orthogonality loss (training).

    Returns:
      (fg_logits, bg_logits, ortho_loss) with masks ``(B, H, W, 1)``.
    """
    hi = jax.lax.Precision.HIGHEST
    decoupled = (
        jnp.einsum("bhwc,cd->bhwd", x, params.decoupling_w, precision=hi)
        + params.decoupling_b
    )
    return _decoder_body(params, decoupled, with_loss=with_loss)


def rev_decoder_forward_resized(
    params: RevDecoderParams,
    feats: jnp.ndarray,
    size: int,
    *,
    with_loss: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray | None]:
    """``rev_decoder_forward(interpolate(feats, size))`` with the 1x1
    decoupling hoisted BEFORE the bilinear interpolation.

    Both are linear maps over disjoint axes (channels / space) so they
    commute, and the interpolation matrix is row-stochastic so the bias
    passes through exactly.  Interpolating the 128-channel decoupled map
    instead of the 768-channel features is ~6x less resize bandwidth —
    0.9ms -> 0.2ms per 16-image batch at 37->68 (the eval hot path)."""
    hi = jax.lax.Precision.HIGHEST
    from ucod_dpl_tpu.ops.resize import interpolate_bilinear_nhwc

    decoupled = (
        jnp.einsum("bhwc,cd->bhwd", feats, params.decoupling_w, precision=hi)
        + params.decoupling_b
    )
    decoupled = interpolate_bilinear_nhwc(decoupled, (size, size))
    return _decoder_body(params, decoupled, with_loss=with_loss)


def key_decoupling_fold(
    k_w: jnp.ndarray, k_b: jnp.ndarray, params: RevDecoderParams
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pre-compose the ViT's last-layer key projection with the decoder's
    1x1 decoupling: both are affine maps over the channel axis, so
    ``decouple(ln(x) @ Wk + bk) == ln(x) @ (Wk Wd) + (bk Wd + bd)``.

    Feeds :func:`ucod_dpl_tpu.models.dino.dino_forward`'s ``key_fold`` on
    live-inference paths (bench / LookTwice crop pass / serving): one bf16
    768->128 matmul replaces the 768->768 key projection + f32 key-map
    materialisation + separate f32 decoupling einsum."""
    fw = k_w.astype(jnp.float32) @ params.decoupling_w
    fb = k_b.astype(jnp.float32) @ params.decoupling_w + params.decoupling_b
    return fw, fb


def rev_decoder_forward_decoupled(
    params: RevDecoderParams,
    decoupled: jnp.ndarray,
    size: int | None,
    *,
    with_loss: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray | None]:
    """Decoder body on an already-decoupled ``(B, h, w, 2E)`` map (the
    ``folded_features`` output of ``dino_forward(key_fold=...)``),
    bilinear-resized to ``(size, size)`` first (same commute as
    :func:`rev_decoder_forward_resized`).  ``size=None`` keeps the native
    (possibly non-square) grid — the ``rev_decoder_forward`` behaviour."""
    from ucod_dpl_tpu.ops.resize import interpolate_bilinear_nhwc

    decoupled = decoupled.astype(jnp.float32)
    if size is not None and (decoupled.shape[1] != size or decoupled.shape[2] != size):
        decoupled = interpolate_bilinear_nhwc(decoupled, (size, size))
    return _decoder_body(params, decoupled, with_loss=with_loss)


def fg_logits_live(
    backbone_params,
    params: RevDecoderParams,
    pixels: jnp.ndarray,
    dino_cfg,
    *,
    compute_dtype,
    size: int | None = None,
    quant=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray | None]:
    """pixels -> decoder logits via the folded live-inference path.

    The DINO forward runs with ``key_fold`` (the decoder's decoupling
    pre-composed into the last layer's key projection), then the decoder
    body at ``size`` (``None`` = the native patch grid).  This is the hot
    composition of bench.py / serving / the LookTwice crop pass; cache-fed
    paths keep the unfused decoder (cached features are raw 768-dim keys).

    ``quant``: optional int8 pytree (``ops/quant.py::quantize_dino_linears``)
    — the opt-in W8A8 serving path; the decoder body stays f32."""
    from ucod_dpl_tpu.models.dino import dino_forward

    last_k = backbone_params["layers"][-1]["k"]
    fold = key_decoupling_fold(last_k["w"], last_k["b"], params)
    out = dino_forward(
        backbone_params, pixels, dino_cfg, compute_dtype=compute_dtype,
        key_fold=fold, quant=quant,
    )
    return rev_decoder_forward_decoupled(params, out["folded_features"], size)


def _decoder_body(
    params: RevDecoderParams, decoupled: jnp.ndarray, *, with_loss: bool
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray | None]:
    hi = jax.lax.Precision.HIGHEST
    b, h, w, _ = decoupled.shape
    l = h * w

    d1, d2 = jnp.split(decoupled, 2, axis=-1)  # (B, H, W, E) each

    # scale by per-branch embedding, then L2-normalise over the *token* axis
    # (the reference normalises dim=1 of (B, L, C) — i.e. across positions,
    # per channel; DBA.py:38-41)
    f1 = (d1 * params.learnable_embedding[0]).reshape(b, l, EMBED_DIM)
    f2 = (d2 * params.learnable_embedding[1]).reshape(b, l, EMBED_DIM)
    eps = 1e-12  # torch F.normalize default eps
    f1 = f1 / jnp.maximum(jnp.linalg.norm(f1, axis=1, keepdims=True), eps)
    f2 = f2 / jnp.maximum(jnp.linalg.norm(f2, axis=1, keepdims=True), eps)

    ortho = orthogonal_loss_from_features(f1, f2) if with_loss else None

    f1 = f1.reshape(b, h, w, EMBED_DIM)
    f2 = f2.reshape(b, h, w, EMBED_DIM)

    att1 = jax.nn.sigmoid(f1 * d1) + d1
    att2 = jax.nn.sigmoid(f2 * d2) + d2

    fg = (
        jnp.einsum("bhwc,cd->bhwd", att1, params.conv_out_fg_w, precision=hi)
        + params.conv_out_fg_b
    )
    bg = (
        jnp.einsum("bhwc,cd->bhwd", att2, params.conv_out_bg_w, precision=hi)
        + params.conv_out_bg_b
    )
    return fg, bg, ortho
