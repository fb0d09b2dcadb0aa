"""Adversarial mask discriminator — JAX rebuild of the reference
``Discriminator`` (``models/discriminator.py:73-95``).

Architecture: ConvBlock(mask 1->32, 3x3 s1) [+ optional feature branch],
two stride-2 ConvBlocks halving channels, flatten, Linear -> sigmoid.
Every ConvBlock is conv(bias-free) + batch-norm + leaky-relu(0.1).

Batch norm runs in batch-statistics mode: the reference only ever calls the
discriminator in train mode (it is unused at eval), so normalisation always
uses the current batch's biased moments.  Trainable parameters and BN running
statistics live in separate pytrees (``params`` / ``stats``) so the optimizer
never touches the running moments; stats are carried purely for checkpoint
compatibility.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

_DN = ("NHWC", "HWIO", "NHWC")
_LEAKY_SLOPE = 0.1
_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


def _conv_init(key, k: int, c_in: int, c_out: int):
    """torch Conv2d kaiming-uniform(a=sqrt(5)) for a k x k kernel, HWIO."""
    fan_in = c_in * k * k
    bound = jnp.sqrt(6.0 / ((1 + 5.0) * fan_in))
    return jax.random.uniform(
        key, (k, k, c_in, c_out), minval=-bound, maxval=bound, dtype=jnp.float32
    )


def _init_conv_block(key, k: int, c_in: int, c_out: int):
    params = {
        "conv_w": _conv_init(key, k, c_in, c_out),
        "bn_scale": jnp.ones((c_out,), jnp.float32),
        "bn_bias": jnp.zeros((c_out,), jnp.float32),
    }
    stats = {
        "mean": jnp.zeros((c_out,), jnp.float32),
        "var": jnp.ones((c_out,), jnp.float32),
    }
    return params, stats


def _conv_block(
    params: Dict[str, Any], stats: Dict[str, Any], x: jnp.ndarray, stride: int
) -> Tuple[jnp.ndarray, Dict[str, Any]]:
    # im2col patches + matmul instead of lax.conv for narrow layers:
    # differentiating a direct conv w.r.t. its WEIGHTS emits a
    # backprop-filter convolution that crashed an XLA backend's
    # space-to-batch pass at small batch sizes ("Check failed:
    # PropagateOnBackpropFilterConv ... Operands to select must be the same
    # shape", space_to_batch_converter.cc) — seen with bs=2 at 68x68.  With
    # patches the weights live in a plain matmul, whose gradient is another
    # matmul; the patch extraction itself uses an identity kernel the
    # filter-gradient never touches.  The shipped configs' discriminator is
    # mask-only (<=64ch), where the 9x patch materialisation is irrelevant;
    # the optional 768-ch feature branch (dis_use_features) keeps the direct
    # conv — its 9x patches would cost ~GBs, and space-to-batch skips wide-
    # channel convs anyway.
    kh, kw, c_in, c_out = params["conv_w"].shape
    if c_in * kh * kw <= 1024:
        patches = jax.lax.conv_general_dilated_patches(
            x,
            filter_shape=(kh, kw),
            window_strides=(stride, stride),
            padding=((1, 1), (1, 1)),
            dimension_numbers=_DN,
        )  # (B, H', W', c_in*kh*kw), channel-major patch order
        w_mat = params["conv_w"].transpose(2, 0, 1, 3).reshape(c_in * kh * kw, c_out)
        y = jnp.einsum(
            "bhwp,pc->bhwc", patches, w_mat, precision=jax.lax.Precision.HIGHEST
        )
    else:
        y = jax.lax.conv_general_dilated(
            x,
            params["conv_w"],
            window_strides=(stride, stride),
            padding=((1, 1), (1, 1)),
            dimension_numbers=_DN,
            precision=jax.lax.Precision.HIGHEST,
        )
    # batch statistics over (B, H, W), biased variance (torch train-mode BN)
    mean = jnp.mean(y, axis=(0, 1, 2))
    var = jnp.mean((y - mean) ** 2, axis=(0, 1, 2))
    y = (y - mean) * jax.lax.rsqrt(var + _BN_EPS)
    y = y * params["bn_scale"] + params["bn_bias"]
    y = jnp.where(y >= 0, y, _LEAKY_SLOPE * y)

    n = x.shape[0] * y.shape[1] * y.shape[2]
    unbiased = var * (n / max(n - 1, 1))
    new_stats = {
        "mean": (1 - _BN_MOMENTUM) * stats["mean"] + _BN_MOMENTUM * jax.lax.stop_gradient(mean),
        "var": (1 - _BN_MOMENTUM) * stats["var"] + _BN_MOMENTUM * jax.lax.stop_gradient(unbiased),
    }
    return y, new_stats


def init_discriminator(
    key: jax.Array,
    feature_size: int = 68,
    feature_dim: int = 768,
    use_features: bool = False,
):
    """Returns (params, stats) pytrees."""
    keys = jax.random.split(key, 5)
    indim = (feature_dim if use_features else 0) + 32
    outdim = indim // 2
    mask_p, mask_s = _init_conv_block(keys[0], 3, 1, 32)
    c0_p, c0_s = _init_conv_block(keys[2], 3, indim, outdim)
    c1_p, c1_s = _init_conv_block(keys[3], 3, indim // 2, outdim // 2)
    params: Dict[str, Any] = {"mask_conv": mask_p, "convs": [c0_p, c1_p]}
    stats: Dict[str, Any] = {"mask_conv": mask_s, "convs": [c0_s, c1_s]}
    if use_features:
        f_p, f_s = _init_conv_block(keys[1], 3, feature_dim, feature_dim)
        params["feature_conv"] = f_p
        stats["feature_conv"] = f_s
    flat = (outdim // 2) * ((feature_size + 3) // 4) ** 2
    wkey, bkey = jax.random.split(keys[4])
    bound = 1.0 / jnp.sqrt(flat)
    params["linear_w"] = jax.random.uniform(
        wkey, (flat, 1), minval=-bound, maxval=bound, dtype=jnp.float32
    )
    params["linear_b"] = jax.random.uniform(
        bkey, (1,), minval=-bound, maxval=bound, dtype=jnp.float32
    )
    return params, stats


def discriminator_forward(
    params: Dict[str, Any],
    stats: Dict[str, Any],
    mask: jnp.ndarray,
    features: Optional[jnp.ndarray] = None,
):
    """Score masks as real/fake.

    Args:
      params/stats: pytrees from :func:`init_discriminator`.
      mask: (B, H, W, 1) mask (NHWC).
      features: optional (B, H, W, feature_dim) when the feature branch exists.

    Returns:
      ((B, 1) sigmoid probabilities, refreshed stats pytree).
    """
    use_features = "feature_conv" in params
    x, mc_s = _conv_block(params["mask_conv"], stats["mask_conv"], mask, stride=1)
    new_stats = {"mask_conv": mc_s, "convs": []}
    if use_features:
        f, fc_s = _conv_block(params["feature_conv"], stats["feature_conv"], features, stride=1)
        new_stats["feature_conv"] = fc_s
        x = jnp.concatenate([x, f], axis=-1)

    for blk_p, blk_s in zip(params["convs"], stats["convs"]):
        x, nb_s = _conv_block(blk_p, blk_s, x, stride=2)
        new_stats["convs"].append(nb_s)

    # torch flattens NCHW (channel-major); transpose before flattening so the
    # linear layer weights map 1:1 onto reference checkpoints
    b = x.shape[0]
    x = jnp.transpose(x, (0, 3, 1, 2)).reshape(b, -1)
    logits = (
        jnp.einsum("bf,fo->bo", x, params["linear_w"], precision=jax.lax.Precision.HIGHEST)
        + params["linear_b"]
    )
    return jax.nn.sigmoid(logits), new_stats
