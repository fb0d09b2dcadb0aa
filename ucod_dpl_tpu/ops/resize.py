"""Separable resampling ops with exact PyTorch semantics, as small matmuls.

The reference pipeline leans heavily on ``F.interpolate(mode='bilinear',
align_corners=False)`` (feature/label resizing at every stage, e.g.
``engine/runner/loop_UCOD_DPL.py:153-154``) and bicubic for ViT position
embeddings.  Exact parity matters for loading the shipped checkpoints and
matching published metrics.

Design: instead of gather-based interpolation, each 1-D resample is
expressed as a small dense weight matrix applied with ``einsum`` —
separably over H then W.  Weight matrices have 2 (linear) or 4 (cubic)
non-zeros per row, are built once on host per (in, out) pair, cached, and
the contractions run as matmuls that XLA fuses with surrounding elementwise
work.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=256)
def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out,in) row-stochastic matrix reproducing torch bilinear
    (align_corners=False, no antialias) along one axis."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    scale = in_size / out_size
    src = np.maximum(scale * (np.arange(out_size) + 0.5) - 0.5, 0.0)
    x0 = np.floor(src).astype(np.int64)
    x0 = np.minimum(x0, in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    frac = (src - x0).astype(np.float32)
    rows = np.arange(out_size)
    np.add.at(w, (rows, x0), 1.0 - frac)
    np.add.at(w, (rows, x1), frac)
    return w


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> Tuple[np.ndarray, ...]:
    """Cubic convolution coefficients for the 4 taps around fractional t."""

    def k_inner(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def k_outer(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    return k_outer(t + 1.0), k_inner(t), k_inner(1.0 - t), k_outer(2.0 - t)


@lru_cache(maxsize=256)
def _cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out,in) matrix reproducing torch bicubic (align_corners=False)."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    src = scale * (np.arange(out_size) + 0.5) - 0.5  # unclamped for cubic
    x0 = np.floor(src).astype(np.int64)
    t = (src - x0).astype(np.float64)
    coeffs = _cubic_kernel(t)
    rows = np.arange(out_size)
    for tap, c in enumerate(coeffs):
        idx = np.clip(x0 - 1 + tap, 0, in_size - 1)
        np.add.at(w, (rows, idx), c.astype(np.float32))
    return w


@lru_cache(maxsize=256)
def _adaptive_avg_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out,in) averaging matrix reproducing torch adaptive_avg_pool1d bins:
    bin i covers [floor(i*in/out), ceil((i+1)*in/out))."""
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -((-(i + 1) * in_size) // out_size)  # ceil
        w[i, lo:hi] = 1.0 / (hi - lo)
    return w


def _apply_separable(x: jnp.ndarray, wh: np.ndarray, ww: np.ndarray) -> jnp.ndarray:
    """Apply per-axis (out,in) weight matrices to the trailing two dims of a
    (..., H, W) array; accumulates in float32."""
    import jax

    orig_dtype = x.dtype
    wh_j = jnp.asarray(wh)
    ww_j = jnp.asarray(ww)
    # full-f32 matmul passes: interpolation weights are exact-parity sensitive
    y = jnp.einsum(
        "...hw,Hh->...Hw",
        x,
        wh_j,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    y = jnp.einsum(
        "...Hw,Ww->...HW",
        y,
        ww_j,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.astype(orig_dtype) if orig_dtype != jnp.float32 else y


def interpolate_bilinear(x: jnp.ndarray, size: Tuple[int, int]) -> jnp.ndarray:
    """torch ``F.interpolate(x, size, mode='bilinear', align_corners=False)``
    for (..., H, W) arrays."""
    h, w = int(size[0]), int(size[1])
    if x.shape[-2] == h and x.shape[-1] == w:
        return x
    return _apply_separable(x, _linear_weights(x.shape[-2], h), _linear_weights(x.shape[-1], w))


def interpolate_bilinear_nhwc(x: jnp.ndarray, size: Tuple[int, int]) -> jnp.ndarray:
    """Bilinear resize of (B, H, W, C) arrays without layout transposes —
    the same per-axis weight matrices contracted over the middle axes (the
    channel dim stays innermost)."""
    import jax

    h, w = int(size[0]), int(size[1])
    if x.shape[1] == h and x.shape[2] == w:
        return x
    wh = jnp.asarray(_linear_weights(x.shape[1], h))
    ww = jnp.asarray(_linear_weights(x.shape[2], w))
    orig_dtype = x.dtype
    y = jnp.einsum(
        "bhwc,Hh->bHwc", x, wh,
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    )
    y = jnp.einsum(
        "bHwc,Ww->bHWc", y, ww,
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    )
    return y.astype(orig_dtype) if orig_dtype != jnp.float32 else y


@lru_cache(maxsize=256)
def _linear_taps(in_size: int, out_size: int):
    """(lo_idx, hi_idx, frac) for one axis — the 2 nonzeros per row of
    :func:`_linear_weights` in gather form."""
    if in_size == 1:
        z = np.zeros(out_size, np.int64)
        return z, z, np.zeros(out_size, np.float32)
    scale = in_size / out_size
    src = np.maximum(scale * (np.arange(out_size) + 0.5) - 0.5, 0.0)
    x0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    return x0, x1, (src - x0).astype(np.float32)


def interpolate_bilinear_np(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Host-side twin of :func:`interpolate_bilinear` (identical tap/weight
    formula).  Used where a device round-trip would cost more than the
    resample itself — e.g. per-image mask resizing in the eval loops.

    Gather-based on host (unlike the matmul device path): the bilinear
    weight matrix has 2 nonzeros per row, so a dense einsum wastes ~in/2 of
    its FLOPs — at 518->640 that was 55ms/image of pure overhead."""
    h, w = int(size[0]), int(size[1])
    x = np.asarray(x, dtype=np.float32)
    if x.shape[-2] == h and x.shape[-1] == w:
        return x
    y0, y1, fy = _linear_taps(x.shape[-2], h)
    x0, x1, fx = _linear_taps(x.shape[-1], w)
    # H axis: (..., h_out, w_in)
    t = x[..., y0, :] * (1.0 - fy)[:, None] + x[..., y1, :] * fy[:, None]
    # W axis: (..., h_out, w_out)
    return t[..., x0] * (1.0 - fx) + t[..., x1] * fx


def interpolate_bicubic(x: jnp.ndarray, size: Tuple[int, int]) -> jnp.ndarray:
    """torch ``F.interpolate(x, size, mode='bicubic', align_corners=False)``
    for (..., H, W) arrays."""
    h, w = int(size[0]), int(size[1])
    if x.shape[-2] == h and x.shape[-1] == w:
        return x
    return _apply_separable(x, _cubic_weights(x.shape[-2], h), _cubic_weights(x.shape[-1], w))


def adaptive_avg_pool2d(x: jnp.ndarray, output_size: Tuple[int, int]) -> jnp.ndarray:
    """torch ``F.adaptive_avg_pool2d`` for (..., H, W) arrays."""
    h, w = int(output_size[0]), int(output_size[1])
    return _apply_separable(
        x, _adaptive_avg_weights(x.shape[-2], h), _adaptive_avg_weights(x.shape[-1], w)
    )


def avg_pool2d(
    x: jnp.ndarray, kernel: int, stride: int = 1, padding: int = 0
) -> jnp.ndarray:
    """torch ``F.avg_pool2d(count_include_pad=True)`` on (..., H, W)."""
    import jax.lax as lax

    nd = x.ndim
    window = (1,) * (nd - 2) + (kernel, kernel)
    strides = (1,) * (nd - 2) + (stride, stride)
    pads = ((0, 0),) * (nd - 2) + ((padding, padding), (padding, padding))
    summed = lax.reduce_window(
        x.astype(jnp.float32), 0.0, lax.add, window, strides, pads
    )
    out = summed / float(kernel * kernel)
    return out.astype(x.dtype) if x.dtype != jnp.float32 else out
