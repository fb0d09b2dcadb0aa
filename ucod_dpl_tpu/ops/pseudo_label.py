"""Fixed-strategy pseudo-label cues: DINO attention + cosine-similarity
background segmentation.

JAX rebuild of ``data/utils/found_bkg_mask.py:4-86`` (CroW-style
per-head sparsity weighting of key descriptors, cosine similarity against the
least-attended patch) as a single batched XLA program, plus the host-side
small-component cleanup of ``generate_pseudo_label.refine_post_process``
(generate_pseudo_label.py:30-67).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ucod_dpl_tpu.ops.resize import interpolate_bilinear
from ucod_dpl_tpu.utils.components import connected_components

HI = jax.lax.Precision.HIGHEST


def compute_background_mask(
    cls_attention: jnp.ndarray,  # (B, nh, 1+N) last-layer CLS attention row
    key_tokens: jnp.ndarray,  # (B, 1+N, C) last-layer key projection
    grid_hw: Tuple[int, int],
    th_bkg: float,
    up_size: int | None = None,
    epsilon: float = 1e-10,
    apply_weights: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (bkg_mask, weighted_sim_map), both (B, h, w) float32.

    bkg_mask is 1 on background.  Math follows the reference exactly,
    including the batch-global max normalisation of the similarity map.
    """
    h, w = grid_hw
    if up_size is None:
        up_size = w
    nb, nh = cls_attention.shape[:2]
    c = key_tokens.shape[-1]
    dim = c // nh

    att = cls_attention[:, :, 1:].reshape(nb, nh, h, w).astype(jnp.float32)
    att = interpolate_bilinear(att, (up_size, up_size))
    n_up = up_size * up_size

    descs = key_tokens[:, 1:, :].astype(jnp.float32)  # (B, N, C)

    # CroW sparsity weighting: per-head fraction of above-mean attention
    threshold = jnp.mean(att.reshape(nb, -1), axis=1)
    q = (
        jnp.sum(att.reshape(nb, nh, n_up) > threshold[:, None, None], axis=2) / n_up
    )  # (B, nh)
    beta = jnp.log(jnp.sum(q + epsilon, axis=1)[:, None] / (q + epsilon))  # (B, nh)

    if apply_weights:
        descs = (descs.reshape(nb, -1, nh, dim) * beta[:, None, :, None]).reshape(
            nb, -1, c
        )

    # resample descriptors onto the up-sized grid (identity when equal)
    descs = descs.reshape(nb, h, w, c).transpose(0, 3, 1, 2)
    descs = interpolate_bilinear(descs, (up_size, up_size))
    descs = descs.transpose(0, 2, 3, 1).reshape(nb, n_up, c)

    descs = descs / jnp.maximum(
        jnp.linalg.norm(descs, axis=-1, keepdims=True), 1e-12
    )

    # reference pixel = least-attended patch (beta-weighted attention)
    att_w = att * beta[:, :, None, None] if apply_weights else att
    ref_idx = jnp.argmin(jnp.sum(att_w, axis=1).reshape(nb, -1), axis=-1)  # (B,)

    # only the reference row of the cosine-similarity matrix is needed:
    # (B, 1, C) @ (B, N, C)^T instead of the full (B, N, N) Gram
    ref_desc = jnp.take_along_axis(descs, ref_idx[:, None, None], axis=1)  # (B,1,C)
    sim_row = jnp.einsum("boc,bnc->bn", ref_desc, descs, precision=HI)  # (B, N)
    sim_row = sim_row.reshape(nb, up_size, up_size)

    bkg_mask = (sim_row > th_bkg).astype(jnp.float32)
    fn_mask = 1.0 - bkg_mask
    sim_map = 1.0 - sim_row
    sim_map = sim_map / (jnp.max(sim_map) + 1e-10)  # batch-global max, as reference
    return bkg_mask, sim_map * fn_mask


def refine_small_components(mask: np.ndarray, area_threshold: int = 4) -> np.ndarray:
    """Flip tiny connected components fully surrounded by the opposite label
    (host-side; behavioral port of refine_post_process)."""
    mask = np.asarray(mask).astype(np.uint8)
    squeezed = np.squeeze(mask)
    refined = squeezed.copy()
    num, labels = connected_components(squeezed)
    hh, ww = squeezed.shape
    for lab in range(1, num + 1):
        comp = labels == lab
        area = int(comp.sum())
        if area >= area_threshold:
            continue
        ys, xs = np.nonzero(comp)
        y, x = ys.min(), xs.min()
        height, width = ys.max() - y + 1, xs.max() - x + 1

        y0, x0 = max(y - 1, 0), max(x - 1, 0)
        y1, x1 = min(y + height + 1, hh), min(x + width + 1, ww)
        surround_box = refined[y0:y1, x0:x1]
        comp_box = comp[y0:y1, x0:x1]
        surrounding = surround_box[~comp_box]

        center_label = refined[y + height // 2, x + width // 2]
        opposite = 1 - center_label
        if surrounding.size and np.all(surrounding == opposite):
            refined[y : y + height, x : x + width][comp[y : y + height, x : x + width]] = (
                opposite
            )
    return refined.astype(np.float32)
