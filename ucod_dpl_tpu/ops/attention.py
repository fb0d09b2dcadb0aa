"""Multi-head attention for the DINO ViT.

One call, ``jax.nn.dot_product_attention``, on the free (B, L, heads,
head_dim) view of the packed (B, L, D) projections.  On the GPU in bf16 it
runs cuDNN's fused flash attention (forward and backward), so the (L, L)
scores never reach device memory; float32 and the CPU take XLA's attention.
The choice is made in :func:`ucod_dpl_tpu.device.attention_implementation`
from the platform, the dtype and the head width — never from a flag — and a
shape cuDNN refuses raises instead of switching implementation.

ViT sequence lengths (1370, 2917, 5477 at 518/756/1036px) are used as they
are: no padding, so no padded rows exist whose contents could reach the
output.

:func:`_xla_attention` is the plain reference the tests and the on-card
smoke compare against.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.device import attention_implementation


def _xla_attention(q_h, k_h, v_h, scale: float):
    """Reference attention on the per-head (B*heads, L, head_dim) layout:
    f32 scores and softmax, probabilities cast back to the input dtype."""
    s = (
        jnp.einsum("bqd,bkd->bqk", q_h, k_h, preferred_element_type=jnp.float32)
        * scale
    )
    p = jax.nn.softmax(s.astype(jnp.float32), axis=-1).astype(q_h.dtype)
    return jnp.einsum("bqk,bkd->bqd", p, v_h, preferred_element_type=jnp.float32).astype(
        q_h.dtype
    )


def multi_head_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    num_heads: int,
    *,
    scale: float,
) -> jnp.ndarray:
    """(B, L, D) q/k/v projections -> (B, L, D) attention output.
    Differentiable (cuDNN and XLA both carry a backward)."""
    b, l, d_model = q.shape
    hd = d_model // num_heads
    impl = attention_implementation(q.dtype, hd)
    heads = lambda x: x.reshape(b, l, num_heads, hd)  # noqa: E731 — a free view
    o = jax.nn.dot_product_attention(
        heads(q), heads(k), heads(v), scale=float(scale), implementation=impl
    )
    return o.reshape(b, l, d_model)


def tp_multi_head_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    num_heads: int,
    *,
    scale: float,
    mesh,
    axis: str = "model",
) -> jnp.ndarray:
    """Tensor-parallel attention: D (=heads) sharded over ``axis``.

    Attention is head-local, so each shard runs on its own head slice with
    no communication — shard_map keeps GSPMD from gathering the full
    projection.  Requires num_heads divisible by the axis size."""
    tp = mesh.shape[axis]
    if tp == 1:
        return multi_head_attention(q, k, v, num_heads, scale=scale)
    assert num_heads % tp == 0, f"{num_heads} heads not divisible by {axis}={tp}"
    from jax.sharding import PartitionSpec as P

    spec = P(None, None, axis)

    def local_attn(ql, kl, vl):
        return multi_head_attention(ql, kl, vl, num_heads // tp, scale=scale)

    return jax.shard_map(
        local_attn, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        # the cuDNN custom call's output carries no varying-axes annotation;
        # the computation is head-local, so there is nothing varying to check
        check_vma=False,
    )(q, k, v)
