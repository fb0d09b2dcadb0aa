"""Int8 (W8A8) quantized linear ops for inference.

Plain XLA: int8 x int8 -> int32 matmuls (``preferred_element_type``), which
XLA hands to the card's int8 tensor cores where it can.  The 518px eval
composition is ~77% linear-layer FLOPs (q/k/v/out/fc1/fc2; attention stays
bf16), so an int8 path bounds at ~1.6x end-to-end (1 / (0.23 + 0.77/2))
before the dynamic-quantization overhead.  Its speed on the H100 is not
measured; a fused quantize+GEMM kernel for Hopper is on the ROADMAP.

Scheme (standard W8A8, the conservative end of the design space):
  * weights: per-OUTPUT-CHANNEL symmetric scales, computed once offline
    (``quantize_linear``) — column-wise max-abs / 127;
  * activations: per-TOKEN symmetric dynamic scales, computed in-graph
    (row-wise max-abs / 127) — per-token beats per-tensor on ViT
    activations whose outlier magnitude varies strongly across tokens;
  * accumulation in int32 (``preferred_element_type``), rescale in f32,
    output cast to the caller's compute dtype.

This path is strictly OPT-IN (serving/bench only; see
``serving.Predictor(quantize="int8")``).  Nothing on the parity-critical
cache/train/eval compositions routes through it.  Quality impact on the
real checkpoints is unmeasured until the environment ships weights —
mechanism accuracy is pinned vs the f32 forward in tests/test_quant.py.

No reference counterpart (the reference is fp16 end-to-end).
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

_EPS = 1e-12


def quantize_linear(p: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    """Quantize a ``{"w": (d_in, d_out), "b": (d_out,)}`` linear layer to
    int8 with per-output-channel symmetric scales.  The bias stays f32
    (it adds AFTER the rescale)."""
    w = p["w"].astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(w), axis=0) / 127.0, _EPS)  # (d_out,)
    w_q = jnp.clip(jnp.round(w / s), -127.0, 127.0).astype(jnp.int8)
    return {"w_q": w_q, "w_s": s, "b": p["b"].astype(jnp.float32)}


def quantize_act(x: jnp.ndarray):
    """Per-token symmetric dynamic int8 quantization of activations:
    ``(x_q int8, s_x f32 keepdims)`` with row scale = max-abs / 127.

    Split out of :func:`dense_w8a8` so callers applying SEVERAL quantized
    linears to the SAME input (the q/k/v projections share one LayerNorm
    output) quantize it once — the per-token max-abs/scale/round/cast is
    elementwise and memory work that the int8 matmul cannot hide, and sharing it is
    bitwise identical to repeating it (deterministic rounding)."""
    xf = x.astype(jnp.float32)
    s_x = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, _EPS)
    x_q = jnp.clip(jnp.round(xf / s_x), -127.0, 127.0).astype(jnp.int8)
    return x_q, s_x


def dense_w8a8_pre(
    x_q: jnp.ndarray, s_x: jnp.ndarray, qp: Dict[str, jnp.ndarray], out_dtype
) -> jnp.ndarray:
    """The matmul half of :func:`dense_w8a8` on pre-quantized activations
    (from :func:`quantize_act`): int32 accumulation, f32 rescale."""
    acc = jax.lax.dot_general(
        x_q,
        qp["w_q"],
        (((x_q.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    y = acc.astype(jnp.float32) * (s_x * qp["w_s"]) + qp["b"]
    return y.astype(out_dtype)


def dense_w8a8(x: jnp.ndarray, qp: Dict[str, jnp.ndarray], out_dtype) -> jnp.ndarray:
    """``x @ w + b`` with int8 weights and dynamically-quantized int8
    activations; int32 accumulation, f32 rescale.

    x: (..., d_in) any float dtype.  Per-token scale = max-abs over the
    feature axis of each row."""
    x_q, s_x = quantize_act(x)
    return dense_w8a8_pre(x_q, s_x, qp, out_dtype)


_VIT_LINEARS = ("q", "k", "v", "out", "fc1", "fc2")


def quantize_dino_linears(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every transformer-layer linear of a DINO params pytree
    (``models/dino.py`` layout).  Norms, layerscales, patch embed, position
    embeddings and the CLS token are NOT quantized — the forward keeps
    reading those from the original pytree.  jit this once at load time and
    pass the result alongside the original params."""
    return {
        "layers": [
            {name: quantize_linear(layer[name]) for name in _VIT_LINEARS}
            for layer in params["layers"]
        ]
    }
