"""DINO ViT feature extractor in pure JAX (DINOv1 `dino-vitb8` and DINOv2
`dinov2-base` architectures).

Rebuild of the reference's HuggingFace-hook feature extractor
(``data/utils/feature_extractor.py:31-59``): instead of a forward hook on the
last attention block's ``key`` Linear, the forward pass *returns* the last
block's key projection directly, plus (optionally) the CLS-row attention
probabilities of the last layer needed by pseudo-label generation
(``generate_pseudo_label.py:75-89``) — without ever materialising the full
(L, L) attention matrix for the other 11 layers.

Design:
  * pure functions over an explicit params pytree; f32 params, configurable
    compute dtype (bf16 on the GPU, ``ucod_dpl_tpu.device``);
  * attention runs through :mod:`ucod_dpl_tpu.ops.attention` (cuDNN flash
    attention on the GPU, XLA's attention elsewhere);
  * position embeddings are bicubic-interpolated exactly like HF
    (``modeling_dinov2.interpolate_pos_encoding``) so cached features are
    interchangeable with the torch pipeline;
  * weights load from local HuggingFace checkpoints (safetensors or .bin)
    via :func:`convert_hf_state_dict` — no network access required.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ucod_dpl_tpu.ops.attention import multi_head_attention
from ucod_dpl_tpu.ops.resize import interpolate_bicubic

HI = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class DinoConfig:
    variant: str = "dinov2"  # "dinov1" | "dinov2"
    image_size: int = 518
    patch_size: int = 14
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6
    use_layerscale: bool = True  # dinov2 only

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def dinov2_base() -> "DinoConfig":
        return DinoConfig(
            variant="dinov2",
            image_size=518,
            patch_size=14,
            layer_norm_eps=1e-6,
            use_layerscale=True,
        )

    @staticmethod
    def dinov1_vitb8() -> "DinoConfig":
        return DinoConfig(
            variant="dinov1",
            image_size=224,
            patch_size=8,
            layer_norm_eps=1e-12,
            use_layerscale=False,
        )

    @staticmethod
    def from_type(type_name: str) -> "DinoConfig":
        if type_name == "dinov2":
            return DinoConfig.dinov2_base()
        if type_name == "dinov1":
            return DinoConfig.dinov1_vitb8()
        raise ValueError(f"Unknown feature extractor type: {type_name}")


# ---------------------------------------------------------------------------
# init / weight conversion
# ---------------------------------------------------------------------------

def _linear(key, d_in, d_out):
    k1, k2 = jax.random.split(key)
    s = 1.0 / np.sqrt(d_in)
    return {
        "w": jax.random.uniform(k1, (d_in, d_out), minval=-s, maxval=s, dtype=jnp.float32),
        "b": jax.random.uniform(k2, (d_out,), minval=-s, maxval=s, dtype=jnp.float32),
    }


def init_dino(key: jax.Array, cfg: DinoConfig) -> Dict[str, Any]:
    """Random-init params (used for tests / training-free dev; real use loads
    converted HF weights)."""
    d = cfg.hidden_size
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
    keys = jax.random.split(key, cfg.num_layers + 3)
    params: Dict[str, Any] = {
        "patch_embed": {
            "kernel": jax.random.normal(keys[0], (cfg.patch_size, cfg.patch_size, 3, d)) * 0.02,
            "bias": jnp.zeros((d,)),
        },
        "cls_token": jax.random.normal(keys[1], (1, 1, d)) * 0.02,
        "pos_embed": jax.random.normal(keys[2], (1, n_pos, d)) * 0.02,
        "layers": [],
        "final_norm": {"scale": jnp.ones((d,)), "bias": jnp.zeros((d,))},
    }
    for i in range(cfg.num_layers):
        lk = jax.random.split(keys[3 + i], 6)
        layer = {
            "norm1": {"scale": jnp.ones((d,)), "bias": jnp.zeros((d,))},
            "q": _linear(lk[0], d, d),
            "k": _linear(lk[1], d, d),
            "v": _linear(lk[2], d, d),
            "out": _linear(lk[3], d, d),
            "norm2": {"scale": jnp.ones((d,)), "bias": jnp.zeros((d,))},
            "fc1": _linear(lk[4], d, d * cfg.mlp_ratio),
            "fc2": _linear(lk[5], d * cfg.mlp_ratio, d),
        }
        if cfg.use_layerscale:
            layer["ls1"] = jnp.ones((d,))
            layer["ls2"] = jnp.ones((d,))
        params["layers"].append(layer)
    return params


def convert_hf_state_dict(sd: Dict[str, np.ndarray], cfg: DinoConfig) -> Dict[str, Any]:
    """Convert a HuggingFace Dinov2Model / ViTModel state dict (numpy values)
    into our params pytree."""

    def j(x):
        return jnp.asarray(np.asarray(x, dtype=np.float32))

    def lin(prefix):
        return {"w": j(sd[f"{prefix}.weight"]).T, "b": j(sd[f"{prefix}.bias"])}

    def ln(prefix):
        return {"scale": j(sd[f"{prefix}.weight"]), "bias": j(sd[f"{prefix}.bias"])}

    if cfg.variant == "dinov2":
        emb = "embeddings"
        patch_proj = f"{emb}.patch_embeddings.projection"
        pos_key = f"{emb}.position_embeddings"
        norm1, norm2 = "norm1", "norm2"
        attn = "attention.attention"
        attn_out = "attention.output.dense"
        fc1, fc2 = "mlp.fc1", "mlp.fc2"
        final_norm = "layernorm"
    else:  # HF ViTModel (dinov1)
        emb = "embeddings"
        patch_proj = f"{emb}.patch_embeddings.projection"
        pos_key = f"{emb}.position_embeddings"
        norm1, norm2 = "layernorm_before", "layernorm_after"
        attn = "attention.attention"
        attn_out = "attention.output.dense"
        fc1, fc2 = "intermediate.dense", "output.dense"
        final_norm = "layernorm"

    params: Dict[str, Any] = {
        "patch_embed": {
            # OIHW conv kernel -> HWIO
            "kernel": jnp.transpose(j(sd[f"{patch_proj}.weight"]), (2, 3, 1, 0)),
            "bias": j(sd[f"{patch_proj}.bias"]),
        },
        "cls_token": j(sd[f"{emb}.cls_token"]),
        "pos_embed": j(sd[pos_key]),
        "layers": [],
        "final_norm": ln(final_norm),
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        layer = {
            "norm1": ln(f"{p}.{norm1}"),
            "q": lin(f"{p}.{attn}.query"),
            "k": lin(f"{p}.{attn}.key"),
            "v": lin(f"{p}.{attn}.value"),
            "out": lin(f"{p}.{attn_out}"),
            "norm2": ln(f"{p}.{norm2}"),
            "fc1": lin(f"{p}.{fc1}"),
            "fc2": lin(f"{p}.{fc2}"),
        }
        if cfg.use_layerscale:
            layer["ls1"] = j(sd[f"{p}.layer_scale1.lambda1"])
            layer["ls2"] = j(sd[f"{p}.layer_scale2.lambda1"])
        params["layers"].append(layer)
    return params


def export_hf_state_dict(params: Dict[str, Any], cfg: DinoConfig) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_hf_state_dict`: our params pytree -> a
    HuggingFace-layout numpy state dict (Dinov2Model / ViTModel key names).
    Round-trips bit-exactly through ``convert_hf_state_dict`` — used to
    export LoRA-merged backbones as standard HF checkpoints that
    ``load_hf_checkpoint`` (and HF itself) can consume."""

    def n(x):
        return np.asarray(x, dtype=np.float32)

    if cfg.variant == "dinov2":
        norm1, norm2 = "norm1", "norm2"
        fc1, fc2 = "mlp.fc1", "mlp.fc2"
    else:
        norm1, norm2 = "layernorm_before", "layernorm_after"
        fc1, fc2 = "intermediate.dense", "output.dense"

    sd: Dict[str, np.ndarray] = {
        "embeddings.patch_embeddings.projection.weight": np.ascontiguousarray(
            np.transpose(n(params["patch_embed"]["kernel"]), (3, 2, 0, 1))  # HWIO -> OIHW
        ),
        "embeddings.patch_embeddings.projection.bias": n(params["patch_embed"]["bias"]),
        "embeddings.cls_token": n(params["cls_token"]),
        "embeddings.position_embeddings": n(params["pos_embed"]),
        "layernorm.weight": n(params["final_norm"]["scale"]),
        "layernorm.bias": n(params["final_norm"]["bias"]),
    }

    def put_lin(prefix, p):
        sd[f"{prefix}.weight"] = n(p["w"]).T.copy()
        sd[f"{prefix}.bias"] = n(p["b"])

    def put_ln(prefix, p):
        sd[f"{prefix}.weight"] = n(p["scale"])
        sd[f"{prefix}.bias"] = n(p["bias"])

    for i, layer in enumerate(params["layers"]):
        p = f"encoder.layer.{i}"
        put_ln(f"{p}.{norm1}", layer["norm1"])
        put_lin(f"{p}.attention.attention.query", layer["q"])
        put_lin(f"{p}.attention.attention.key", layer["k"])
        put_lin(f"{p}.attention.attention.value", layer["v"])
        put_lin(f"{p}.attention.output.dense", layer["out"])
        put_ln(f"{p}.{norm2}", layer["norm2"])
        put_lin(f"{p}.{fc1}", layer["fc1"])
        put_lin(f"{p}.{fc2}", layer["fc2"])
        if cfg.use_layerscale:
            sd[f"{p}.layer_scale1.lambda1"] = n(layer["ls1"])
            sd[f"{p}.layer_scale2.lambda1"] = n(layer["ls2"])
    return sd


def save_hf_checkpoint(path: str, params: Dict[str, Any], cfg: DinoConfig) -> None:
    """Write the params pytree as a HF-layout .safetensors file."""

    from ucod_dpl_tpu.models.safetensors_io import save_file_atomic

    save_file_atomic(export_hf_state_dict(params, cfg), path)


def load_hf_checkpoint(path: str, cfg: DinoConfig) -> Dict[str, Any]:
    """Load params from a local HuggingFace checkpoint directory/file
    (model.safetensors or pytorch_model.bin)."""
    if os.path.isdir(path):
        for cand in ("model.safetensors", "pytorch_model.bin"):
            f = os.path.join(path, cand)
            if os.path.exists(f):
                path = f
                break
        else:
            raise FileNotFoundError(f"No model weights found under {path}")
    if path.endswith(".safetensors"):
        from ucod_dpl_tpu.models.safetensors_io import load_file

        sd = load_file(path)
    else:
        import torch

        sd = {
            k: v.detach().cpu().numpy()
            for k, v in torch.load(path, map_location="cpu", weights_only=True).items()
        }
    # strip potential "vit." / "dinov2." prefixes
    for pref in ("vit.", "dinov2.", "model."):
        if any(k.startswith(pref) for k in sd):
            sd = {k[len(pref):] if k.startswith(pref) else k: v for k, v in sd.items()}
    return convert_hf_state_dict(sd, cfg)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layernorm(x: jnp.ndarray, p: Dict[str, jnp.ndarray], eps: float) -> jnp.ndarray:
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean((xf - mean) ** 2, axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).astype(x.dtype)


def _dense(x: jnp.ndarray, p: Dict[str, jnp.ndarray], dtype) -> jnp.ndarray:
    if dtype == jnp.bfloat16:
        # bf16-native epilogue: the matmul still accumulates in f32, but the
        # activation is written once in bf16 (half the device-memory traffic
        # of an f32 output plus a separate downcast)
        return jnp.dot(x, p["w"].astype(dtype)) + p["b"].astype(dtype)
    return (
        jnp.dot(x, p["w"].astype(dtype), preferred_element_type=jnp.float32).astype(dtype)
        + p["b"].astype(dtype)
    )


def _qkv_concat(h: jnp.ndarray, layer: Dict[str, Any], dtype):
    """q, k, v from ONE (D, 3D) GEMM on the LayerNorm output — faster end to
    end than three (D, D) GEMMs on the H100 (PERF.md, "Kernel decisions on
    H100"); the concatenated weight is built per call, a few MB."""
    w = jnp.concatenate([layer[t]["w"] for t in ("q", "k", "v")], axis=1)
    b = jnp.concatenate([layer[t]["b"] for t in ("q", "k", "v")])
    return tuple(jnp.split(_dense(h, {"w": w, "b": b}, dtype), 3, axis=-1))


def interpolate_pos_embed(
    pos_embed: jnp.ndarray, grid_hw: Tuple[int, int], orig_grid: int
) -> jnp.ndarray:
    """HF-compatible bicubic interpolation of (1, 1+N, D) position embeddings
    to a (h, w) patch grid; CLS position is passed through."""
    h, w = grid_hw
    if h == w and h * w == pos_embed.shape[1] - 1:
        return pos_embed
    cls_pos = pos_embed[:, :1]
    patch_pos = pos_embed[:, 1:]
    d = pos_embed.shape[-1]
    patch_pos = patch_pos.reshape(1, orig_grid, orig_grid, d).transpose(0, 3, 1, 2)
    patch_pos = interpolate_bicubic(patch_pos.astype(jnp.float32), (h, w))
    patch_pos = patch_pos.transpose(0, 2, 3, 1).reshape(1, h * w, d)
    return jnp.concatenate([cls_pos, patch_pos.astype(pos_embed.dtype)], axis=1)


def dino_forward(
    params: Dict[str, Any],
    pixels: jnp.ndarray,
    cfg: DinoConfig,
    *,
    want_cls_attention: bool = False,
    compute_dtype: jnp.dtype = jnp.float32,
    remat: bool = False,
    tp_shard: Optional[tuple] = None,  # (Mesh, axis): heads sharded over axis
    sp_shard: Optional[tuple] = None,  # (Mesh, axis): TOKENS sharded over axis
    key_fold: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
    quant: Optional[Dict[str, Any]] = None,
) -> Dict[str, jnp.ndarray]:
    """Run the ViT and return the reference hook contract.

    Args:
      params: pytree from :func:`init_dino` / :func:`load_hf_checkpoint`.
      pixels: (B, H, W, 3) normalised image batch, NHWC.
      want_cls_attention: also return last-layer CLS->token attention probs
        (B, num_heads, L) — used by pseudo-label generation.
      key_fold: optional ``(w, b)`` with ``w: (hidden, F)``, ``b: (F,)``.
        When given, the LAST layer computes only ``LN1(x) @ w + b`` — the
        key projection pre-composed with a downstream linear map (e.g. the
        DBA decoder's 1x1 decoupling: ``w = Wk @ Wd``, ``b = bk @ Wd + bd``)
        — and the layer's q/v projections, attention, MLP and the final
        norm are never traced.  This is the live-inference fast path
        (feature extraction feeding straight into the decoder): one bf16
        768->F matmul instead of a 768->768 projection + f32 materialised
        key map + separate decoupling matmul.  Mutually exclusive with
        ``want_cls_attention`` (which needs the last layer's full q/k).
      sp_shard: optional ``(Mesh, axis)`` — SEQUENCE-parallel backbone: the
        token dim is padded to the axis size, sharded over it (GSPMD handles
        every token-local op from one constraint on the residual stream) and
        attention runs as ring attention (``parallel/sp.py`` — k/v chunks
        rotate via ppermute with an online-softmax merge, so no chip ever
        holds the full (L, L) score matrix).  The resolution-scaling axis
        for high-res extraction AND fine-tuning: the ring carries its own
        flash-style VJP (``parallel/sp.py::_local_ring_bwd``), so
        differentiated paths (LoRA training) shard their activation memory
        over the same axis.  COMPOSES with ``tp_shard`` (2D-sharded
        attention: heads over the model axis, tokens ringing over seq
        within each head group — both shards must name the same Mesh).
        Mutually exclusive with ``want_cls_attention`` (the pseudo-label
        parity contract runs unsharded) and with ``quant``.
      quant: optional pytree from :func:`ucod_dpl_tpu.ops.quant.
        quantize_dino_linears` — routes every transformer-layer linear
        (q/k/v/out/fc1/fc2, and the key_fold matmul) through int8 W8A8
        matmuls with int32 accumulation.  Opt-in inference-only path (serving/bench);
        incompatible with ``tp_shard`` (GSPMD-sharded weights) and with
        ``want_cls_attention`` (pseudo-label generation is a bitwise
        parity contract).

    Returns dict with:
      key_features: (B, h, w, hidden) last block's key projection, CLS
        dropped, reshaped to the patch grid (the reference hook contract,
        ``feature_extractor.py:46-59``);
      key_tokens: (B, 1+N, hidden) raw key projection incl. CLS;
      cls_attention: present when requested;
      folded_features: (B, h, w, F), only when ``key_fold`` is given (then
        key_features/key_tokens/last_hidden are absent).
    """
    assert not (key_fold is not None and want_cls_attention), (
        "key_fold skips the last layer's q projection; CLS attention "
        "requires the unfolded forward"
    )
    if sp_shard is not None:
        # ValueError (not assert) for the same -O reason as the quant guards
        if tp_shard is not None and tp_shard[0] is not sp_shard[0]:
            raise ValueError(
                "sp_shard + tp_shard must share one Mesh (2D-sharded "
                "attention rings tokens and shards heads on the same device "
                "grid)"
            )
        if want_cls_attention:
            raise ValueError(
                "pseudo-label generation is a bitwise parity contract; "
                "run it on the unsharded forward"
            )
        if quant is not None:
            raise ValueError("int8 path is single-chip; sp_shard shards tokens")
    if quant is not None:
        # ValueError, not assert: these guards protect a *parity contract*
        # and must survive `python -O` (a stripped assert would let the TP
        # path consume unsharded int8 outputs, or emit CLS attention from
        # quantized q/k into the bitwise pseudo-label pipeline)
        if tp_shard is not None:
            raise ValueError(
                "int8 path is single-chip (weights are GSPMD-sharded under TP)"
            )
        if want_cls_attention:
            raise ValueError(
                "pseudo-label generation is a bitwise parity contract; "
                "run it on the full-precision forward"
            )
        from ucod_dpl_tpu.ops.quant import (
            dense_w8a8,
            dense_w8a8_pre,
            quantize_act,
            quantize_linear,
        )
    b, img_h, img_w, _ = pixels.shape
    gh, gw = img_h // cfg.patch_size, img_w // cfg.patch_size
    dtype = compute_dtype

    # Patch embed: when the width divides the patch size, the contiguous
    # (W, C) tail reshapes freely to (W/p, p*C) — each patch row's p pixels
    # x C channels in one 42-wide block — and the patch embed becomes a
    # (p, 1)-kernel conv over 42 input channels: the same math (kernel
    # reshaped to match the (kw, c) order) without the 3-channel conv's
    # padding of its tiny channel dim, and with no transpose.
    pe = params["patch_embed"]["kernel"].astype(dtype)
    px = pixels.astype(dtype)
    if img_w % cfg.patch_size == 0:
        px = px.reshape(b, img_h, gw, cfg.patch_size * 3)
        pe = pe.reshape(cfg.patch_size, 1, cfg.patch_size * 3, cfg.hidden_size)
        strides = (cfg.patch_size, 1)
    else:
        strides = (cfg.patch_size, cfg.patch_size)
    # bf16 mode outputs bf16 directly (XLA still accumulates f32 internally,
    # so the value is identical to an f32-preferred output + downcast) — an
    # explicit preferred_element_type=f32 + astype would hand the conv's
    # FILTER-gradient a f32 cotangent against bf16 operands, which
    # conv_general_dilated rejects (differentiated-through-backbone paths:
    # full fine-tuning, selfcheck #6)
    conv_kwargs = {} if dtype == jnp.bfloat16 else {"preferred_element_type": jnp.float32}
    x = jax.lax.conv_general_dilated(
        px,
        pe,
        window_strides=strides,
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        **conv_kwargs,
    ).astype(dtype)
    x = x + params["patch_embed"]["bias"].astype(dtype)
    x = x.reshape(b, gh * gw, cfg.hidden_size)

    cls = jnp.broadcast_to(params["cls_token"].astype(dtype), (b, 1, cfg.hidden_size))
    x = jnp.concatenate([cls, x], axis=1)

    orig_grid = int(round((params["pos_embed"].shape[1] - 1) ** 0.5))
    pos = interpolate_pos_embed(params["pos_embed"], (gh, gw), orig_grid)
    x = x + pos.astype(dtype)

    # sequence-parallel entry: pad tokens to the ring size (ViT lengths are
    # 1 + grid^2 — 2917 at 756px is prime), mask the padding, and constrain
    # the residual stream's token dim onto the axis; GSPMD shards every
    # token-local op (LN / projections / MLP) from this one annotation
    seq_len = x.shape[1]
    sp_valid = None
    if sp_shard is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        sp_mesh, sp_axis = sp_shard
        sp_n = sp_mesh.shape[sp_axis]
        padded = -(-seq_len // sp_n) * sp_n
        if padded != seq_len:
            x = jnp.pad(x, ((0, 0), (0, padded - seq_len), (0, 0)))
        sp_valid = jnp.broadcast_to(jnp.arange(padded) < seq_len, (b, padded))
        x = jax.lax.with_sharding_constraint(
            x, NamedSharding(sp_mesh, _P(None, sp_axis, None))
        )

    scale = 1.0 / np.sqrt(cfg.head_dim)
    n_layers = len(params["layers"])
    out: Dict[str, jnp.ndarray] = {}

    def layer_fn(x, layer, is_last: bool):
        aux: Dict[str, jnp.ndarray] = {}
        h = _layernorm(x, layer["norm1"], cfg.layer_norm_eps)
        if "_q8" in layer:
            # int8 W8A8: the shared LayerNorm output is quantized once for
            # the three projections
            h_q, h_s = quantize_act(h)
            q = dense_w8a8_pre(h_q, h_s, layer["_q8"]["q"], dtype)
            k = dense_w8a8_pre(h_q, h_s, layer["_q8"]["k"], dtype)
            v = dense_w8a8_pre(h_q, h_s, layer["_q8"]["v"], dtype)
        elif tp_shard is None and sp_shard is None and not is_last:
            q, k, v = _qkv_concat(h, layer, dtype)
        else:
            # three separate projections: the last layer's, because
            # feature-extraction programs use only its k and XLA then drops
            # its q and v; and under TP/SP, whose column-sharded weights a
            # concatenation would have to regather
            q = _dense(h, layer["q"], dtype)
            k = _dense(h, layer["k"], dtype)
            v = _dense(h, layer["v"], dtype)

        if is_last:
            aux["key_tokens"] = k
            if want_cls_attention:
                # CLS-row attention probs only: (B, nh, 1, d) @ (B, nh, d, L)
                qh = q[:, :1, :].reshape(b, 1, cfg.num_heads, cfg.head_dim)
                kh = k.reshape(b, -1, cfg.num_heads, cfg.head_dim)
                logits = (
                    jnp.einsum("bqhd,bkhd->bhqk", qh, kh, precision=HI).astype(jnp.float32)
                    * scale
                )
                aux["cls_attention"] = jax.nn.softmax(logits, axis=-1)[:, :, 0, :]

        if sp_shard is not None:
            from ucod_dpl_tpu.parallel.sp import ring_attention

            # 2D (SP x TP) when tp_shard is also set: the ring is head-local,
            # so heads shard over the model axis INSIDE the same shard_map —
            # tokens ring over seq within each head group, zero extra
            # communication (parallel/sp.py::ring_attention h_axis)
            attn = ring_attention(
                q, k, v, cfg.num_heads, scale=scale,
                mesh=sp_shard[0], axis=sp_shard[1], valid=sp_valid,
                h_axis=tp_shard[1] if tp_shard is not None else None,
            )
        elif tp_shard is not None:
            from ucod_dpl_tpu.ops.attention import tp_multi_head_attention

            attn = tp_multi_head_attention(
                q, k, v, cfg.num_heads, scale=scale,
                mesh=tp_shard[0], axis=tp_shard[1],
            )
        else:
            attn = multi_head_attention(q, k, v, cfg.num_heads, scale=scale)
        if "_q8" in layer:
            attn = dense_w8a8(attn, layer["_q8"]["out"], dtype)
        else:
            attn = _dense(attn, layer["out"], dtype)
        if cfg.use_layerscale:
            attn = attn * layer["ls1"].astype(dtype)
        x = x + attn

        if "_q8" in layer:
            # int8 MLP: gelu is tanh-approximate here at every precision
            # (~1e-3 off exact erf, far below the int8 quantization noise)
            h2 = _layernorm(x, layer["norm2"], cfg.layer_norm_eps)
            h_q, h_s = quantize_act(h2)
            g = jax.nn.gelu(
                dense_w8a8_pre(h_q, h_s, layer["_q8"]["fc1"], jnp.float32),
                approximate=True,
            )
            g_q, g_s = quantize_act(g)
            h2 = dense_w8a8_pre(g_q, g_s, layer["_q8"]["fc2"], dtype)
        else:
            h2 = _layernorm(x, layer["norm2"], cfg.layer_norm_eps)
            h2 = _dense(h2, layer["fc1"], dtype)
            if dtype == jnp.bfloat16:
                # tanh-approx GELU in bf16: a ~1e-3 activation difference,
                # far below bf16 noise, for a much cheaper elementwise pass.
                # The f32 path keeps exact erf for bit-parity with the HF
                # reference.
                h2 = jax.nn.gelu(h2, approximate=True)
            else:
                h2 = jax.nn.gelu(
                    h2.astype(jnp.float32), approximate=False
                ).astype(dtype)
            h2 = _dense(h2, layer["fc2"], dtype)
        if cfg.use_layerscale:
            h2 = h2 * layer["ls2"].astype(dtype)
        return x + h2, aux

    # remat trades recompute for activation memory when the backbone is part
    # of a differentiated path (LoRA fine-tuning).  Modes:
    #   False/"none"  — no remat: every activation saved (cheapest compute,
    #                   highest memory);
    #   True/"layer"  — full layer-granularity remat: only block inputs
    #                   saved, the whole layer forward re-executes in the
    #                   backward (~+1 forward of matmul work);
    #   "dots"        — policy remat: matmul outputs are saved, only
    #                   elementwise chains (LN, gelu, residual adds) replay.
    # None of them has been timed on the H100 (not measured).
    if isinstance(remat, str):
        if remat in ("none", ""):
            run_layer = layer_fn
        elif remat == "layer":
            run_layer = jax.checkpoint(layer_fn, static_argnums=(2,))
        elif remat == "dots":
            run_layer = jax.checkpoint(
                layer_fn,
                static_argnums=(2,),
                policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable,
            )
        else:
            raise ValueError(
                f"remat={remat!r}: expected False/'none', True/'layer', or 'dots'"
            )
    else:
        run_layer = jax.checkpoint(layer_fn, static_argnums=(2,)) if remat else layer_fn

    for i, layer in enumerate(params["layers"]):
        is_last = i == n_layers - 1
        if quant is not None:
            layer = {**layer, "_q8": quant["layers"][i]}
        if is_last and key_fold is not None:
            h = _layernorm(x, layer["norm1"], cfg.layer_norm_eps)
            fw, fb = key_fold
            if quant is not None:
                # the fold weight is data-dependent (key proj x decoder
                # decoupling), so it is quantized in-graph — a 768xF
                # column sweep, noise next to the forward it replaces
                folded = dense_w8a8(h, quantize_linear({"w": fw, "b": fb}), dtype)
            else:
                # mirror _dense's accumulation contract: f32 accumulation in
                # the f32 parity path
                folded = _dense(h, {"w": fw, "b": fb}, dtype)
            # [1:seq_len]: drop CLS and (under sp_shard) the ring padding
            out["folded_features"] = folded[:, 1:seq_len, :].reshape(
                b, gh, gw, fw.shape[-1]
            )
            return out
        x, aux = run_layer(x, layer, is_last)
        if aux:
            out.update(aux)
    if sp_shard is not None and x.shape[1] != seq_len:
        x = x[:, :seq_len]
        if "key_tokens" in out:
            out["key_tokens"] = out["key_tokens"][:, :seq_len]
    if "key_tokens" in out:
        out["key_features"] = out["key_tokens"][:, 1:, :].reshape(
            b, gh, gw, cfg.hidden_size
        )

    out["last_hidden"] = _layernorm(x, params["final_norm"], cfg.layer_norm_eps)
    return out
