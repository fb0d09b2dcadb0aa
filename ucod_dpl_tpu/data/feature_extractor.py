"""Device-side DINO feature extraction service.

Counterpart of the reference ``backbone`` wrapper
(``data/utils/feature_extractor.py:31-59``): batched jitted forwards per
input resolution (compiled once, cached), bf16 compute on the GPU, and the
key/attention outputs returned functionally instead of via hooks.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ucod_dpl_tpu.device import default_compute_dtype
from ucod_dpl_tpu.models.dino import (
    DinoConfig,
    dino_forward,
    init_dino,
    load_hf_checkpoint,
)
from ucod_dpl_tpu.utils import get_logger


def _candidate_weight_paths(fe_cfg) -> list:
    """Weight search order mirroring the reference's local->cache fallback
    (``feature_extractor.py:15-29``)."""
    name = fe_cfg.backbone.split("/")[-1]
    cands = []
    for base in (fe_cfg.get("backbone_weights"), fe_cfg.get("backbone_weight_base")):
        if not base:
            continue
        base = Path(os.path.expanduser(base))
        cands += [base, base / name, base / fe_cfg.backbone.replace("/", "--")]
    return cands


@functools.lru_cache(maxsize=16)
def _make_extract_fn(
    config: DinoConfig, compute_dtype, want_attn: bool, tp_shard=None, sp_shard=None
):
    """Module-level cached jit builder: extractors are constructed per
    Runner (one per dataset in scripts/eval.py) and per-instance jit caches
    would re-trace + re-hit the compilation cache on every dataset.

    ``tp_shard``: optional ``(Mesh, axis_name)`` — tensor-parallel backbone
    (Megatron column/row-sharded projections + shard_map head-local
    attention).  Mesh is hashable, so it participates in the cache key.

    ``sp_shard``: optional ``(Mesh, axis_name)`` — sequence-parallel backbone
    (token dim sharded + ring attention; ``parallel/sp.py``).  The
    CLS-attention forward (pseudo-label parity contract) always runs
    unsharded, same policy as the int8 path."""
    # Outputs stay in the COMPUTE dtype on the wire: in bf16 the key
    # projection's bf16 epilogue means f32 values would be exact upcasts of
    # bf16 — casting on device would double the device-to-host bytes for
    # zero information.  Hosts upcast to f32.
    if want_attn:

        def fwd(params, pixels, qparams):
            out = dino_forward(
                params,
                pixels,
                cfg=config,
                want_cls_attention=True,
                compute_dtype=compute_dtype,
                tp_shard=tp_shard,
                quant=qparams,
            )
            return (
                out["key_tokens"],
                out["key_features"],
                out["cls_attention"].astype(jnp.float32),
            )

    else:

        def fwd(params, pixels, qparams):
            out = dino_forward(
                params, pixels, cfg=config, compute_dtype=compute_dtype,
                tp_shard=tp_shard, sp_shard=sp_shard, quant=qparams,
            )
            return out["key_features"]

    return jax.jit(fwd)


class FeatureExtractor:
    """Frozen DINO backbone exposing the key-feature hook contract."""

    def __init__(
        self,
        fe_cfg,
        compute_dtype: Optional[jnp.dtype] = None,
        seed: int = 0,
        strict: Optional[bool] = None,
        mesh=None,
        quantize: Optional[str] = None,
    ):
        """``strict`` (or ``fe_cfg.strict_weights``): missing pretrained
        weights raise instead of silently falling back to random init — a
        silent fallback is a quality catastrophe in serving/eval contexts.

        ``mesh``: the runner's device mesh.  When its ``model`` axis is >1
        the backbone runs TENSOR-PARALLEL — params sharded Megatron-style
        (``parallel/tp.py``), head-local shard_map attention — and batches
        are sharded over the ``data`` axis; config surface:
        ``tpu_cfg.mesh = {"data": N, "model": M}``.  When a ``seq`` axis is
        >1 the backbone runs SEQUENCE-PARALLEL instead — tokens sharded,
        ring attention (``parallel/sp.py``), params replicated; the
        resolution-scaling mode for high-res extraction
        (``tpu_cfg.mesh = {"data": N, "seq": M}``).

        ``compute_dtype``: None takes the platform default
        (``ucod_dpl_tpu.device.default_compute_dtype``: bf16 on the GPU).

        ``quantize="int8"``: W8A8 backbone linears with int8 matmuls
        (``ops/quant.py``) — an opt-in SERVING path.  Parity surfaces
        refuse it: dataset cache builds (caches must regenerate bitwise),
        CLS-attention extraction (pseudo-label contract), and TP."""
        self.fe_cfg = fe_cfg
        self.strict = fe_cfg.get("strict_weights", False) if strict is None else strict
        self.config = DinoConfig.from_type(fe_cfg.type)
        arch = fe_cfg.get("arch")  # optional architecture overrides (tests/small runs)
        if arch:
            import dataclasses

            self.config = dataclasses.replace(self.config, **dict(arch))
        self.logger = get_logger()
        if compute_dtype is None:
            compute_dtype = default_compute_dtype()
        self.compute_dtype = compute_dtype
        self.mesh = mesh
        self.tp_shard = None
        if mesh is not None and mesh.shape.get("model", 1) > 1:
            import jax as _jax

            if _jax.process_count() > 1:
                # extraction is PER-PROCESS work (each process sweeps its
                # dataset shard; LookTwice crops are per-image local) — a
                # process-spanning TP mesh would turn every extract() into
                # a collective all processes must join in lockstep, which
                # the data-sharded eval loops do not do.  TP extraction is
                # single-process (multi-device) only.
                raise NotImplementedError(
                    "tensor-parallel feature extraction requires a "
                    "single-process mesh (TP over the chips of one host); "
                    "use data parallelism across processes"
                )
            self.tp_shard = (mesh, "model")
            if self.config.num_heads % mesh.shape["model"]:
                raise ValueError(
                    f"{self.config.num_heads} attention heads not divisible "
                    f"by tpu_cfg.mesh model={mesh.shape['model']}"
                )
        self.sp_shard = None
        if mesh is not None and mesh.shape.get("seq", 1) > 1:
            # tp_shard composes: 2D-sharded attention (heads over `model`,
            # tokens ringing over `seq` — dino_forward routes the combined
            # case through ring_attention's h_axis)
            if jax.process_count() > 1:
                # same lockstep argument as TP above: extract() must stay
                # per-process work under the data-sharded eval loops
                raise NotImplementedError(
                    "sequence-parallel feature extraction requires a "
                    "single-process mesh (SP over the chips of one host); "
                    "use data parallelism across processes"
                )
            self.sp_shard = (mesh, "seq")
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        if quantize is not None and self.tp_shard is not None:
            raise ValueError("int8 path is single-chip (TP weights are GSPMD-sharded)")
        if quantize is not None and self.sp_shard is not None:
            raise ValueError("int8 path is single-chip (SP shards the token dim)")
        self.quantize = quantize
        self._qparams = None
        self.params = self._load_params(seed)
        if quantize == "int8":
            from ucod_dpl_tpu.ops.quant import quantize_dino_linears

            self._qparams = jax.jit(quantize_dino_linears)(self.params)
        if self.tp_shard is not None:
            from ucod_dpl_tpu.parallel.tp import shard_dino_params

            self.params = shard_dino_params(self.params, mesh)
            sp_note = (
                f" x seq={mesh.shape['seq']} (2D-sharded attention)"
                if self.sp_shard is not None
                else ""
            )
            self.logger.log(
                f"FeatureExtractor: tensor-parallel backbone over "
                f"model={mesh.shape['model']}{sp_note} "
                f"(x data={mesh.shape.get('data', 1)})"
            )
        elif self.sp_shard is not None:
            # params stay replicated under SP; only activations shard
            self.logger.log(
                f"FeatureExtractor: sequence-parallel backbone (ring "
                f"attention) over seq={mesh.shape['seq']} "
                f"(x data={mesh.shape.get('data', 1)})"
            )

    def _load_params(self, seed: int):
        for cand in _candidate_weight_paths(self.fe_cfg):
            if cand.is_dir() and (
                (cand / "model.safetensors").exists() or (cand / "pytorch_model.bin").exists()
            ):
                self.logger.log(f"Loading DINO weights from {cand}")
                return load_hf_checkpoint(str(cand), self.config)
            if cand.is_file():
                self.logger.log(f"Loading DINO weights from {cand}")
                return load_hf_checkpoint(str(cand), self.config)
        msg = (
            f"No local weights found for {self.fe_cfg.backbone} "
            f"(searched {_candidate_weight_paths(self.fe_cfg)})"
        )
        if self.strict:
            raise FileNotFoundError(
                msg + "; strict weight loading is enabled (serving/eval refuses "
                "to run on random-init features)."
            )
        self.logger.warning(
            msg + "; using RANDOM initialisation — features will not match pretrained DINO."
        )
        return init_dino(jax.random.PRNGKey(seed), self.config)

    def _forward(self, want_attn: bool):
        """Jitted forwards that return ONLY the needed outputs — selecting
        inside the jit boundary lets XLA dead-code-eliminate everything after
        the last block's key projection (its attention/MLP, the final
        layernorm) on the feature-extraction path."""
        return _make_extract_fn(
            self.config, self.compute_dtype, want_attn, self.tp_shard,
            # the CLS-attention forward is the pseudo-label parity surface:
            # it runs unsharded regardless of the SP mesh (dino_forward
            # rejects sp_shard + want_cls_attention)
            None if want_attn else self.sp_shard,
        )

    def _put_pixels(self, images_nhwc: np.ndarray):
        """Host batch -> device, sharded over the mesh's data axis when a
        single-process multi-device mesh is attached (DP x TP composition).

        Multi-process runs place locally instead: extraction is per-process
        work over the process's own dataset shard, and a globally-sharded
        input would make the jitted extract a collective every process must
        launch in lockstep."""
        if (
            self.mesh is not None
            and len(self.mesh.devices.flat) > 1
            and jax.process_count() == 1
        ):
            from ucod_dpl_tpu.parallel.mesh import data_sharding

            arr = np.asarray(images_nhwc)
            return jax.device_put(
                arr, data_sharding(self.mesh, arr.ndim, batch_size=arr.shape[0])
            )
        return jnp.asarray(images_nhwc)

    @staticmethod
    def _to_host_f32(device_arr, what: str) -> np.ndarray:
        """Device array -> host float32, raising on non-finite values: a
        non-finite backbone forward poisons every downstream cache and
        silently evaluates as all-background masks — fail loudly (cost: one
        vectorised host pass, ~1% of the transfer time)."""
        arr = np.asarray(device_arr).astype(np.float32, copy=False)
        if not np.isfinite(arr).all():
            raise FloatingPointError(
                f"DINO forward produced non-finite {what} "
                f"({(~np.isfinite(arr)).sum()}/{arr.size} bad) on "
                f"{jax.default_backend()} — kernel or numerics regression."
            )
        return arr

    def extract(self, images_nhwc: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) normalised images -> (B, h, w, hidden) float32 key
        features on host (transferred in the compute dtype — exact, see
        :func:`_make_extract_fn`)."""
        out = self._forward(False)(
            self.params, self._put_pixels(images_nhwc), self._qparams
        )
        return self._to_host_f32(out, "features")

    def extract_with_attention(
        self, images_nhwc: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns host float32 (key_tokens (B,1+N,C), key_features NHWC,
        cls_attention (B, nh, 1+N)) — the pseudo-label generator contract."""
        # always full precision: dino_forward rejects quant+CLS-attention
        # (pseudo-label bitwise parity), so pass None rather than raise —
        # a quantized extractor can still serve the parity surface exactly
        toks, feats, attn = self._forward(True)(
            self.params, self._put_pixels(images_nhwc), None
        )
        return (
            self._to_host_f32(toks, "key tokens"),
            np.asarray(feats).astype(np.float32, copy=False),
            # the pseudo-label path thresholds these probabilities — NaN
            # comparisons are all-False, i.e. silently degenerate masks
            self._to_host_f32(attn, "CLS attention"),
        )
