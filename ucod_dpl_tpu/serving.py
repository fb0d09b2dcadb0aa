"""Batched inference API for production serving.

The reference offers only dataset-driven eval scripts; deployments need a
load-once / predict-many surface. ``Predictor`` wraps backbone + decoder
(+ optional LookTwice refinement) behind one call:

    from ucod_dpl_tpu.serving import Predictor
    p = Predictor.from_config("configs/uscod/UCOD-DPL_dinov2.py",
                              checkpoint="weights/UCOD_DPL_dinov2.safetensors")
    masks = p.predict(["im1.jpg", "im2.jpg"])   # list of (H, W) float masks

``RefinePredictor`` is the stage-2 (CORAL) counterpart: stage-1 coarse
decoder + UDLR local refinement, with live multi-resolution feature
extraction (no dataset caches needed):

    rp = RefinePredictor.from_config("configs/uscod/CORAL_dinov2.py",
                                     checkpoint="weights/UCOD_DPL_dinov2.safetensors",
                                     refiner_path="refiner_ckp/epoch8.safetensors")
    masks = rp.predict(["im1.jpg"])

Design: one jitted pixels->mask program per batch bucket (powers of two up to
``max_batch``), in the config's compute dtype (``tpu_cfg.compute_dtype``,
else bf16 on the GPU), uint8 mask readback, optional per-image LookTwice
second pass reusing the eval-loop machinery.  The refine path reuses the
CORAL evaluator's exact prep/refine programs
(engine/coral_loop.py::prepare_refine_inputs) so serving masks match the
eval CLI's bit for bit on the same inputs.

Throughput per batch size on the H100 is not measured yet.
``quantize="int8"`` is opt-in and, in plain XLA, ran slower than bf16 in one
H100 bench run (PERF.md); validate quality on your data first (MIGRATION 7b,
incl. the int8 x parallelism matrix).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor
from ucod_dpl_tpu.data.transforms import image_transform
from ucod_dpl_tpu.device import resolve_compute_dtype
from ucod_dpl_tpu.models.dba import RevDecoderParams, fg_logits_live
from ucod_dpl_tpu.models.safetensors_io import load_decoder_checkpoint
from ucod_dpl_tpu.ops.resize import interpolate_bilinear_nhwc, interpolate_bilinear_np
from ucod_dpl_tpu.utils.fileio import ImageIO


class Predictor:
    """Load-once, predict-many camouflaged-object segmentation."""

    def __init__(
        self,
        feature_extractor: FeatureExtractor,
        decoder_params: RevDecoderParams,
        image_size=(518, 518),
        feature_size: int = 68,
        max_batch: int = 16,
        look_twice_th: float = 0.15,
        expand_type: str = "dynamic",
        quantize: Optional[str] = None,
    ):
        self.fe = feature_extractor
        self.decoder_params = decoder_params
        self.image_size = tuple(image_size)
        self.feature_size = feature_size
        self.max_batch = max_batch
        self.look_twice_th = look_twice_th
        self.expand_type = expand_type

        # opt-in int8 W8A8 backbone (ops/quant.py): the transformer linears
        # run as int8 matmuls; quantized ONCE here, passed alongside
        # the full params (norms/embeddings still read from those)
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        # an extractor constructed with quantize="int8" opts the key-fold
        # path in too (and shares its already-quantized linears)
        if quantize is None and getattr(feature_extractor, "quantize", None):
            quantize = feature_extractor.quantize
        self.quantize = quantize
        self._qparams = None
        if quantize == "int8":
            if getattr(feature_extractor, "_qparams", None) is not None:
                self._qparams = feature_extractor._qparams
            else:
                from ucod_dpl_tpu.ops.quant import quantize_dino_linears

                self._qparams = jax.jit(quantize_dino_linears)(feature_extractor.params)

        fs = self.feature_size

        @jax.jit
        def pixels_to_probs(backbone_params, decoder_params, pixels, qparams):
            # key-fold fast path: decoupling folded into the last layer's
            # key projection (models/dba.py::fg_logits_live)
            fg, _, _ = fg_logits_live(
                backbone_params, decoder_params, pixels, self.fe.config,
                compute_dtype=self.fe.compute_dtype, size=fs, quant=qparams,
            )
            up = interpolate_bilinear_nhwc(fg, self.image_size)[..., 0]
            return jax.nn.sigmoid(up)

        @jax.jit
        def pixels_to_mask(backbone_params, decoder_params, pixels, qparams):
            return (
                pixels_to_probs(backbone_params, decoder_params, pixels, qparams) > 0.5
            ).astype(jnp.uint8)

        @jax.jit
        def crop_pass(backbone_params, decoder_params, pixels, qparams):
            # LookTwice second pass: masks at the crop's key-feature
            # resolution, matching the eval loop (loop_UCOD_DPL.py:343-348)
            fg, _, _ = fg_logits_live(
                backbone_params, decoder_params, pixels, self.fe.config,
                compute_dtype=self.fe.compute_dtype, quant=qparams,
            )
            return (jax.nn.sigmoid(fg[..., 0]) > 0.5).astype(jnp.float32)

        self._pixels_to_probs = pixels_to_probs
        self._pixels_to_mask = pixels_to_mask
        self._crop_pass = crop_pass

    @classmethod
    def from_config(
        cls,
        config_path: str,
        checkpoint: str,
        max_batch: int = 16,
        strict: bool = True,
        quantize: Optional[str] = None,
    ) -> "Predictor":
        """``strict=True`` (default): missing backbone weights raise instead
        of silently serving random-init features.  ``quantize="int8"``:
        int8 W8A8 backbone (see ops/quant.py for the accuracy contract)."""
        from ucod_dpl_tpu.config import load_config

        cfg = load_config(config_path)
        fe = FeatureExtractor(
            cfg.dataset_cfg.feature_extractor_cfg,
            compute_dtype=resolve_compute_dtype(cfg),
            strict=strict,
        )
        decoder, _ema = load_decoder_checkpoint(checkpoint)
        return cls(
            fe,
            decoder,
            image_size=tuple(cfg.dataset_cfg.valset_cfg.get("image_size", (518, 518))),
            feature_size=cfg.model_cfg.feature_size,
            max_batch=max_batch,
            look_twice_th=cfg.val_cfg.get("look_twice_th", 0.15),
            expand_type=cfg.val_cfg.get("expand_type", "dynamic"),
            quantize=quantize,
        )

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n and b < self.max_batch:
            b *= 2
        return min(b, self.max_batch)

    def _load(self, item):
        """-> (normalised (H, W, 3) float array, original PIL image or None)."""
        from PIL import Image

        if isinstance(item, (str,)) or hasattr(item, "__fspath__"):
            img = ImageIO.read_image(item, "RGB")
            return image_transform(img, self.image_size), img
        arr = np.asarray(item)
        if arr.ndim == 3 and arr.dtype == np.uint8:  # raw RGB image
            img = Image.fromarray(arr)
            return image_transform(img, self.image_size), img
        return arr, None  # already transformed (H, W, 3) float

    def predict(
        self,
        inputs: Sequence[Union[str, np.ndarray]],
        output_size: Optional[tuple] = None,
        look_twice: bool = False,
        soft: bool = False,
    ) -> List[np.ndarray]:
        """Images (paths, uint8 RGB arrays, or pre-normalised arrays) ->
        (H, W) float32 masks at ``output_size`` (default: the model's
        image_size).

        ``look_twice=True``: small predicted objects trigger the zoom-in
        second pass (connected components -> bbox expansion -> batched crop
        re-inference, same machinery as the eval loop).  Requires inputs
        with an original image (paths or uint8 arrays).
        ``soft=True``: return sigmoid probabilities instead of {0,1} masks
        (mutually exclusive with look_twice, which is defined on binaries).
        """
        import os as _os

        if look_twice and soft:
            raise ValueError("look_twice refines binary masks; soft=True is incompatible")
        # a bare path or a single (H, W, 3) image is one input, not a
        # sequence — iterating a string's characters or an image's rows
        # would silently produce garbage masks
        if isinstance(inputs, (str, _os.PathLike)):
            inputs = [inputs]
        elif isinstance(inputs, np.ndarray):
            if inputs.ndim == 3:
                inputs = [inputs]
            elif inputs.ndim != 4:
                raise ValueError(
                    f"array input must be (H, W, 3) or (N, H, W, 3); got {inputs.shape}"
                )
        inputs = list(inputs)
        program = self._pixels_to_probs if soft else self._pixels_to_mask
        if look_twice:
            from ucod_dpl_tpu.engine.eval_loop import find_refine_bboxes, refine_with_crops

            def crop_fn(batch):
                return self._crop_pass(
                    self.fe.params, self.decoder_params, batch, self._qparams
                )

        masks: List[np.ndarray] = []
        i = 0
        while i < len(inputs):
            # decode/transform PER CHUNK: eager whole-list loading holds
            # every full-res original + normalised array alive at once
            # (~3MB+ per image — a 10k-image call would OOM the host)
            take = min(self.max_batch, len(inputs) - i)
            loaded = [self._load(x) for x in inputs[i : i + take]]
            arrays = [a for a, _ in loaded]
            originals = [im for _, im in loaded] if look_twice else None
            if look_twice and any(im is None for im in originals):
                raise ValueError(
                    "look_twice needs the original image: pass paths or uint8 RGB arrays"
                )
            nb = self._bucket(take)
            batch = np.zeros((nb, *self.image_size, 3), np.float32)
            for j, a in enumerate(arrays):
                if np.shape(a) != (*self.image_size, 3):
                    raise ValueError(
                        f"input {i + j}: expected a path, a uint8 RGB image, or a "
                        f"pre-normalised {(*self.image_size, 3)} float array; got "
                        f"shape {np.shape(a)}"
                    )
                batch[j] = a
            out = np.asarray(
                program(self.fe.params, self.decoder_params, batch, self._qparams)
            )[:take]
            chunk = [m.astype(np.float32) for m in out]
            if look_twice:
                for k, (mask, img) in enumerate(zip(chunk, originals)):
                    bboxes = find_refine_bboxes(
                        mask, self.image_size, self.look_twice_th, self.expand_type
                    )
                    if bboxes is not None:
                        chunk[k] = refine_with_crops(
                            img, bboxes, mask, self.image_size, crop_fn
                        )
            masks.extend(chunk)
            i += take

        if output_size is not None:
            if soft:
                masks = [interpolate_bilinear_np(m, output_size) for m in masks]
            else:
                masks = [
                    (interpolate_bilinear_np(m, output_size) > 0.5).astype(np.float32)
                    for m in masks
                ]
        return masks


class RefinePredictor:
    """Load-once stage-2 (CORAL) serving: coarse stage-1 prediction + UDLR
    local refinement (the composition of ``LocalRefineValidationLoop``,
    reference loop_CORAL.py:41-341, minus dataset/caches/metrics).

    Inputs must carry original pixels (paths or uint8 RGB arrays) — the
    multi-resolution features (518px l-features, the 3x3 grid h-features,
    the optional 756px 2x2 m-patches) are extracted live per call.
    """

    def __init__(
        self,
        feature_extractor: FeatureExtractor,
        decoder_params: RevDecoderParams,
        refiner_params,
        image_size=(518, 518),
        window_size: int = 3,
        window_length: int = 56,
        threshold: float = 0.0015,
        use_m_patches: bool = True,
        max_batch: int = 4,
        crop_center_ratio: float = 0.001,
    ):
        from ucod_dpl_tpu.engine.coral_loop import _make_refine

        self.fe = feature_extractor
        self.decoder_params = decoder_params
        self.refiner_params = refiner_params
        self.image_size = tuple(image_size)
        self.window_size = window_size
        self.window_length = window_length
        self.use_m_patches = use_m_patches
        self.max_batch = max_batch
        self.crop_center_ratio = crop_center_ratio
        self._refine = _make_refine(window_size, float(threshold))

    @classmethod
    def from_config(
        cls,
        config_path: str,
        checkpoint: str,
        refiner_path: str,
        max_batch: int = 4,
        strict: bool = True,
        quantize: Optional[str] = None,
    ) -> "RefinePredictor":
        """``quantize="int8"``: W8A8 backbone for all three live extraction
        resolutions (the stage-2 serving cost is backbone-dominated: 10+
        backbone patches per image feed one small refiner)."""
        from ucod_dpl_tpu.config import load_config
        from ucod_dpl_tpu.models.udlr import load_refiner_checkpoint

        cfg = load_config(config_path)
        fe = FeatureExtractor(
            cfg.dataset_cfg.feature_extractor_cfg,
            compute_dtype=resolve_compute_dtype(cfg),
            strict=strict,
            quantize=quantize,
        )
        decoder, _ema = load_decoder_checkpoint(checkpoint)
        refiner = load_refiner_checkpoint(refiner_path)
        mc = cfg.model_cfg
        return cls(
            fe,
            decoder,
            refiner,
            image_size=tuple(cfg.dataset_cfg.valset_cfg.get("image_size", (518, 518))),
            window_size=mc.get("window_size", 3),
            window_length=mc.window_length,
            threshold=mc.get("threshold", 0.0015),
            use_m_patches=cfg.dataset_cfg.valset_cfg.get("require_m_patches", True),
            max_batch=max_batch,
        )

    # ------------------------------------------------------------------
    def _load_image(self, item):
        from PIL import Image

        if isinstance(item, (str,)) or hasattr(item, "__fspath__"):
            return ImageIO.read_image(item, "RGB")
        arr = np.asarray(item)
        if arr.ndim == 3 and arr.dtype == np.uint8:
            return Image.fromarray(arr).convert("RGB")
        raise ValueError(
            "RefinePredictor needs original pixels (paths or uint8 RGB "
            f"arrays) to extract multi-resolution features; got {type(item)!r}"
            + (f" with shape {arr.shape}/{arr.dtype}" if isinstance(arr, np.ndarray) else "")
        )

    def _extract(self, imgs):
        """PIL images -> (l, h, m) feature arrays, each resolution batched
        through the backbone in ONE device call (the reference extracts 10+
        forwards per image, lr_dataset.py:170-193)."""
        from ucod_dpl_tpu.data.dataset import (
            fe_image_size,
            grid_patch_arrays,
            slice_m_windows,
        )

        l = np.asarray(
            self.fe.extract(
                np.stack([image_transform(im, self.image_size) for im in imgs])
            ),
            np.float32,
        )
        grids = np.concatenate(
            [grid_patch_arrays(im, self.image_size, self.window_size) for im in imgs]
        )
        gf = np.asarray(self.fe.extract(grids), np.float32)
        per = self.window_size ** 2
        h = gf.reshape(len(imgs), per, *gf.shape[1:])
        m = None
        if self.use_m_patches:
            ms = np.stack(
                [image_transform(im, fe_image_size(self.fe.fe_cfg.type)) for im in imgs]
            )
            keys = np.asarray(self.fe.extract(ms), np.float32)
            m = np.stack([slice_m_windows(k) for k in keys])
        return l, h, m

    def _refine_batch(self, l, h, m):
        from ucod_dpl_tpu.engine.coral_loop import prepare_refine_inputs

        l_feat, h_feat, preds = prepare_refine_inputs(
            self.decoder_params, l, h, m, self.window_length
        )
        out = np.asarray(self._refine(self.refiner_params, l_feat, h_feat, preds))
        return out, np.asarray(preds)

    def _refine_cropped(self, img) -> np.ndarray:
        """Centre-crop fallback for a near-empty coarse prediction
        (loop_CORAL.py:148-151, 276-311): re-extract on the centre half,
        refine, centre-pad with the reference's -10 fill."""
        from ucod_dpl_tpu.engine.coral_loop import LocalRefineEvaluator

        w, ht = img.size
        cropped = img.crop((w // 4, ht // 4, w // 4 + w // 2, ht // 4 + ht // 2))
        l, h, m = self._extract([cropped])
        out, _ = self._refine_batch(l, h, m)
        return LocalRefineEvaluator._center_pad(out)[0]

    def predict(
        self,
        inputs: Sequence[Union[str, np.ndarray]],
        output_size: Optional[tuple] = None,
        soft: bool = False,
    ) -> List[np.ndarray]:
        """Images -> (H, W) float32 refined masks ({0,1}; ``soft=True`` for
        probabilities) at ``output_size`` (default: the refiner's native
        output grid upsampled to the model image size)."""
        import os as _os

        if isinstance(inputs, (str, _os.PathLike)):
            inputs = [inputs]
        elif isinstance(inputs, np.ndarray) and inputs.ndim == 3:
            inputs = [inputs]
        inputs = list(inputs)
        masks: List[np.ndarray] = []
        i = 0
        while i < len(inputs):
            take = min(self.max_batch, len(inputs) - i)
            imgs = [self._load_image(x) for x in inputs[i : i + take]]
            # pad the tail chunk by repeating the last image: keeps one
            # compiled shape per resolution (same trick as the eval loop)
            padded = imgs + [imgs[-1]] * (self.max_batch - take)
            l, h, m = self._extract(padded)
            outputs, preds = self._refine_batch(l, h, m)
            outputs, preds = outputs[:take], preds[:take]

            # per-image centre-crop fallback for near-empty predictions
            ratios = (preds > 0).sum(axis=(1, 2, 3)) / (
                preds.shape[1] * preds.shape[2]
            )
            outs = list(outputs)
            for k in np.nonzero(ratios < self.crop_center_ratio)[0]:
                outs[k] = self._refine_cropped(imgs[k])

            for out in outs:
                out = out[None]
                in_01 = bool(np.all((out >= 0) & (out <= 1)))
                probs = (
                    out
                    if in_01
                    else 1.0 / (1.0 + np.exp(-np.clip(out, -88.0, 88.0)))
                )
                size = tuple(output_size) if output_size is not None else self.image_size
                up = interpolate_bilinear_np(
                    np.transpose(probs, (0, 3, 1, 2)), size
                )[0, 0]
                masks.append(
                    up.astype(np.float32) if soft else (up > 0.5).astype(np.float32)
                )
            i += take
        return masks
