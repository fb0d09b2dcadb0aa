"""Stage-1 evaluation with LookTwice zoom-in re-inference.

Behavioral counterpart of ``ValLoop_Look_Twice``
(``engine/runner/loop_UCOD_DPL.py:276-417``): decode cached features,
upsample + binarise, find connected components; when the largest component is
small (< look_twice_th), expand each component's bbox (const or dynamic
scale), crop the *original* image, re-extract DINO features on the crops and
re-infer, pasting refined predictions back.

Differences from the reference:
  * the per-bbox crop re-inference is batched — all crops of an image go
    through the DINO backbone in ONE device call (the reference ping-pongs
    host<->device per bbox, loop_UCOD_DPL.py:334-351);
  * crop batches are padded to bucket sizes so the jitted second pass
    compiles a handful of shapes only.
"""

from __future__ import annotations

import functools
import math
import os
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from PIL import Image

from ucod_dpl_tpu.data.transforms import image_transform
from ucod_dpl_tpu.models.dba import fg_logits_live, rev_decoder_forward_resized
from ucod_dpl_tpu.ops.resize import interpolate_bilinear_nhwc, interpolate_bilinear_np
from ucod_dpl_tpu.utils.components import bounding_rect, connected_components
from ucod_dpl_tpu.utils.fileio import save_binary_mask
from ucod_dpl_tpu.utils.metrics import CODStatistics

Image.MAX_IMAGE_PIXELS = None

# coarse buckets: each extra bucket is a separate XLA compilation of the
# full backbone; padding 1-3 wasted crops is far cheaper than a compile
_CROP_BUCKETS = (4, 16)


def _bucket(n: int) -> int:
    for b in _CROP_BUCKETS:
        if n <= b:
            return b
    return ((n + _CROP_BUCKETS[-1] - 1) // _CROP_BUCKETS[-1]) * _CROP_BUCKETS[-1]


def batched_crop_infer(crops: List[np.ndarray], crop_batch_fn) -> np.ndarray:
    """Run crop arrays through ``crop_batch_fn`` in bucket-padded chunks of
    at most the largest bucket — unbounded counts would compile a fresh
    backbone shape per new size (20-40s each on remote compile)."""
    cap = _CROP_BUCKETS[-1]
    parts = []
    for s0 in range(0, len(crops), cap):
        chunk = crops[s0 : s0 + cap]
        nb = _bucket(len(chunk))
        batch = np.zeros((nb, *chunk[0].shape), dtype=np.float32)
        batch[: len(chunk)] = np.stack(chunk)
        parts.append(np.asarray(crop_batch_fn(batch))[: len(chunk)])
    return np.concatenate(parts)


def expand_bbox(
    mask: np.ndarray,
    bbox: Tuple[int, int, int, int],
    img_width: int,
    img_height: int,
    expand_type: str = "const",
    scale: float = 1.3,
) -> List[int]:
    """Grow a component bbox; 'dynamic' scales by sqrt(2 - br/fr)
    (loop_UCOD_DPL.py:399-417)."""
    x, y, w, h = bbox
    if expand_type == "dynamic":
        fr = mask[y : y + h, x : x + w].sum() / (h * w)
        br = (h * y) / (mask.shape[-2] * mask.shape[-1])
        # guard: the reference's math.sqrt raises when br/fr > 2; clamp at 0
        scale = math.sqrt(max(1.0 - br / fr + 1.0, 0.0)) if fr > 0 else scale
    new_w = w * scale
    new_h = h * scale
    new_x = max(0.0, x - (new_w - w) / 2)
    if new_x + new_w > img_width:
        new_x = img_width - new_w
    new_y = max(0.0, y - (new_h - h) / 2)
    if new_y + new_h > img_height:
        new_y = img_height - new_h
    return [int(new_x), int(new_y), int(new_w), int(new_h)]


def resize_bbox(bbox, original_width, original_height, new_width, new_height) -> List[int]:
    x, y, w, h = bbox
    ws = new_width / original_width
    hs = new_height / original_height
    return [int(x * ws), int(y * hs), int(w * ws), int(h * hs)]


def find_refine_bboxes(
    binary_hw: np.ndarray,
    img_size: Tuple[int, int],
    look_twice_th: float,
    expand_type: str,
) -> Optional[List[List[int]]]:
    """Component analysis -> bboxes to re-look at, or None
    (loop_UCOD_DPL.py:354-384). ``binary_hw``: (H, W) {0,1}.

    Areas come from one bincount sweep (the reference's per-component
    ``(labels==i).sum()`` list comprehension is O(components x H x W) —
    seconds per image when predictions are noisy)."""
    h, w = img_size
    num, labels = connected_components(binary_hw)
    if num == 0:
        # reference quirk kept: fixed centre box (tuned for 518px inputs)
        return [[129, 129, 259, 259]]
    areas = np.bincount(labels.ravel(), minlength=num + 1)[1:] / (h * w)
    if areas.max() >= look_twice_th:
        return None
    bboxes = []
    for i in np.nonzero(areas > 0.01)[0]:
        comp = (labels == i + 1).astype(np.uint8)
        bbox = bounding_rect(comp)
        bboxes.append(expand_bbox(comp, bbox, h, w, expand_type=expand_type))
    bboxes.sort(key=lambda b: -b[2] * b[3])
    return bboxes


def prepare_crops(
    img, bboxes: List[List[int]], img_size: Tuple[int, int]
) -> Tuple[List[List[int]], List[np.ndarray]]:
    """Host half of LookTwice: filter degenerate boxes (the dynamic sqrt
    guard can emit zero-size boxes where the reference's math.sqrt would
    have raised), open the image lazily (path or PIL), and produce the
    normalised crop arrays (loop_UCOD_DPL.py:334-342)."""
    bboxes = [b for b in bboxes if b[2] > 0 and b[3] > 0]
    if not bboxes:
        return [], []
    if isinstance(img, (str, os.PathLike)):
        img = Image.open(img)
    ih, iw = img_size
    crops = []
    for bbox in bboxes:
        x, y, w, h = resize_bbox(bbox, iw, ih, img.size[0], img.size[1])
        cropped = img.crop((x, y, x + max(w, 1), y + max(h, 1)))
        crops.append(image_transform(cropped.convert("RGB"), img_size))
    return bboxes, crops


def paste_refined(
    mask_hw: np.ndarray, bboxes: List[List[int]], preds: np.ndarray
) -> np.ndarray:
    """Paste per-crop refined masks back (loop_UCOD_DPL.py:348-352)."""
    new_mask = Image.fromarray((mask_hw * 255).astype(np.uint8))
    for bbox, pred in zip(bboxes, preds):
        pil = Image.fromarray((pred * 255).astype(np.uint8))
        pil = pil.resize((bbox[2], bbox[3]))  # PIL default bicubic
        new_mask.paste(pil, (bbox[0], bbox[1]))
    return np.asarray(new_mask, dtype=np.float32) / 255.0


def refine_with_crops(
    img: "Image.Image",
    bboxes: List[List[int]],
    mask_hw: np.ndarray,
    img_size: Tuple[int, int],
    crop_batch_fn,
) -> np.ndarray:
    """Crop-zoom-reinfer each bbox and paste the refined mask
    (loop_UCOD_DPL.py:326-352).  ``crop_batch_fn``: (N, H, W, 3) normalised
    crops -> (N, fh, fw) binary masks; all crops of an image go through the
    backbone in ONE device call (the reference ping-pongs host<->device per
    bbox).  The eval loop batches even wider — all crops of a whole BATCH of
    images per device call — via prepare_crops/paste_refined directly."""
    bboxes, crops = prepare_crops(img, bboxes, img_size)
    if not bboxes:
        # nothing to re-look at (the reference loops over an empty list)
        return mask_hw
    return paste_refined(mask_hw, bboxes, batched_crop_infer(crops, crop_batch_fn))


# jitted step builders are MODULE-LEVEL and cached on their static config:
# an evaluator is constructed per launch (the reference builds a fresh loop
# per dataset too), and jit caches key on the function OBJECT — per-instance
# closures would re-trace and re-hit the compilation cache on every dataset.

@functools.lru_cache(maxsize=32)
def _make_first_pass(feature_size: int, img_size: Tuple[int, int]):
    @jax.jit
    def first_pass(decoder_params, features):
        # features: (B, fh, fw, C) cached key features. Masks come back
        # as uint8 — 4x less device-to-host traffic than f32.
        # The 37->68 interpolation is folded behind the decoder's 1x1
        # decoupling (mathematically exact; see rev_decoder_forward_resized)
        fg, _, _ = rev_decoder_forward_resized(decoder_params, features, feature_size)
        up = interpolate_bilinear_nhwc(fg, img_size)[..., 0]
        return (jax.nn.sigmoid(up) > 0.5).astype(jnp.uint8)  # (B, H, W)

    return first_pass


@functools.lru_cache(maxsize=32)
def _make_crop_pass(dino_config, compute_dtype):
    @jax.jit
    def crop_pass(decoder_params, backbone_params, images):
        # key-fold fast path: the decoder's 1x1 decoupling folded into the
        # backbone's last key projection (models/dba.py::fg_logits_live)
        fg, _, _ = fg_logits_live(
            backbone_params, decoder_params, images, dino_config,
            compute_dtype=compute_dtype,
        )
        return (jax.nn.sigmoid(fg[..., 0]) > 0.5).astype(jnp.float32)  # (N, fh, fw)

    return crop_pass


class LookTwiceEvaluator:
    def __init__(self, cfg, runner):
        self.cfg = cfg
        self.runner = runner
        self.img_size = tuple(cfg.dataset_cfg.valset_cfg.image_size)
        self.feature_size = cfg.model_cfg.feature_size
        self.look_twice_enabled = cfg.val_cfg.get("look_twice", False)
        self.look_twice_th = cfg.val_cfg.get("look_twice_th", 0.15)
        self.expand_type = cfg.val_cfg.get("expand_type", "const")
        self.save_preds = cfg.val_cfg.get("save_preds", True)

        fe = runner.feature_extractor
        self._first_pass = _make_first_pass(self.feature_size, self.img_size)
        self._crop_pass = _make_crop_pass(fe.config, fe.compute_dtype)

    # ------------------------------------------------------------------
    def process_preds(self, binary_hw: np.ndarray) -> Optional[List[List[int]]]:
        return find_refine_bboxes(
            binary_hw, self.img_size, self.look_twice_th, self.expand_type
        )

    def look_twice(
        self, img_path: str, bboxes: List[List[int]], mask_hw: np.ndarray
    ) -> np.ndarray:
        return refine_with_crops(
            img_path,
            bboxes,
            mask_hw,
            self.img_size,
            lambda batch: self._crop_pass(
                self.runner.decoder_params, self.runner.feature_extractor.params, batch
            ),
        )

    # ------------------------------------------------------------------
    def run(self) -> dict:
        """Batched first pass (any val batch size), per-image LookTwice.

        The reference evaluates strictly image-by-image (val batch_size=1,
        loop_UCOD_DPL.py:301).  Pipeline here:
          * the decoder/upsample first pass runs the whole batch in one
            device call;
          * the NEXT batch's first pass is dispatched before the current
            batch's host post-processing (JAX dispatch is async), so the
            device computes while the host does CC analysis / metrics;
          * PNG mask writes go through a small thread pool;
          * per-image metric scoring fans out to a process pool on large
            datasets (metric_workers: -1/auto).
        """
        from ucod_dpl_tpu.utils.progress import ProgressReporter

        n_total = len(self.runner.val_dataloader.dataset)
        workers = self.cfg.val_cfg.get("metric_workers", -1)
        if workers < 0:
            workers = CODStatistics.auto_workers(n_total)
        stats = CODStatistics(workers=workers)
        logger = self.runner.logger
        dataset_name = self.cfg.dataset_cfg.valset_cfg.DATASET
        logger.log(f"start validate on {dataset_name} (metric_workers={workers})")
        progress = ProgressReporter(logger, n_total, f"eval {dataset_name}")

        import concurrent.futures

        io_pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        io_futures = []

        loader_bs = self.runner.val_dataloader.batch_size

        def dispatch(batch):
            features = np.asarray(batch["features"])  # (B, fh, fw, C)
            n = features.shape[0]
            if n < loader_bs:  # pad the tail batch: avoids a fresh XLA compile
                features = np.concatenate(
                    [features, np.repeat(features[-1:], loader_bs - n, axis=0)]
                )
            # async: returns a device array future-like; np.asarray later blocks
            return self._first_pass(self.runner.decoder_params, features), n

        def process(pending):
            (dev_binaries, n), batch = pending
            binaries = [b.astype(np.float32) for b in np.asarray(dev_binaries)[:n]]

            if self.look_twice_enabled:
                # ALL crops of the whole batch go through the backbone in ONE
                # bucketed device call (per-image calls pay a sync dispatch
                # round-trip each and underfill the card)
                work = []  # (image idx, bboxes, crop arrays)
                for i in range(n):
                    bboxes = self.process_preds(binaries[i])
                    if bboxes is None:
                        continue
                    vb, crops = prepare_crops(
                        batch["img_path"][i], bboxes, self.img_size
                    )
                    if vb:
                        work.append((i, vb, crops))
                if work:
                    all_crops = [c for _, _, crops in work for c in crops]
                    preds = batched_crop_infer(
                        all_crops,
                        lambda batch: self._crop_pass(
                            self.runner.decoder_params,
                            self.runner.feature_extractor.params,
                            batch,
                        ),
                    )
                    off = 0
                    for i, vb, crops in work:
                        k = len(crops)
                        binaries[i] = paste_refined(binaries[i], vb, preds[off : off + k])
                        off += k

            for binary, label, img_path in zip(binaries, batch["label"], batch["img_path"]):
                lh, lw = label.shape[:2]
                # host resize: avoids an upload+download round-trip per image
                pred = (interpolate_bilinear_np(binary, (lh, lw)) > 0.5).astype(
                    np.float64
                )

                stats.step(label[None, :, :, 0], pred[None])
                if self.save_preds:
                    out_path = os.path.join(
                        self.cfg.log_cfg.log_path, "preds", dataset_name,
                        os.path.basename(img_path),
                    )
                    io_futures.append(io_pool.submit(save_binary_mask, pred, out_path))
                    if len(io_futures) > 256:  # bound the queued-array backlog
                        for fut in io_futures[:128]:
                            fut.result()
                        del io_futures[:128]
            progress.update(n)

        from . import preempt

        try:
            # cooperative preemption poll: when the stage-1 trainer runs
            # this validation, a SIGTERM mid-val must not wait out the
            # whole sweep (the trainer catches Preempted and checkpoints;
            # no-op in standalone eval CLIs, which never install the
            # handler).  Eval shards are RAGGED across processes, so the
            # multi-process poll follows preempt.GlobalPoll's fixed
            # collective schedule — every rank observes the cluster-agreed
            # flag at the same round and either all raise or none does.
            poll = preempt.GlobalPoll(len(self.runner.val_dataloader))
            pending = None
            for batch in self.runner.val_dataloader:
                poll.step()
                dev = dispatch(batch)
                if pending is not None:
                    process(pending)
                pending = (dev, batch)
            if pending is not None:
                process(pending)
            poll.finish()  # shorter shards drain the shared poll schedule
            progress.finish()

            for fut in io_futures:
                fut.result()  # surface IO errors
        except BaseException:
            # error/preemption path: abandon queued mask writes and stop the
            # metric worker pool — leaked spawn workers would otherwise keep
            # competing with the preemption checkpoint for CPU during the
            # platform's kill grace period
            for fut in io_futures:
                fut.cancel()
            io_pool.shutdown(wait=False, cancel_futures=True)
            stats.close()
            raise
        io_pool.shutdown()

        stats.sync_across_processes()
        result = stats.get_result()
        logger.log_table({k: [round(v, 4)] for k, v in result.items()})
        return result
