"""COD datasets, cache building, and a minimal host dataloader.

Behavioral counterpart of the reference data layer
(``data/datasets/base_dataset.py``, ``lr_dataset.py``,
``dataloader_utils.py``) with the same on-disk cache layout
(``cache_manager.py:63-76``):

  {cache_dir}/features_cache/{extractor}/{mode}/{DATASET}
  {cache_dir}/pseudo_label_cache/{DATASET}
  {cache_dir}/patch_cache/{extractor}/{mode}/{DATASET}
  {cache_dir}/m_patch_cache/{extractor}/{mode}/{DATASET}

Difference from the reference: the one-time feature cache build runs the DINO
backbone in *batches* (the reference loops image-by-image), and all arrays
are NHWC.  Legacy torch-pickle caches written by the PyTorch reference are
read transparently (CHW -> HWC conversion).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ucod_dpl_tpu.utils import get_logger
from ucod_dpl_tpu.utils.fileio import ArrayCache, ImageIO
from ucod_dpl_tpu.utils.registry import DATASETS

from .feature_extractor import FeatureExtractor
from .transforms import (
    image_transform,
    load_image_batch_transform,
    load_image_transform,
    load_label_transform,
    patch_transform,
    resize_bilinear,
)

_FEATURE_DIM = 768


def _to_hwc(arr: np.ndarray) -> np.ndarray:
    """Normalise cached arrays to HWC (legacy torch caches are CHW)."""
    if arr.ndim == 3 and arr.shape[0] in (1, _FEATURE_DIM) and arr.shape[0] != arr.shape[-1]:
        return np.transpose(arr, (1, 2, 0))
    return arr


# -- LR (stage-2) pixel-side geometry, shared by LRDataset and the serving
#    RefinePredictor ----------------------------------------------------------

M_PATCH_SLICE = 36
M_PATCH_STRIDE = 18


def grid_patch_arrays(img, image_size: Tuple[int, int], window_size: int) -> np.ndarray:
    """(ws*ws, h, w, 3) normalised grid-patch pixel arrays (host side).
    One resize + one vectorised normalise; slicing after normalisation is
    elementwise-identical to the reference's crop-then-transform loop
    (lr_dataset.py:136-152)."""
    gh, gw = image_size
    ws = window_size
    big = patch_transform(resize_bilinear(img, (ws * gh, ws * gw)))
    return np.stack(
        [
            big[i * gh : (i + 1) * gh, j * gw : (j + 1) * gw]
            for i in range(ws)
            for j in range(ws)
        ]
    )


def slice_m_windows(key: np.ndarray) -> np.ndarray:
    """(54, 54, C) high-res key map -> (4, 36, 36, C) overlapping m-patch
    slices (lr_dataset.py:154-168)."""
    s, st = M_PATCH_SLICE, M_PATCH_STRIDE
    out = []
    for i in range(2):
        for j in range(2):
            out.append(key[i * st : i * st + s, j * st : j * st + s, :])
    return np.stack(out).astype(np.float32)


def fe_image_size(extractor_type: str) -> Tuple[int, int]:
    """High-res transform size: 756 (dinov2) / 432 (dinov1) — the
    reference's feature_extractor_transform (base_dataset.py:107-110)."""
    return (756, 756) if extractor_type == "dinov2" else (432, 432)


class CacheSet:
    """Per-dataset cache handles with the reference directory layout."""

    def __init__(self, cache_dir: str, extractor_type: str, mode: str, dataset: str, logger=None):
        self.cache_dir = cache_dir
        self.extractor_type = extractor_type
        self.mode = mode
        self.dataset = dataset
        self.logger = logger
        self._caches: Dict[str, ArrayCache] = {}

    def _path(self, kind: str) -> str:
        if kind == "pseudo_label":
            return os.path.join(self.cache_dir, "pseudo_label_cache", self.dataset)
        return os.path.join(
            self.cache_dir, f"{kind}_cache", self.extractor_type, self.mode, self.dataset
        )

    def get(self, kind: str) -> ArrayCache:
        if kind not in self._caches:
            self._caches[kind] = ArrayCache(self._path(kind), logger=self.logger)
        return self._caches[kind]

    def index_exists(self, kind: str) -> bool:
        """Cheap completion probe: ``index.json`` is atomically written LAST
        by a build, so its existence implies the cache is complete — one
        stat, vs the full per-sample-file integrity sweep of ``reopen``."""
        return os.path.exists(os.path.join(self._path(kind), "index.json"))

    def reopen(self, kind: str) -> ArrayCache:
        """Drop the handle and re-run the open-time integrity check — used
        by non-main processes after the main process finished building."""
        self._caches.pop(kind, None)
        return self.get(kind)


@DATASETS.register("USCODDataset")
@DATASETS.register()
class CODDataset:
    """Image/label/feature/pseudo-label dataset (counterpart of
    ``BaseCODDataset``/``USCODDataset``)."""

    def __init__(
        self,
        set_cfg,
        feature_extractor_cfg,
        dataset_dir: str,
        cache_dir: str,
        mode: str = "train",
        keep_size: bool = False,
        image_size: Tuple[int, int] = (518, 518),
        require_label: bool = False,
        feature_extractor: Optional[FeatureExtractor] = None,
        cache_build_batch: int = 8,
        logger=None,
    ):
        self.set_cfg = set_cfg
        self.feature_extractor_cfg = feature_extractor_cfg
        self.dataset_dir = dataset_dir
        self.cache_dir = cache_dir
        self.mode = mode
        self.keep_size = keep_size
        self.image_size = tuple(image_size)
        self.require_label = require_label
        self.cache_build_batch = cache_build_batch
        self.logger = logger or get_logger()
        self._feature_extractor = feature_extractor

        self._scan_files()
        self.caches = CacheSet(
            cache_dir, feature_extractor_cfg.type, mode, set_cfg.DATASET, logger=self.logger
        )
        self._validate_cache("features")
        if mode == "train":
            # the pseudo-label cache is positional too; a stale one pairs
            # images with another image's labels (invalidation downgrades it
            # to the loud "run generate_pseudo_label first" failure)
            self._validate_cache("pseudo_label")
        if self.caches.get("features").mode == "w":
            self._build_coordinated(("features",), self._build_feature_cache)

    def _cache_identity(self) -> Dict[str, Any]:
        """Count + image-stem fingerprint of the dataset this cache indexes.
        Caches are POSITIONAL (entry i <-> image_paths[i]), so a grown
        dataset KeyErrors mid-train and a shrunk/renamed one silently pairs
        every image with another image's features."""
        import hashlib

        stems = "\n".join(p.stem for p in self.image_paths)
        return {
            "n": len(self.image_paths),
            "fingerprint": hashlib.sha1(stems.encode()).hexdigest(),
        }

    def _validate_cache(self, kind: str) -> None:
        """Invalidate a complete-looking cache whose identity does not match
        the current dataset.  Legacy/reference caches carry no fingerprint
        sidecar — for those only the entry count is checkable (a same-size
        rename is undetectable; documented limitation of the interchange
        contract)."""
        cache = self.caches.get(kind)
        if cache.mode != "r":
            return
        ident = self._cache_identity()
        if len(cache) != ident["n"]:
            cache.invalidate(
                f"{len(cache)} cached entries for {ident['n']} images — the "
                "dataset changed since the cache was built"
            )
            return
        meta = cache.read_meta()
        if meta is not None and meta.get("fingerprint") != ident["fingerprint"]:
            cache.invalidate(
                "image set changed since the cache was built (fingerprint "
                "mismatch at equal count — renamed/replaced files)"
            )

    def _build_coordinated(self, kinds, build_fn, timeout_s: float = 7200.0) -> None:
        """Multi-host cache builds: only process 0 writes.

        Without this, EVERY process of a pod would redundantly sweep the
        backbone over the whole dataset AND race on the same files of the
        shared filesystem (index.json last-writer-wins corruption).

        Waiters POLL the shared filesystem rather than a collective:
        ``index.json`` is atomically replaced LAST by the build
        (fileio.JSONIO.write_file), so a passing integrity check IS the
        completion signal — and unlike a device collective, polling has no
        connection timeout and keeps the waiting processes out of any
        lockstep requirement while process 0 runs local compute."""
        import jax

        if jax.process_count() == 1:
            build_fn()
            return
        from ucod_dpl_tpu.parallel.distributed import is_main_process

        if is_main_process():
            build_fn()
            return
        import time as _time

        self.logger.log(
            f"waiting for process 0 to build {kinds} cache(s) for "
            f"{self.set_cfg.DATASET}"
        )
        deadline = _time.monotonic() + timeout_s
        while True:
            # cheap probe first: the full reopen() integrity check stats
            # every sample file, which a pod of waiters polling every 2s
            # would hammer a shared filesystem with for the whole build —
            # index.json is written last, so one stat gates the sweep and
            # the expensive check runs ~once, at completion
            bad = [k for k in kinds if not self.caches.index_exists(k)]
            if not bad:
                try:
                    bad = [k for k in kinds if self.caches.reopen(k).mode != "r"]
                except Exception:  # transient partial state mid-build
                    bad = list(kinds)
                if not bad:
                    return
            if _time.monotonic() > deadline:
                raise RuntimeError(
                    f"timed out after {timeout_s}s waiting for process 0 to "
                    f"build {bad} caches for {self.set_cfg.DATASET} — is the "
                    "cache directory on a filesystem shared by all processes?"
                )
            _time.sleep(2.0)

    # -- files ---------------------------------------------------------------
    def _scan_files(self) -> None:
        self.image_paths: List[Path] = []
        self.label_paths: List[Path] = []
        for ds in self.set_cfg.DATASET.split("+"):
            self.image_paths += ImageIO.list_dir_image(os.path.join(self.dataset_dir, ds, "im"))
            if self.require_label:
                self.label_paths += ImageIO.list_dir_image(
                    os.path.join(self.dataset_dir, ds, "gt")
                )
        self.image_paths = sorted(self.image_paths)
        if self.label_paths:
            self.label_paths = sorted(self.label_paths)
            assert len(self.image_paths) == len(self.label_paths), (
                f"image/label count mismatch: {len(self.image_paths)} vs {len(self.label_paths)}"
            )
            stems = {p.stem for p in self.label_paths}
            for p in self.image_paths:
                assert p.stem in stems, f"label missing for {p}"

    # -- feature extraction -----------------------------------------------------
    @property
    def feature_extractor(self) -> FeatureExtractor:
        if self._feature_extractor is None:
            self._feature_extractor = FeatureExtractor(self.feature_extractor_cfg)
        if getattr(self._feature_extractor, "quantize", None) is not None:
            # caches are a bitwise regeneration contract (test_pipeline_
            # equivalence pins cache==reference); int8 features would poison
            # every downstream read
            raise ValueError(
                "dataset cache builds require the full-precision extractor; "
                "int8 quantization is a serving-only path"
            )
        return self._feature_extractor

    def _load_image_array(self, path: Path) -> np.ndarray:
        return load_image_transform(path, self.image_size)

    def _build_feature_cache(self) -> None:
        """One-time DINO sweep over the dataset (the throughput-dominant
        stage, SURVEY §3.5).  Host decode/resize of the next chunk overlaps
        the device extraction of the current one via a worker pool."""
        import concurrent.futures

        cache = self.caches.get("features")
        self.logger.log(
            f"Building feature cache for {self.set_cfg.DATASET} "
            f"({len(self.image_paths)} images, batch {self.cache_build_batch})"
        )
        bs = self.cache_build_batch
        chunks = [
            self.image_paths[s : s + bs] for s in range(0, len(self.image_paths), bs)
        ]

        from ucod_dpl_tpu.utils.progress import ProgressReporter

        progress = ProgressReporter(
            self.logger, len(self.image_paths), f"feature cache {self.set_cfg.DATASET}"
        )
        idx = 0
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
            def load_chunk(paths):
                # one threaded C++ decode->resize->normalise call per chunk
                # (bit-identical to the per-image path, no GIL contention)
                return load_image_batch_transform(paths, self.image_size)

            pending = pool.submit(load_chunk, chunks[0]) if chunks else None
            for ci, chunk in enumerate(chunks):
                batch = pending.result()
                pending = (
                    pool.submit(load_chunk, chunks[ci + 1]) if ci + 1 < len(chunks) else None
                )
                feats = np.asarray(self.feature_extractor.extract(batch))
                for f in feats:
                    cache.write(idx, f.astype(np.float32))
                    idx += 1
                progress.update(len(chunk))
        cache.flush(meta=self._cache_identity())
        progress.finish()
        self.logger.log(f"Feature cache complete: {idx} samples")

    # -- item access ---------------------------------------------------------
    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        label = None
        if self.label_paths:
            label = load_label_transform(
                self.label_paths[index], self.image_size, keep_size=self.keep_size
            )

        features = _to_hwc(self.caches.get("features").read(index))

        pseudo_label = None
        if self.mode == "train":
            pl_cache = self.caches.get("pseudo_label")
            if pl_cache.mode == "r" and len(pl_cache) > index:
                pseudo_label = _to_hwc(pl_cache.read(index))

        item = {
            "pseudo_label": pseudo_label,
            "label": label,
            "features": features,
            "img_path": str(self.image_paths[index]),
        }
        if self.set_cfg.get("require_pixels", False):
            # normalised image pixels for live-backbone training paths
            # (LoRA adaptation differentiates THROUGH the backbone, so the
            # cached key features cannot be used as inputs there)
            item["pixels"] = self._load_image_array(self.image_paths[index]).astype(
                np.float32
            )
        return item


@DATASETS.register()
class LRDataset(CODDataset):
    """CORAL stage-2 dataset with 3x3 patch-grid and 2x2 m-patch features
    (counterpart of ``data/datasets/lr_dataset.py``)."""

    M_PATCH_SLICE = 36
    M_PATCH_STRIDE = 18

    def __init__(self, *args, window_size: int = 3, require_m_patches: bool = True, **kwargs):
        self.window_size = window_size
        self.require_m_patches = require_m_patches
        super().__init__(*args, **kwargs)
        self._validate_cache("patch")
        if self.require_m_patches:
            self._validate_cache("m_patch")
        if self.caches.get("patch").mode == "w" or (
            self.require_m_patches and self.caches.get("m_patch").mode == "w"
        ):
            kinds = ("patch", "m_patch") if self.require_m_patches else ("patch",)
            self._build_coordinated(kinds, self._build_patch_cache)

    def _fe_image_size(self) -> Tuple[int, int]:
        return fe_image_size(self.feature_extractor_cfg.type)

    def _grid_patch_arrays(self, img) -> np.ndarray:
        return grid_patch_arrays(img, self.image_size, self.window_size)

    def _grid_patches(self, img) -> np.ndarray:
        """Resize to window_size x image_size and cut the patch grid.
        Returns (ws*ws, h, w, C) key features (batched single DINO call)."""
        feats = self.feature_extractor.extract(self._grid_patch_arrays(img))
        return np.asarray(feats, dtype=np.float32)

    @staticmethod
    def _slice_m_windows(key: np.ndarray) -> np.ndarray:
        return slice_m_windows(key)

    def _m_patches(self, img) -> np.ndarray:
        arr = image_transform(img, self._fe_image_size())
        key = np.asarray(self.feature_extractor.extract(arr[None]))[0]  # (54, 54, C)
        return slice_m_windows(key)

    def _build_patch_cache(self) -> None:
        """Batched + overlapped build: grid patches of a whole image CHUNK go
        through DINO in one call (ws*ws*chunk crops) and the high-res m-pass
        batches the chunk's images; the next chunk's decode/resize overlaps
        the device pass (same pattern as ``_build_feature_cache`` — the
        reference runs 10 separate forwards per image, lr_dataset.py:170-193)."""
        import concurrent.futures

        patch_cache = self.caches.get("patch")
        m_cache = self.caches.get("m_patch") if self.require_m_patches else None
        build_patch = patch_cache.mode == "w"
        build_m = m_cache is not None and m_cache.mode == "w"
        n = len(self.image_paths)
        self.logger.log(
            f"Building patch caches for {self.set_cfg.DATASET} ({n} images)"
        )
        # each image contributes ws^2 grid patches, so divide by ws^2 to keep
        # the grid pass's device batch comparable to the feature-cache build
        # (a tuned-to-fit cache_build_batch must not OOM the stage-2 build)
        chunk = max(1, self.cache_build_batch // (self.window_size ** 2))
        chunks = [self.image_paths[s : s + chunk] for s in range(0, n, chunk)]

        def load_chunk(paths):
            grids, ms = [], []
            for path in paths:
                img = ImageIO.read_image(path, "RGB")
                if build_patch:
                    grids.append(self._grid_patch_arrays(img))
                if build_m:
                    ms.append(image_transform(img, self._fe_image_size()))
            return grids, ms

        from ucod_dpl_tpu.utils.progress import ProgressReporter

        progress = ProgressReporter(
            self.logger, n, f"patch cache {self.set_cfg.DATASET}"
        )
        idx = 0
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
            pending = pool.submit(load_chunk, chunks[0]) if chunks else None
            for ci, paths in enumerate(chunks):
                grids, ms = pending.result()
                pending = (
                    pool.submit(load_chunk, chunks[ci + 1]) if ci + 1 < len(chunks) else None
                )
                c = len(paths)
                if build_patch:
                    flat = np.concatenate(grids)  # (c*ws*ws, h, w, 3)
                    feats = np.asarray(self.feature_extractor.extract(flat), np.float32)
                    per = self.window_size * self.window_size
                    for i in range(c):
                        patch_cache.write(idx + i, feats[i * per : (i + 1) * per])
                if build_m:
                    keys = np.asarray(
                        self.feature_extractor.extract(np.stack(ms)), np.float32
                    )
                    for i in range(c):
                        m_cache.write(idx + i, self._slice_m_windows(keys[i]))
                idx += c
                progress.update(c)
        progress.finish()
        if build_patch:
            patch_cache.flush(meta=self._cache_identity())
        if build_m:
            m_cache.flush(meta=self._cache_identity())

    def get_features(self, img_path: str, crop_center: bool = False):
        """Live multi-resolution extraction; with ``crop_center`` the centre
        half of the image replaces it (the CORAL low-confidence fallback,
        lr_dataset.py:82-134)."""
        img = ImageIO.read_image(img_path, "RGB")
        if crop_center:
            w, h = img.size
            left, top = w // 4, h // 4
            img = img.crop((left, top, left + w // 2, top + h // 2))
        patches = self._grid_patches(img)
        m_patches = self._m_patches(img) if self.require_m_patches else None
        if crop_center:
            arr = image_transform(img, self.image_size)
            key = np.asarray(self.feature_extractor.extract(arr[None]))[0]
            return key[None], patches[None], m_patches[None] if m_patches is not None else None
        return patches, m_patches

    def __getitem__(self, index: int) -> Dict[str, Any]:
        items = super().__getitem__(index)
        patch_cache = self.caches.get("patch")
        h_inputs = np.stack(
            [_to_hwc(a) for a in patch_cache.read(index)]
        ) if patch_cache.mode == "r" else None
        m_inputs = None
        if self.require_m_patches:
            m_cache = self.caches.get("m_patch")
            if m_cache.mode == "r":
                m_inputs = np.stack([_to_hwc(a) for a in m_cache.read(index)])
        items.update({"m_inputs": m_inputs, "h_inputs": h_inputs, "index": index})
        return items


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack equal-shape arrays; pass ragged/None/str entries through as
    lists (counterpart of ``dataloader_utils.collate_fn:13-39``)."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray) and all(
            isinstance(v, np.ndarray) and v.shape == vals[0].shape for v in vals
        ):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float)) and not isinstance(vals[0], bool):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    """Host dataloader: shuffling, batching, numpy collation, background
    prefetch (overlaps disk/decode with device compute), and optional
    process sharding for multi-host SPMD (each process reads its slice of
    the dataset; ``shard=(index, count)``)."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
        shard: Optional[tuple] = None,
        pad_shards: bool = False,
    ):
        """``pad_shards``: wrap-pad the global order so every process gets
        the SAME number of batches (torch DistributedSampler semantics).
        REQUIRED for training loaders — train steps are GSPMD collective
        programs, so a process with one more batch than its peers enters a
        collective the others never join and the pod hangs.  Leave False
        for eval loaders: their metric gather is ragged-aware, and padding
        would double-count the wrapped samples."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard = shard
        self.pad_shards = pad_shards
        self.seed = seed
        self._epoch = 0
        self._skip_batches = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order for the next iteration to ``epoch``.

        The order is a pure function of (seed, epoch) — NOT of how many
        epochs this process already iterated — so a resumed run replays
        exactly the batch order the uninterrupted run would have used, and
        every process of a multi-host run derives the same global order
        (sharding slices it afterwards).  Without a ``set_epoch`` call the
        counter self-advances per iteration (fresh order each epoch)."""
        self._epoch = int(epoch)

    def skip_batches(self, n: int) -> None:
        """Drop the first ``n`` batches of the NEXT iteration (one-shot)
        without loading them — mid-epoch preemption resume: with the
        (seed, epoch)-deterministic order, skipping the batches the
        interrupted run already applied continues its exact trajectory."""
        self._skip_batches = int(n)

    def _indices(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
        if self.shard is not None:
            index, count = self.shard
            if self.pad_shards and len(order) % count:
                # wrap-pad so index::count slices are equal length (see
                # __init__); deterministic: the pad is a pure function of
                # the (seed, epoch) order
                total = -(-len(order) // count) * count
                order = np.concatenate([order, order[: total - len(order)]])
            order = order[index::count]
        return order

    def __len__(self) -> int:
        n = len(self._indices()) if self.shard is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self, order: np.ndarray) -> Iterator[Dict[str, Any]]:
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield collate([self.dataset[int(i)] for i in idx])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = self._indices()
        self._epoch += 1  # self-advance when the caller never set_epoch's
        if self._skip_batches:
            # a skipped full batch is batch_size indices; a drop_last tail
            # would not have been yielded anyway, so slicing keeps the
            # remaining batch boundaries identical
            order = order[self._skip_batches * self.batch_size :]
            self._skip_batches = 0
        if self.prefetch <= 0:
            yield from self._batches(order)
            return

        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []
        stop = threading.Event()

        def producer():
            try:
                for batch in self._batches(order):
                    # bounded put that honours abandonment: if the consumer
                    # stops iterating early (an exception in the training
                    # loop, a preemption), a plain q.put would block forever
                    # once the queue fills, leaking this thread and its
                    # queued batches for the life of the process
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:  # surface loader errors on the consumer
                err.append(e)
            finally:
                # the sentinel must actually land (a dropped sentinel hangs
                # the consumer's q.get forever); bounded retries so an
                # abandoned consumer (stop set, queue full) still lets the
                # thread exit
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            while True:  # unblock a producer stuck in put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10.0)
        if err:
            raise err[0]
