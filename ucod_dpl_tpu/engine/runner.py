"""Runner: object-graph construction, checkpoint management, loop dispatch.

Counterpart of the reference ``StandardRunner``/``LocalRefineRunner``
(``engine/runner/runner.py``), reorganised functionally: model state lives in
explicit param pytrees, device placement is a mesh + shardings rather than
Accelerate-prepared modules.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import jax
import numpy as np

from ucod_dpl_tpu.data import CODDataset, DataLoader, FeatureExtractor, LRDataset
from ucod_dpl_tpu.device import enable_compilation_cache, resolve_compute_dtype
from ucod_dpl_tpu.models import (
    init_discriminator,
    load_decoder_checkpoint,
    save_decoder_checkpoint,
)
from ucod_dpl_tpu.models.dba import init_rev_decoder
from ucod_dpl_tpu.parallel import build_mesh
from ucod_dpl_tpu.utils import Logger, get_logger


class Runner:
    """Stage-1 (UCOD-DPL) runner: student/EMA decoder + discriminator."""

    def __init__(
        self,
        cfg,
        mode: str = "train",
        load_from: Optional[str] = None,
        feature_extractor: Optional[FeatureExtractor] = None,
    ):
        """``feature_extractor``: pass a previously built extractor to share
        it across Runners (the multi-dataset eval CLIs construct one Runner
        per test set — without sharing, each rebuilds the backbone and pays
        its jit closures' re-trace/re-compile again)."""
        self.cfg = cfg
        self.mode = mode
        from ucod_dpl_tpu.parallel.distributed import maybe_initialize_distributed

        maybe_initialize_distributed()
        enable_compilation_cache()
        self._setup_dirs()
        self.logger = Logger(
            "ucod",
            log_file=os.path.join(self.log_path, "run.log"),
            ranks=cfg.log_cfg.get("multi_rank", [0]),
        )
        self.mesh = build_mesh(cfg.get("tpu_cfg", {}).get("mesh"))
        # mesh plumbed through: tpu_cfg.mesh = {"data": N, "model": M>1}
        # runs the backbone tensor-parallel (parallel/tp.py) on eval, cache
        # build, LookTwice crops and serving — not just bespoke scripts
        self.feature_extractor = feature_extractor or FeatureExtractor(
            cfg.dataset_cfg.feature_extractor_cfg,
            compute_dtype=resolve_compute_dtype(cfg),
            mesh=self.mesh,
        )
        self._build_model(load_from)
        self._build_dataloaders()
        self._dump_config()

    # -- setup -----------------------------------------------------------------
    def _setup_dirs(self) -> None:
        self.work_dir = self.cfg.get("work_dir", "./work")
        self.log_path = self.cfg.log_cfg.get("log_path") or os.path.join(
            self.work_dir, "logs"
        )
        self.cfg.log_cfg.log_path = self.log_path
        self.ckp_dir = os.path.join(self.log_path, "ckp")
        os.makedirs(self.ckp_dir, exist_ok=True)

    def _build_model(self, load_from: Optional[str]) -> None:
        mc = self.cfg.model_cfg
        if load_from:
            path = self._resolve_checkpoint(load_from)
            self.logger.log(f"Loading decoder checkpoint from {path}")
            self.decoder_params, self.decoder_ema_params = load_decoder_checkpoint(path)
        else:
            k1, k2 = jax.random.split(jax.random.PRNGKey(self.cfg.get("seed", 42)))
            # independent random init for student and teacher, as the
            # reference constructs two separate RevDecoders (uscod.py:13-14)
            self.decoder_params = init_rev_decoder(k1, mc.dim)
            self.decoder_ema_params = init_rev_decoder(k2, mc.dim)
        self.discriminator_params, self.discriminator_stats = init_discriminator(
            jax.random.PRNGKey(self.cfg.get("seed", 42) + 1),
            feature_size=mc.feature_size,
            feature_dim=mc.dim,
            use_features=mc.get("dis_use_features", False),
        )

    def _dataset_cls(self, set_cfg):
        from ucod_dpl_tpu.utils.registry import DATASETS

        return DATASETS.get(set_cfg.get("type", "USCODDataset"))

    def _dataset_extra_kwargs(self, set_cfg, ds_mode: str) -> dict:
        """Subclass hook for dataset-class-specific constructor kwargs."""
        return {}

    def _make_dataset(self, set_cfg, ds_mode: str, keep_size: bool):
        dc = self.cfg.dataset_cfg
        extra = self._dataset_extra_kwargs(set_cfg, ds_mode)
        if "cache_build_batch" in set_cfg:  # optional device-batch override
            extra["cache_build_batch"] = int(set_cfg["cache_build_batch"])
        return self._dataset_cls(set_cfg)(
            set_cfg,
            dc.feature_extractor_cfg,
            dataset_dir=dc.dataset_dir,
            cache_dir=dc.cache_dir,
            mode=ds_mode,
            keep_size=keep_size,
            image_size=tuple(set_cfg.get("image_size", (518, 518))),
            require_label=set_cfg.get("require_label", False),
            feature_extractor=self.feature_extractor,
            logger=self.logger,
            **extra,
        )

    def _build_dataloaders(self) -> None:
        import jax as _jax

        from ucod_dpl_tpu.parallel.distributed import process_shard

        dc = self.cfg.dataset_cfg
        shard = process_shard() if _jax.process_count() > 1 else None
        self.train_dataset = self.train_dataloader = None
        self.val_dataset = self.val_dataloader = None
        if self.mode == "train":
            if self.cfg.model_cfg.get("lora", {}).get("enable", False):
                # LoRA trains THROUGH the backbone: batches must carry the
                # normalised pixels, not just cached features
                dc.trainset_cfg.require_pixels = True
            self.train_dataset = self._make_dataset(dc.trainset_cfg, "train", keep_size=False)
            tl = dc.trainloader_cfg
            self.train_dataloader = DataLoader(
                self.train_dataset,
                batch_size=tl.get("batch_size", 16),
                shuffle=tl.get("shuffle", True),
                seed=self.cfg.get("seed", 42),
                drop_last=True,
                shard=shard,
                # train steps are collective programs: every process must
                # run the SAME batch count or the pod deadlocks on the
                # extra step (eval stays ragged — its gather handles it)
                pad_shards=True,
            )
            if len(self.train_dataloader) == 0:
                raise ValueError(
                    f"Train dataloader is empty: {len(self.train_dataset)} sample(s) "
                    f"with batch_size={tl.get('batch_size', 16)} and drop_last — "
                    "training would silently run zero steps. Lower "
                    "dataset_cfg.trainloader_cfg.batch_size or add data."
                )
        valset_cfg = dc.valset_cfg
        keep_size = valset_cfg.get("keep_size", self.mode != "train")
        # cache-path mode is "test": the reference's val loaders are built
        # with mode='test' (dataloader_utils.create_test_loader), so caches
        # land under features_cache/{extractor}/test/{DATASET} — matching
        # that layout makes our caches and the reference's interchangeable.
        self.val_dataset = self._make_dataset(valset_cfg, "test", keep_size=keep_size)
        vl = dc.val_loader_cfg
        self.val_dataloader = DataLoader(
            self.val_dataset,
            batch_size=vl.get("batch_size", 1),
            shuffle=False,
            shard=shard,
        )

    def _dump_config(self) -> None:
        try:
            self.cfg.dump_yaml(os.path.join(self.log_path, "config.yaml"))
        except Exception as e:  # never fail a run over config dumping
            self.logger.warning(f"Could not dump config: {e}")

    # -- checkpoints -------------------------------------------------------------
    def _resolve_checkpoint(self, path: str) -> str:
        p = Path(path)
        if p.is_dir():
            inner = p / "model.safetensors"
            if inner.exists():
                return str(inner)
            cands = sorted(
                list(p.glob("*.safetensors")) + list(p.glob("*.pth")) + list(p.glob("*.pt")),
                key=lambda f: f.stat().st_mtime,
            )
            if cands:
                return str(cands[-1])
            raise FileNotFoundError(f"No checkpoint found under {path}")
        return str(p)

    def save_checkpoint(self, epoch: int) -> str:
        path = os.path.join(self.ckp_dir, f"epoch{epoch}.safetensors")
        save_decoder_checkpoint(path, self.decoder_params, self.decoder_ema_params)
        self.logger.log(f"Saved checkpoint {path}")
        return path

    def load_latest_checkpoint(self) -> Optional[str]:
        cands = sorted(
            Path(self.ckp_dir).glob("epoch*.safetensors"),
            key=lambda f: f.stat().st_mtime,
        )
        if not cands:
            return None
        path = str(cands[-1])
        self.decoder_params, self.decoder_ema_params = load_decoder_checkpoint(path)
        return path

    # -- loops ---------------------------------------------------------------------
    def launch_val_look_twice(self) -> Dict[str, float]:
        from . import preempt
        from .eval_loop import LookTwiceEvaluator

        try:
            return LookTwiceEvaluator(self.cfg, self).run()
        except preempt.Preempted:
            raise  # orderly preemption, not a failure — the trainer handles it
        except Exception as e:
            self.logger.error(f"Validation failed: {e}")
            raise

    def launch_train(self) -> None:
        from .train_loop import TrainLoop

        try:
            TrainLoop(self.cfg, self).run()
        except Exception as e:
            self.logger.error(f"Training failed: {e}")
            raise


class LocalRefineRunner(Runner):
    """Stage-2 (CORAL) runner: frozen stage-1 decoder + SparseRefiner."""

    def __init__(
        self,
        cfg,
        mode: str = "val",
        load_from: Optional[str] = None,
        refiner_path: Optional[str] = None,
        feature_extractor: Optional[FeatureExtractor] = None,
    ):
        self._refiner_path = refiner_path
        super().__init__(
            cfg, mode=mode, load_from=load_from, feature_extractor=feature_extractor
        )

    def _build_model(self, load_from: Optional[str]) -> None:
        super()._build_model(load_from)
        from ucod_dpl_tpu.models.udlr import init_sparse_refiner, load_refiner_checkpoint

        mc = self.cfg.model_cfg
        if self._refiner_path:
            self.logger.log(f"Loading refiner checkpoint from {self._refiner_path}")
            self.refiner_params = load_refiner_checkpoint(self._refiner_path)
        else:
            self.refiner_params = init_sparse_refiner(
                jax.random.PRNGKey(self.cfg.get("seed", 42) + 2), dim=mc.dim
            )

    def _dataset_cls(self, set_cfg):
        from ucod_dpl_tpu.utils.registry import DATASETS

        ds_cls = DATASETS.get(set_cfg.get("type", "LRDataset"))
        if ds_cls is CODDataset:  # stage 2 needs the patch-capable dataset
            ds_cls = LRDataset
        return ds_cls

    def _dataset_extra_kwargs(self, set_cfg, ds_mode: str) -> dict:
        return {
            "window_size": self.cfg.model_cfg.get("window_size", 3),
            "require_m_patches": set_cfg.get("require_m_patches", ds_mode == "train"),
        }

    def launch_val(self) -> Dict[str, float]:
        from .coral_loop import LocalRefineEvaluator

        return LocalRefineEvaluator(self.cfg, self).run()

    def launch_train(self) -> None:
        from .coral_loop import LocalRefineTrainLoop

        LocalRefineTrainLoop(self.cfg, self).run()

    def save_refiner(self, epoch: int) -> str:
        from ucod_dpl_tpu.models.udlr import save_refiner_checkpoint

        path = os.path.join(self.log_path, "refiner_ckp", f"epoch{epoch}.safetensors")
        save_refiner_checkpoint(path, self.refiner_params)
        return path
