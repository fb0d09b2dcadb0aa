"""LoRA end-to-end surface.

The reference's end-to-end LoRA intent (``models/modules/full_model.py:47-72``
— peft r=2 alpha=4 on q/k/v; broken upstream) as a working, config-reachable
feature: ``model_cfg.lora.enable`` routes stage-1 training through
``make_lora_train_step`` (live backbone, adapters + decoder trained jointly),
checkpoints save the adapters AND a densely-merged HF-layout backbone that
the ordinary weight-loading path consumes.
"""

import glob
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.config import CfgNode

pytestmark = pytest.mark.heavy  # multi-process / e2e: excluded from the quick loop

DIM = 64


def test_hf_state_dict_roundtrip(tmp_path):
    """save_hf_checkpoint -> load_hf_checkpoint must round-trip bit-exactly
    for both variants.  Must go through an actual FILE: safetensors
    serialises raw buffers, so a non-contiguous transpose view in the export
    corrupts silently while an in-memory dict comparison stays clean (this
    exact bug shipped the patch-embed kernel scrambled)."""
    from ucod_dpl_tpu.models.dino import (
        DinoConfig,
        init_dino,
        load_hf_checkpoint,
        save_hf_checkpoint,
    )

    for variant, layerscale in (("dinov2", True), ("dinov1", False)):
        cfg = DinoConfig(
            variant=variant, image_size=28, patch_size=14, hidden_size=32,
            num_layers=2, num_heads=2, mlp_ratio=2, use_layerscale=layerscale,
        )
        params = init_dino(jax.random.PRNGKey(0), cfg)
        path = str(tmp_path / f"{variant}.safetensors")
        save_hf_checkpoint(path, params, cfg)
        back = load_hf_checkpoint(path, cfg)
        flat_a, tree_a = jax.tree.flatten(params)
        flat_b, tree_b = jax.tree.flatten(back)
        assert tree_a == tree_b
        for a, b in zip(flat_a, flat_b):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lora_checkpoint_roundtrip(tmp_path):
    from ucod_dpl_tpu.models.dino import DinoConfig, init_dino
    from ucod_dpl_tpu.models.lora import (
        init_lora,
        load_lora_checkpoint,
        save_lora_checkpoint,
    )

    cfg = DinoConfig(
        variant="dinov2", image_size=28, patch_size=14, hidden_size=32,
        num_layers=3, num_heads=2, mlp_ratio=2, use_layerscale=True,
    )
    params = init_dino(jax.random.PRNGKey(0), cfg)
    lora = init_lora(jax.random.PRNGKey(1), params, rank=2)
    # make B nonzero so the roundtrip is non-trivial
    lora[1]["k"]["b"] = lora[1]["k"]["b"] + 0.5
    path = str(tmp_path / "lora.safetensors")
    save_lora_checkpoint(path, lora)
    back = load_lora_checkpoint(path)
    assert len(back) == len(lora)
    for a, b in zip(lora, back):
        for t in ("q", "k", "v"):
            np.testing.assert_array_equal(np.asarray(a[t]["a"]), np.asarray(b[t]["a"]))
            np.testing.assert_array_equal(np.asarray(a[t]["b"]), np.asarray(b[t]["b"]))


def test_lora_train_e2e_tiny(tmp_path):
    """CLI-equivalent e2e: model_cfg.lora.enable=True through the Runner ->
    finite losses, adapters actually update, merged backbone reproduces the
    adapted features through the standard loading path."""
    from test_eval_e2e import _make_synthetic_dataset, _tiny_cfg
    from ucod_dpl_tpu.engine import Runner
    from ucod_dpl_tpu.models.dino import dino_forward, load_hf_checkpoint
    from ucod_dpl_tpu.models.lora import load_lora_checkpoint, lora_forward
    from ucod_dpl_tpu.utils.fileio import ArrayCache

    _make_synthetic_dataset(tmp_path / "RefCOD", n=4)
    cfg = _tiny_cfg(tmp_path)
    cfg.train_cfg = CfgNode(
        {
            "max_epoch": 2,
            "start_finetune": -1,
            "merge_method": "dis",
            "start_epoch": 0,
            "lr0": 2e-4,
            "dis_lr0": 1e-3,
            "dis_intertrain": 2,
            "dis_epoch": 1,
            "step_lr_size": 25,
            "step_lr_gamma": 0.95,
            "save_cfg": {"save_mode": "model", "save_interval": 1, "start_save": -50},
        }
    )
    cfg.val_cfg.enable_val = False
    cfg.dataset_cfg.trainloader_cfg.batch_size = 2
    cfg.model_cfg.lora = CfgNode(
        {"enable": True, "rank": 2, "alpha": 4.0, "lr": 1e-3, "remat": True}
    )

    rng = np.random.default_rng(0)
    pl_cache = ArrayCache(
        os.path.join(str(tmp_path / "cache"), "pseudo_label_cache", "TINY")
    )
    pl_cache.dump_list(
        [(rng.random((4, 4, 1)) > 0.5).astype(np.float32) for _ in range(4)]
    )

    runner = Runner(cfg, mode="train")
    runner.launch_train()

    # adapters + merged backbones checkpointed each epoch
    adapters = sorted(
        glob.glob(os.path.join(cfg.log_cfg.log_path, "ckp", "lora_epoch*.safetensors"))
    )
    merged = sorted(
        glob.glob(
            os.path.join(
                cfg.log_cfg.log_path, "ckp", "backbone_merged_epoch*.safetensors"
            )
        )
    )
    assert len(adapters) == 2 and len(merged) == 2

    lora = load_lora_checkpoint(adapters[-1])
    # B init is zero; training must have moved it (nonzero grads flow
    # through the flash-attention VJP into the adapters)
    b_norm = float(
        sum(float(jnp.sum(jnp.abs(e[t]["b"]))) for e in lora for t in ("q", "k", "v"))
    )
    assert np.isfinite(b_norm) and b_norm > 0.0, "adapters never updated"

    # decoder finite and moved
    assert np.all(np.isfinite(np.asarray(runner.decoder_params.decoupling_w)))

    # merged checkpoint reproduces the adapted forward through the ordinary
    # HF loading path
    fe = runner.feature_extractor
    merged_params = load_hf_checkpoint(merged[-1], fe.config)
    px = jnp.asarray(rng.standard_normal((1, 56, 56, 3)), jnp.float32)
    lc = cfg.model_cfg.lora
    adapted = lora_forward(
        fe.params, lora, px, fe.config, rank=int(lc.rank), alpha=float(lc.alpha),
        compute_dtype=jnp.float32,
    )["key_features"]
    via_merged = dino_forward(
        merged_params, px, cfg=fe.config, compute_dtype=jnp.float32
    )["key_features"]
    np.testing.assert_allclose(
        np.asarray(adapted), np.asarray(via_merged), rtol=2e-5, atol=2e-5
    )


def test_lora_full_state_resume(tmp_path):
    """save_mode='all' LoRA runs checkpoint the adapters + their optimizer
    moments alongside TrainState, and --resume restores them (without this,
    a resumed LoRA run silently restarted the adapters from scratch)."""
    from test_eval_e2e import _make_synthetic_dataset, _tiny_cfg
    from ucod_dpl_tpu.engine import Runner
    from ucod_dpl_tpu.models.lora import load_lora_checkpoint
    from ucod_dpl_tpu.utils.fileio import ArrayCache

    _make_synthetic_dataset(tmp_path / "RefCOD", n=4)
    cfg = _tiny_cfg(tmp_path)
    cfg.train_cfg = CfgNode(
        {
            "max_epoch": 2,
            "start_finetune": -1,
            "merge_method": "dis",
            "start_epoch": 0,
            "lr0": 2e-4,
            "dis_lr0": 1e-3,
            "dis_intertrain": 2,
            "dis_epoch": 1,
            "step_lr_size": 25,
            "step_lr_gamma": 0.95,
            "save_cfg": {"save_mode": "all", "save_interval": 1, "start_save": -50},
        }
    )
    cfg.val_cfg.enable_val = False
    cfg.dataset_cfg.trainloader_cfg.batch_size = 2
    cfg.model_cfg.lora = CfgNode(
        {"enable": True, "rank": 2, "alpha": 4.0, "lr": 1e-3, "remat": True}
    )

    rng = np.random.default_rng(0)
    pl_cache = ArrayCache(
        os.path.join(str(tmp_path / "cache"), "pseudo_label_cache", "TINY")
    )
    pl_cache.dump_list(
        [(rng.random((4, 4, 1)) > 0.5).astype(np.float32) for _ in range(4)]
    )

    Runner(cfg, mode="train").launch_train()
    ckp = os.path.join(cfg.log_cfg.log_path, "ckp")
    assert os.path.exists(os.path.join(ckp, "state_epoch1_lora.npz"))
    lora_e1 = load_lora_checkpoint(os.path.join(ckp, "lora_epoch1.safetensors"))
    lora_e2 = load_lora_checkpoint(os.path.join(ckp, "lora_epoch2.safetensors"))

    # resume from epoch 1 and run one more epoch: the resumed run must START
    # from epoch-1 adapters (not fresh zeros) and end somewhere different
    # from its start
    cfg.train_cfg.resume = os.path.join(ckp, "state_epoch1")
    cfg.train_cfg.max_epoch = 2
    runner2 = Runner(cfg, mode="train")
    runner2.launch_train()
    lora_resumed = load_lora_checkpoint(os.path.join(ckp, "lora_epoch2.safetensors"))

    def norm_diff(a, b):
        return float(
            sum(
                float(jnp.sum(jnp.abs(x[t][n] - y[t][n])))
                for x, y in zip(a, b)
                for t in ("q", "k", "v")
                for n in ("a", "b")
            )
        )

    # deterministic dataloader order + restored opt moments: the resumed
    # epoch-2 adapters match the uninterrupted run's epoch-2 adapters
    assert norm_diff(lora_resumed, lora_e2) < 1e-5, norm_diff(lora_resumed, lora_e2)
    assert norm_diff(lora_resumed, lora_e1) > 1e-7  # and they did move
