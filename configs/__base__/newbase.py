# Framework-wide defaults. Experiment configs override these through the
# _BASE_ chain; the key layout matches the reference's public config surface
# so user configs carry over unchanged.

_save = dict(
    save_mode="model",  # "model" = safetensors only; "all" = +optimizer state
    save_interval=5,
    start_save=-50,  # negative: relative to max_epoch
)

cfg = dict(
    work_dir="./work",
    train_cfg=dict(
        dist_train=True,
        max_epoch=25,
        start_epoch=0,
        start_finetune=-5,  # last |n| epochs: fresh optimizers, APM off
        merge_method="dis",  # APM label merge driven by the discriminator
        merge_alpha=0.5,
        add_noise=False,
        grad_norm=1.0,
        save_cfg=_save,
    ),
    model_cfg=dict(
        decoder="RevDecoder",
        dim=768,
        feature_size=16,
        ema_weight=0.999,
        dis_use_features=True,
        up_sample=False,
        use_attention=False,
        conv_num=1,
        # LoRA joint training of the backbone (the reference's full_model
        # intent, full_model.py:47-72: peft r=2 alpha=4 on q/k/v).  Enable
        # with --opts model_cfg.lora.enable True; saves adapters + a merged
        # HF-layout backbone per checkpoint interval.
        # remat: "none" (least recompute, most activation memory), "dots"
        # (matmul outputs saved, elementwise replayed), or "layer"/True
        # (lowest memory — use for high-res or large-batch fine-tuning).
        # Which is fastest on the H100 is not measured.
        lora=dict(enable=False, rank=2, alpha=4.0, lr=1e-4, remat="none"),
    ),
    val_cfg=dict(
        enable_val=True,
        val_interval=5,
        start_val=-50,
        metric_workers=-1,  # -1: auto (cpu_count//2 on large sets); 0: sync; >0: pool size
    ),
    log_cfg=dict(
        name="ucod-dpl-tpu",
        log_path="./work/logs",
        multi_rank=[0],  # which JAX processes emit logs
    ),
    dataset_cfg=dict(
        trainset_cfg=dict(type="USCODDataset"),
        valset_cfg=dict(type="USCODDataset"),
        trainloader_cfg=dict(),
        val_loader_cfg=dict(),
    ),
    feature_extractor_cfg=dict(),
)
