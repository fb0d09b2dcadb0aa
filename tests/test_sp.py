"""Sequence-parallel (ring-attention) backbone on the 8-device CPU mesh:
sharded runs must match the single-device computation, padding included.

The reference has no token-dim scaling at all (whole-image extraction on one
GPU, ``base_dataset.py:124-144``); SP is the mesh axis that grows with
image resolution.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ucod_dpl_tpu.models.dino import DinoConfig, dino_forward, init_dino
from ucod_dpl_tpu.ops.attention import multi_head_attention
from ucod_dpl_tpu.parallel import build_mesh
from ucod_dpl_tpu.parallel.sp import ring_attention

CFG = DinoConfig(
    variant="dinov2",
    image_size=28,
    patch_size=14,
    hidden_size=128,
    num_layers=2,
    num_heads=8,
    mlp_ratio=2,
    use_layerscale=True,
)


def _qkv(b, l, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        jnp.asarray(rng.standard_normal((b, l, d)).astype(np.float32))
        for _ in range(3)
    )


def test_ring_attention_matches_dense():
    q, k, v = _qkv(2, 64, 128)
    ref = multi_head_attention(q, k, v, 8, scale=0.125)
    for mesh_cfg, axis in ((({"data": 2, "seq": 4}), "seq"), (({"seq": 8}), "seq")):
        mesh = build_mesh(mesh_cfg)
        out = jax.jit(
            lambda q, k, v, m=mesh: ring_attention(
                q, k, v, 8, scale=0.125, mesh=m, axis=axis
            )
        )(q, k, v)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_ring_attention_padding_mask():
    """Padded keys must contribute exactly nothing: the ring output on valid
    rows equals dense attention computed on ONLY the valid tokens."""
    b, l_valid, d, nh = 2, 37, 128, 8
    mesh = build_mesh({"seq": 8})
    l_pad = 40  # 37 -> 40 (divisible by 8)
    rng = np.random.default_rng(1)
    q, k, v = (
        jnp.asarray(rng.standard_normal((b, l_pad, d)).astype(np.float32))
        for _ in range(3)
    )
    valid = jnp.broadcast_to(jnp.arange(l_pad) < l_valid, (b, l_pad))

    ref = multi_head_attention(
        q[:, :l_valid], k[:, :l_valid], v[:, :l_valid], nh, scale=0.125
    )
    out = jax.jit(
        lambda q, k, v, m: ring_attention(
            q, k, v, nh, scale=0.125, mesh=mesh, axis="seq", valid=m
        )
    )(q, k, v, valid)
    np.testing.assert_allclose(
        np.asarray(out)[:, :l_valid], np.asarray(ref), rtol=1e-5, atol=1e-6
    )
    assert np.all(np.isfinite(np.asarray(out)))  # pad rows: finite junk, not NaN


def test_ring_attention_n1_with_mask():
    """The no-ring (axis size 1) path honours the mask identically."""
    b, l_valid, l_pad, d, nh = 2, 13, 16, 64, 4
    mesh = build_mesh({"data": 8, "seq": 1})
    rng = np.random.default_rng(2)
    q, k, v = (
        jnp.asarray(rng.standard_normal((b, l_pad, d)).astype(np.float32))
        for _ in range(3)
    )
    valid = jnp.broadcast_to(jnp.arange(l_pad) < l_valid, (b, l_pad))
    ref = multi_head_attention(
        q[:, :l_valid], k[:, :l_valid], v[:, :l_valid], nh, scale=0.25
    )
    out = ring_attention(q, k, v, nh, scale=0.25, mesh=mesh, axis="seq", valid=valid)
    np.testing.assert_allclose(
        np.asarray(out)[:, :l_valid], np.asarray(ref), rtol=1e-5, atol=1e-6
    )


def test_sp_backbone_matches_single_device():
    """Full ViT forward under SP == unsharded; 5 tokens pad to 8 on the ring,
    exercising the pad/mask/slice path end-to-end."""
    bb = init_dino(jax.random.PRNGKey(0), CFG)
    px = jnp.asarray(
        np.random.default_rng(0).standard_normal((4, 28, 28, 3)).astype(np.float32)
    )
    ref = np.asarray(dino_forward(bb, px, CFG)["key_features"])

    mesh = build_mesh({"data": 2, "seq": 4})
    px_sharded = jax.device_put(px, NamedSharding(mesh, P("data", None, None, None)))
    fwd = jax.jit(
        lambda p, x: dino_forward(p, x, CFG, sp_shard=(mesh, "seq"))["key_features"]
    )
    out = np.asarray(fwd(bb, px_sharded))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)


def test_sp_key_fold_matches():
    """The serving fast path (key_fold) under SP: the folded output must slice
    the ring padding off before the patch-grid reshape."""
    bb = init_dino(jax.random.PRNGKey(0), CFG)
    px = jnp.asarray(
        np.random.default_rng(0).standard_normal((2, 28, 28, 3)).astype(np.float32)
    )
    rng = np.random.default_rng(1)
    fw = jnp.asarray(rng.standard_normal((128, 3)).astype(np.float32))
    fb = jnp.asarray(rng.standard_normal((3,)).astype(np.float32))
    ref = np.asarray(dino_forward(bb, px, CFG, key_fold=(fw, fb))["folded_features"])
    mesh = build_mesh({"seq": 8})
    out = np.asarray(
        jax.jit(
            lambda p, x: dino_forward(
                p, x, CFG, sp_shard=(mesh, "seq"), key_fold=(fw, fb)
            )["folded_features"]
        )(bb, px)
    )
    assert out.shape == ref.shape == (2, 2, 2, 3)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)


def test_sp_guards():
    """sp_shard is mutually exclusive with CLS attention / int8, and a
    tp_shard on a DIFFERENT mesh — each must raise a ValueError that
    survives `python -O`.  (sp+tp on ONE mesh is the supported 2D path.)"""
    bb = init_dino(jax.random.PRNGKey(0), CFG)
    px = jnp.zeros((1, 28, 28, 3), jnp.float32)
    mesh = build_mesh({"data": 2, "seq": 4})
    other = build_mesh({"model": 2, "seq": 4})
    sp = (mesh, "seq")
    with pytest.raises(ValueError, match="share one Mesh"):
        dino_forward(bb, px, CFG, sp_shard=sp, tp_shard=(other, "model"))
    with pytest.raises(ValueError, match="parity"):
        dino_forward(bb, px, CFG, sp_shard=sp, want_cls_attention=True)
    with pytest.raises(ValueError, match="single-chip"):
        dino_forward(bb, px, CFG, sp_shard=sp, quant={"layers": []})
    # the ring axis cannot double as the head axis
    q = k = v = jnp.zeros((1, 8, 128), jnp.float32)
    with pytest.raises(ValueError, match="differ from the ring axis"):
        ring_attention(
            q, k, v, 8, scale=0.125, mesh=mesh, axis="seq", h_axis="seq"
        )


def test_sp_reaches_runner_surface(tmp_path):
    """tpu_cfg.mesh = {data, seq>1} must engage sequence parallelism THROUGH
    the product surface (config -> Runner -> FeatureExtractor), with the SP
    extraction equal to the unsharded one and the full LookTwice eval
    finite on the DPxSP mesh."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_eval_e2e import _make_synthetic_dataset, _tiny_cfg
    from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu.engine import Runner

    _make_synthetic_dataset(tmp_path / "RefCOD", n=3)
    cfg = _tiny_cfg(tmp_path)
    cfg.tpu_cfg.mesh = {"data": 2, "seq": 4}
    runner = Runner(cfg, mode="eval")
    assert runner.feature_extractor.sp_shard is not None
    assert runner.feature_extractor.sp_shard[0].shape["seq"] == 4

    result = runner.launch_val_look_twice()  # full eval on the DPxSP mesh
    assert np.isfinite(result["MAE"]) and np.isfinite(result["SMeasure"])

    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    sp_feats = runner.feature_extractor.extract(px)
    plain = FeatureExtractor(
        cfg.dataset_cfg.feature_extractor_cfg, compute_dtype=jnp.float32
    )
    plain.params = jax.tree.map(np.asarray, runner.feature_extractor.params)
    np.testing.assert_allclose(sp_feats, plain.extract(px), rtol=2e-4, atol=2e-5)


def test_ring_attention_vjp_matches_dense_grads():
    """The ring's custom VJP (flash-style backward ring, logsumexp residual)
    against autodiff of dense attention — with padding AND a batch-sharded
    mesh, so dk/dv ride the ring home and masked keys get exact zeros."""
    b, l_valid, l_pad, d, nh, scale = 2, 19, 24, 128, 8, 0.125
    rng = np.random.default_rng(3)
    q, k, v = (
        jnp.asarray(rng.standard_normal((b, l_pad, d)).astype(np.float32))
        for _ in range(3)
    )
    valid = jnp.broadcast_to(jnp.arange(l_pad) < l_valid, (b, l_pad))
    w = jnp.asarray(rng.standard_normal((b, l_valid, d)).astype(np.float32))

    def loss_dense(q, k, v):
        o = multi_head_attention(
            q[:, :l_valid], k[:, :l_valid], v[:, :l_valid], nh, scale=scale
        )
        return jnp.sum(o * w)

    ref = jax.grad(loss_dense, argnums=(0, 1, 2))(q, k, v)
    for mesh_cfg in ({"data": 2, "seq": 4}, {"seq": 8}):
        mesh = build_mesh(mesh_cfg)

        def loss_ring(q, k, v, m=mesh):
            o = ring_attention(
                q, k, v, nh, scale=scale, mesh=m, axis="seq", valid=valid
            )
            return jnp.sum(o[:, :l_valid] * w)

        got = jax.jit(jax.grad(loss_ring, argnums=(0, 1, 2)))(q, k, v)
        for name, a, r in zip("qkv", got, ref):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(r), rtol=1e-4, atol=1e-5,
                err_msg=f"d{name} mismatch on mesh {mesh_cfg}",
            )
            # padded-key rows must receive EXACT zeros (mask, not epsilon)
            if name in "kv":
                assert np.all(np.asarray(a)[:, l_valid:] == 0.0)


def test_sp_lora_train_step_matches_unsharded():
    """The full differentiated product composition under SP: one LoRA joint
    train step (remat on, ring VJP, pad/mask/slice) on a DPxSP mesh must
    produce the same decoder AND adapter updates as the unsharded step."""
    from ucod_dpl_tpu.config import CfgNode
    from ucod_dpl_tpu.engine.train_step import (
        TrainState,
        make_lora_train_step,
        make_optimizer,
    )
    from ucod_dpl_tpu.models.dba import init_rev_decoder
    from ucod_dpl_tpu.models.discriminator import init_discriminator
    from ucod_dpl_tpu.models.lora import init_lora

    cfg = CfgNode(
        {
            "model_cfg": {
                "dim": 128, "feature_size": 8, "ema_weight": 0.99,
                "dis_use_features": False,
                "lora": {"enable": True, "rank": 2, "alpha": 4.0, "remat": True},
            },
            "train_cfg": {"merge_method": "dis", "max_epoch": 25,
                          "start_finetune": -5},
        }
    )
    backbone = init_dino(jax.random.PRNGKey(2), CFG)  # 5 tokens -> pad to 8
    lora0 = init_lora(jax.random.PRNGKey(3), backbone, rank=2)
    opt = make_optimizer(2e-4, 0.95, 25)
    dis_opt = make_optimizer(1e-3, 0.95, 25)
    lora_opt = make_optimizer(1e-4, 0.95, 25)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    dec = init_rev_decoder(k1, 128)
    dis_params, dis_stats = init_discriminator(
        jax.random.PRNGKey(1), feature_size=8, feature_dim=128, use_features=False
    )
    state0 = TrainState(
        decoder=dec, decoder_ema=init_rev_decoder(k2, 128),
        opt_state=opt.init(dec), dis_params=dis_params, dis_stats=dis_stats,
        dis_opt_state=dis_opt.init(dis_params), ema_step=jnp.int32(0),
    )
    rng = np.random.default_rng(42)
    px = jnp.asarray(rng.standard_normal((4, 28, 28, 3)).astype(np.float32))
    pl = jnp.asarray((rng.random((4, 8, 8, 1)) > 0.5).astype(np.float32))
    args = (jnp.float32(0.0), jnp.float32(1.0))

    ref_step = jax.jit(make_lora_train_step(cfg, opt, lora_opt, CFG, jnp.float32))
    s_ref, lora_ref, _, aux_ref = ref_step(
        state0, lora0, lora_opt.init(lora0), backbone, px, pl, *args
    )

    mesh = build_mesh({"data": 2, "seq": 4})
    sp_step = jax.jit(
        make_lora_train_step(
            cfg, opt, lora_opt, CFG, jnp.float32, sp_shard=(mesh, "seq")
        )
    )
    px_sh = jax.device_put(px, NamedSharding(mesh, P("data", None, None, None)))
    s_sp, lora_sp, _, aux_sp = sp_step(
        state0, lora0, lora_opt.init(lora0), backbone, px_sh, pl, *args
    )

    np.testing.assert_allclose(
        float(aux_sp["loss"]), float(aux_ref["loss"]), rtol=1e-5
    )
    np.testing.assert_allclose(
        float(aux_sp["lora_grad_norm"]), float(aux_ref["lora_grad_norm"]), rtol=1e-4
    )
    # parameter tolerance is the FIRST-ADAM-STEP scale, not grad precision:
    # with a fresh optimizer state the update is ~ +-lr * sign(g), so ring
    # reduction-order noise (~1e-7) on near-zero gradient elements becomes a
    # full lr-sized (2e-4 / 1e-4) difference.  Gradient math itself is pinned
    # at 1e-5 by test_ring_attention_vjp_matches_dense_grads; here we pin
    # that no element moved MORE than one Adam step apart.
    for a, r in zip(jax.tree.leaves(lora_sp), jax.tree.leaves(lora_ref)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(r), rtol=1e-3, atol=2.5e-4
        )
    for a, r in zip(jax.tree.leaves(s_sp.decoder), jax.tree.leaves(s_ref.decoder)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(r), rtol=1e-3, atol=4.5e-4
        )


def test_sp_extractor_rejects_int8(tmp_path):
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_eval_e2e import _make_synthetic_dataset, _tiny_cfg
    from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor

    _make_synthetic_dataset(tmp_path / "RefCOD", n=3)
    cfg = _tiny_cfg(tmp_path)
    mesh = build_mesh({"data": 2, "seq": 4})
    with pytest.raises(ValueError, match="single-chip"):
        FeatureExtractor(
            cfg.dataset_cfg.feature_extractor_cfg,
            compute_dtype=jnp.float32,
            mesh=mesh,
            quantize="int8",
        )
