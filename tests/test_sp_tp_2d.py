"""2D-sharded attention (SP x TP): heads over `model`, tokens ringing over
`seq` — once the one declared hole in the parallelism matrix (the
reference has NO tensor/sequence parallelism at all; SURVEY §2.4 — its
only strategy is DP via accelerate, `train.py:40-63`).

Attention is head-local, so the ring composes with head sharding inside ONE
shard_map: each (seq, model) shard runs the online-softmax merge on its own
head slice and token chunk; k/v chunks ppermute over `seq` within each head
group.  These tests pin 2D == unsharded for the raw ring, the full backbone,
the custom VJP, and the config->Runner product surface on the 8-device CPU
mesh.
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
from ucod_dpl_tpu.parallel.tp import shard_dino_params

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


@pytest.mark.parametrize(
    "mesh_cfg",
    [{"data": 2, "model": 2, "seq": 2}, {"model": 2, "seq": 4}, {"model": 4, "seq": 2}],
    ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()),
)
def test_ring_attention_2d_matches_dense(mesh_cfg):
    q, k, v = _qkv(2, 64, 128)
    ref = multi_head_attention(q, k, v, 8, scale=0.125)
    mesh = build_mesh(mesh_cfg)
    out = jax.jit(
        lambda q, k, v: ring_attention(
            q, k, v, 8, scale=0.125, mesh=mesh, axis="seq", h_axis="model"
        )
    )(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_ring_attention_2d_padding_mask():
    """Padded keys contribute exactly nothing under the 2D layout too."""
    b, l_valid, l_pad, d, nh = 2, 37, 40, 128, 8
    mesh = build_mesh({"data": 2, "model": 2, "seq": 2})
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
            q, k, v, nh, scale=0.125, mesh=mesh, axis="seq", valid=m,
            h_axis="model",
        )
    )(q, k, v, valid)
    np.testing.assert_allclose(
        np.asarray(out)[:, :l_valid], np.asarray(ref), rtol=1e-5, atol=1e-6
    )
    assert np.all(np.isfinite(np.asarray(out)))


def test_ring_attention_2d_vjp_matches_dense_grads():
    """The custom VJP under the 2D layout: the backward ring runs per head
    group; dk/dv padded-key rows still get exact zeros."""
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
    for mesh_cfg in ({"data": 2, "model": 2, "seq": 2}, {"model": 2, "seq": 4}):
        mesh = build_mesh(mesh_cfg)

        def loss_ring(q, k, v, m=mesh):
            o = ring_attention(
                q, k, v, nh, scale=scale, mesh=m, axis="seq", valid=valid,
                h_axis="model",
            )
            return jnp.sum(o[:, :l_valid] * w)

        got = jax.jit(jax.grad(loss_ring, argnums=(0, 1, 2)))(q, k, v)
        for name, a, r in zip("qkv", got, ref):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(r), rtol=1e-4, atol=1e-5,
                err_msg=f"d{name} mismatch on mesh {mesh_cfg}",
            )
            if name in "kv":
                assert np.all(np.asarray(a)[:, l_valid:] == 0.0)


def test_2d_backbone_matches_single_device():
    """Full ViT forward with TP-sharded params AND the seq ring == unsharded.
    5 tokens pad to the ring; the Megatron column/row projections compose
    with the 2D attention (one all-reduce per block from GSPMD)."""
    bb = init_dino(jax.random.PRNGKey(0), CFG)
    px = jnp.asarray(
        np.random.default_rng(0).standard_normal((4, 28, 28, 3)).astype(np.float32)
    )
    ref = np.asarray(dino_forward(bb, px, CFG)["key_features"])

    mesh = build_mesh({"data": 2, "model": 2, "seq": 2})
    bb_tp = shard_dino_params(bb, mesh)
    px_sharded = jax.device_put(px, NamedSharding(mesh, P("data", None, None, None)))
    fwd = jax.jit(
        lambda p, x: dino_forward(
            p, x, CFG, sp_shard=(mesh, "seq"), tp_shard=(mesh, "model")
        )["key_features"]
    )
    out = np.asarray(fwd(bb_tp, px_sharded))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)


def test_2d_key_fold_matches():
    """The serving fast path (key_fold) under the 3-axis mesh."""
    bb = init_dino(jax.random.PRNGKey(0), CFG)
    px = jnp.asarray(
        np.random.default_rng(0).standard_normal((2, 28, 28, 3)).astype(np.float32)
    )
    rng = np.random.default_rng(1)
    fw = jnp.asarray(rng.standard_normal((128, 3)).astype(np.float32))
    fb = jnp.asarray(rng.standard_normal((3,)).astype(np.float32))
    ref = np.asarray(dino_forward(bb, px, CFG, key_fold=(fw, fb))["folded_features"])
    mesh = build_mesh({"model": 2, "seq": 4})
    bb_tp = shard_dino_params(bb, mesh)
    out = np.asarray(
        jax.jit(
            lambda p, x: dino_forward(
                p, x, CFG, sp_shard=(mesh, "seq"), tp_shard=(mesh, "model"),
                key_fold=(fw, fb),
            )["folded_features"]
        )(bb_tp, px)
    )
    assert out.shape == ref.shape == (2, 2, 2, 3)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)


def test_2d_reaches_runner_surface(tmp_path):
    """tpu_cfg.mesh = {data:2, model:2, seq:2} engages the 2D backbone
    THROUGH the product surface (config -> Runner -> FeatureExtractor) —
    this exact mesh raised ValueError before round 5."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_eval_e2e import _make_synthetic_dataset, _tiny_cfg
    from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu.engine import Runner

    _make_synthetic_dataset(tmp_path / "RefCOD", n=3)
    cfg = _tiny_cfg(tmp_path)
    cfg.tpu_cfg.mesh = {"data": 2, "model": 2, "seq": 2}
    runner = Runner(cfg, mode="eval")
    fe = runner.feature_extractor
    assert fe.tp_shard is not None and fe.sp_shard is not None

    result = runner.launch_val_look_twice()  # full eval on the 3-axis mesh
    assert np.isfinite(result["MAE"]) and np.isfinite(result["SMeasure"])

    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    feats_2d = fe.extract(px)
    plain = FeatureExtractor(
        cfg.dataset_cfg.feature_extractor_cfg, compute_dtype=jnp.float32
    )
    plain.params = jax.tree.map(np.asarray, fe.params)
    np.testing.assert_allclose(feats_2d, plain.extract(px), rtol=2e-4, atol=2e-5)
