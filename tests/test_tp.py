"""Tensor-parallel backbone on the 8-device CPU mesh: sharded runs must match
the single-device computation."""

import os

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ucod_dpl_tpu.models.dino import DinoConfig, dino_forward, init_dino
from ucod_dpl_tpu.parallel import build_mesh
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


def test_tp_backbone_matches_single_device():
    bb = init_dino(jax.random.PRNGKey(0), CFG)
    px = jnp.asarray(
        np.random.default_rng(0).standard_normal((4, 28, 28, 3)).astype(np.float32)
    )
    ref = np.asarray(dino_forward(bb, px, CFG)["key_features"])

    mesh = build_mesh({"data": 4, "model": 2})
    bb_sharded = shard_dino_params(bb, mesh)
    px_sharded = jax.device_put(px, NamedSharding(mesh, P("data", None, None, None)))

    fwd = jax.jit(
        lambda p, x: dino_forward(p, x, CFG, tp_shard=(mesh, "model"))["key_features"]
    )
    out = np.asarray(fwd(bb_sharded, px_sharded))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_tp_attention_matches_dense():
    from ucod_dpl_tpu.ops.attention import multi_head_attention, tp_multi_head_attention

    mesh = build_mesh({"data": 2, "model": 4})
    rng = np.random.default_rng(1)
    b, l, nh, hd = 2, 64, 8, 16
    q = jnp.asarray(rng.standard_normal((b, l, nh * hd)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, l, nh * hd)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((b, l, nh * hd)).astype(np.float32))
    ref = multi_head_attention(q, k, v, nh, scale=0.25)
    out = jax.jit(
        lambda q, k, v: tp_multi_head_attention(
            q, k, v, nh, scale=0.25, mesh=mesh, axis="model"
        )
    )(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_build_mesh_refuses_partial_coverage():
    """A mesh that would silently strand devices must raise (e.g. asking for
    model=3 on 8 devices used to quietly build a 6-device mesh)."""
    import pytest

    with pytest.raises(ValueError, match="device"):
        build_mesh({"data": -1, "model": 3})  # 3 does not divide 8
    with pytest.raises(ValueError, match="device"):
        build_mesh({"data": 2, "model": 2})  # covers 4 of 8
    m = build_mesh({"data": -1, "model": 2})
    assert m.shape["data"] * m.shape["model"] == 8


def test_tp_reaches_runner_surface(tmp_path):
    """tpu_cfg.mesh = {data, model>1} must engage
    tensor parallelism THROUGH the product surface (config -> Runner ->
    FeatureExtractor), with the TP extraction equal to the unsharded one."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_eval_e2e import _make_synthetic_dataset, _tiny_cfg
    from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu.engine import Runner

    _make_synthetic_dataset(tmp_path / "RefCOD", n=3)
    cfg = _tiny_cfg(tmp_path)
    cfg.tpu_cfg.mesh = {"data": 4, "model": 2}
    runner = Runner(cfg, mode="eval")
    assert runner.feature_extractor.tp_shard is not None
    assert runner.feature_extractor.tp_shard[0].shape["model"] == 2

    result = runner.launch_val_look_twice()  # full eval on the DPxTP mesh
    assert np.isfinite(result["MAE"]) and np.isfinite(result["SMeasure"])

    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    tp_feats = runner.feature_extractor.extract(px)
    plain = FeatureExtractor(
        cfg.dataset_cfg.feature_extractor_cfg, compute_dtype=jnp.float32
    )
    plain.params = jax.tree.map(np.asarray, runner.feature_extractor.params)
    np.testing.assert_allclose(tp_feats, plain.extract(px), rtol=2e-4, atol=2e-5)


def test_tp_runner_rejects_indivisible_heads(tmp_path):
    import sys

    import pytest

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_eval_e2e import _make_synthetic_dataset, _tiny_cfg
    from ucod_dpl_tpu.engine import Runner

    _make_synthetic_dataset(tmp_path / "RefCOD", n=3)
    cfg = _tiny_cfg(tmp_path)
    cfg.dataset_cfg.feature_extractor_cfg.arch["num_heads"] = 3
    cfg.tpu_cfg.mesh = {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="heads"):
        Runner(cfg, mode="eval")
