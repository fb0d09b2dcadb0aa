"""Int8 W8A8 inference path (ops/quant.py): mechanism accuracy vs the
full-precision forward, and the serving opt-in.

Quality on the real checkpoints is unmeasurable until the environment
ships backbone weights (same status as scripts/parity.py); these tests pin
the MECHANISM — quantization error bounds, end-to-end logit agreement on
random-init models, and that the default path is byte-identical with
quant=None.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.models.dba import fg_logits_live, init_rev_decoder
from ucod_dpl_tpu.models.dino import DinoConfig, dino_forward, init_dino
from ucod_dpl_tpu.ops.quant import dense_w8a8, quantize_dino_linears, quantize_linear

TINY = dataclasses.replace(
    DinoConfig.dinov2_base(), image_size=56, num_layers=2
)


def _tiny_model(seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = init_dino(k1, TINY)
    decoder = init_rev_decoder(k2, TINY.hidden_size)
    return params, decoder


def test_quantize_linear_roundtrip_bound():
    """Dequantized weights must sit within the symmetric per-column step."""
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((256, 128)).astype(np.float32)) * 0.05
    b = jnp.asarray(rng.standard_normal(128).astype(np.float32))
    qp = quantize_linear({"w": w, "b": b})
    assert qp["w_q"].dtype == jnp.int8
    deq = qp["w_q"].astype(jnp.float32) * qp["w_s"]
    step = np.asarray(qp["w_s"])  # per-column quantization step
    assert np.all(np.abs(np.asarray(deq - w)) <= step / 2 + 1e-7)
    np.testing.assert_array_equal(np.asarray(qp["b"]), np.asarray(b))


def test_dense_w8a8_matches_f32_dense():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((4, 64, 256)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((256, 128)).astype(np.float32)) * 0.05
    b = jnp.asarray(rng.standard_normal(128).astype(np.float32)) * 0.1
    exact = x @ w + b
    q = dense_w8a8(x, quantize_linear({"w": w, "b": b}), jnp.float32)
    rel = float(jnp.linalg.norm(q - exact) / jnp.linalg.norm(exact))
    assert rel < 0.02, rel  # W8A8 per-token/per-channel ~0.5% on gaussians


def test_dense_w8a8_extreme_scale_invariance():
    """Per-token dynamic scales must absorb large per-row magnitude spread
    (the reason per-tensor activation quant is not used)."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((8, 256)).astype(np.float32))
    x = x * jnp.logspace(-3, 3, 8)[:, None]  # 6 decades across rows
    w = jnp.asarray(rng.standard_normal((256, 64)).astype(np.float32))
    b = jnp.zeros((64,), jnp.float32)
    exact = x @ w + b
    q = dense_w8a8(x, quantize_linear({"w": w, "b": b}), jnp.float32)
    # per-ROW relative error: every row must be quantized well, not just
    # the dominant one
    row_rel = np.asarray(
        jnp.linalg.norm(q - exact, axis=-1) / jnp.linalg.norm(exact, axis=-1)
    )
    assert row_rel.max() < 0.02, row_rel


@pytest.mark.parametrize(
    "variant",
    ["dinov2", "dinov1"],  # dinov1: no layerscale, patch 8, eps 1e-12
)
def test_dino_forward_int8_agreement(variant):
    """End-to-end tiny-ViT forward: int8 key features must track f32."""
    cfg = dataclasses.replace(
        DinoConfig.from_type(variant),
        num_layers=2,
        image_size=56 if variant == "dinov2" else 32,
    )
    params = init_dino(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)
    sz = cfg.image_size
    pixels = jnp.asarray(rng.standard_normal((2, sz, sz, 3)).astype(np.float32))
    ref = dino_forward(params, pixels, cfg)["key_features"]
    qparams = quantize_dino_linears(params)
    got = dino_forward(params, pixels, cfg, quant=qparams)["key_features"]
    rel = float(jnp.linalg.norm(got - ref) / jnp.linalg.norm(ref))
    cos = float(
        jnp.vdot(got, ref) / (jnp.linalg.norm(got) * jnp.linalg.norm(ref))
    )
    assert rel < 0.05, rel
    assert cos > 0.995, cos


def test_fg_logits_live_int8_agreement():
    """The quantized live composition (key-fold + decoder) tracks f32 —
    logits correlate and the thresholded masks substantially agree."""
    params, decoder = _tiny_model(seed=7)
    rng = np.random.default_rng(4)
    pixels = jnp.asarray(rng.standard_normal((2, 56, 56, 3)).astype(np.float32))
    ref, _, _ = fg_logits_live(
        params, decoder, pixels, TINY, compute_dtype=jnp.float32, size=8
    )
    qparams = quantize_dino_linears(params)
    got, _, _ = fg_logits_live(
        params, decoder, pixels, TINY, compute_dtype=jnp.float32, size=8,
        quant=qparams,
    )
    ref, got = np.asarray(ref), np.asarray(got)
    corr = np.corrcoef(ref.ravel(), got.ravel())[0, 1]
    assert corr > 0.99, corr
    agree = np.mean((ref > 0) == (got > 0))
    assert agree > 0.9, agree


def test_fg_logits_live_int8_bf16_dtype_plumbing():
    """The on-card configuration is compute_dtype=bf16: the quantized
    composition must run in bf16 end-to-end and still track the bf16
    full-precision path (chip_smoke.py's int8 phase runs it on the card)."""
    params, decoder = _tiny_model(seed=11)
    rng = np.random.default_rng(6)
    pixels = jnp.asarray(rng.standard_normal((2, 56, 56, 3)).astype(np.float32))
    ref, _, _ = fg_logits_live(
        params, decoder, pixels, TINY, compute_dtype=jnp.bfloat16, size=8
    )
    qparams = quantize_dino_linears(params)
    got, _, _ = fg_logits_live(
        params, decoder, pixels, TINY, compute_dtype=jnp.bfloat16, size=8,
        quant=qparams,
    )
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert np.isfinite(got).all()
    corr = np.corrcoef(ref.ravel(), got.ravel())[0, 1]
    assert corr > 0.98, corr


def test_quant_guards():
    """Parity-critical compositions must refuse the int8 path — with a
    real exception (ValueError), not an assert that `python -O` strips."""
    params, _ = _tiny_model()
    qparams = quantize_dino_linears(params)
    pixels = jnp.zeros((1, 56, 56, 3), jnp.float32)
    with pytest.raises(ValueError, match="parity"):
        dino_forward(params, pixels, TINY, quant=qparams, want_cls_attention=True)
    with pytest.raises(ValueError, match="single-chip"):
        dino_forward(params, pixels, TINY, quant=qparams, tp_shard=(object(), "model"))


def test_predictor_int8_smoke():
    """Serving opt-in: quantize='int8' produces valid masks that mostly
    agree with the f32 predictor on the same inputs."""
    from ucod_dpl_tpu.config import CfgNode
    from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor
    from ucod_dpl_tpu.serving import Predictor

    fe = FeatureExtractor(
        CfgNode(
            {
                "type": "dinov2",
                "backbone": "facebook/dinov2-base",
                "backbone_weights": "none",
                "arch": {
                    "hidden_size": 64, "num_layers": 2, "num_heads": 4,
                    "patch_size": 14, "image_size": 56,
                },
            }
        )
    )
    decoder = init_rev_decoder(jax.random.PRNGKey(0), 64)
    kw = dict(image_size=(56, 56), feature_size=8, max_batch=4)
    p32 = Predictor(fe, decoder, **kw)
    p8 = Predictor(fe, decoder, quantize="int8", **kw)

    rng = np.random.default_rng(5)
    imgs = [(rng.random((60, 70, 3)) * 255).astype(np.uint8) for _ in range(3)]
    m32 = p32.predict(imgs)
    m8 = p8.predict(imgs)
    for a, b in zip(m32, m8):
        assert b.shape == (56, 56)
        assert set(np.unique(b)).issubset({0.0, 1.0})
        assert np.mean(a == b) > 0.9, np.mean(a == b)

    with pytest.raises(ValueError, match="int8"):
        Predictor(fe, decoder, quantize="int4", **kw)

def _tiny_fe(quantize=None, hidden=64, mesh=None):
    from ucod_dpl_tpu.config import CfgNode
    from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor

    return FeatureExtractor(
        CfgNode(
            {
                "type": "dinov2",
                "backbone": "facebook/dinov2-base",
                "backbone_weights": "none",
                "arch": {
                    "hidden_size": hidden, "num_layers": 2, "num_heads": 4,
                    "patch_size": 14, "image_size": 56,
                },
            }
        ),
        quantize=quantize,
        mesh=mesh,
    )


def test_feature_extractor_int8_extract_agreement():
    """FeatureExtractor(quantize='int8').extract tracks the f32 extractor
    (same weights: both random-init from the same seed); the CLS-attention
    surface stays FULL precision (pseudo-label parity) — bitwise equal
    across the two extractors."""
    fe32, fe8 = _tiny_fe(), _tiny_fe(quantize="int8")
    rng = np.random.default_rng(7)
    px = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    ref, got = fe32.extract(px), fe8.extract(px)
    corr = np.corrcoef(ref.ravel(), got.ravel())[0, 1]
    assert corr > 0.99, corr
    assert not np.array_equal(ref, got)  # int8 path actually taken
    for a, b in zip(fe32.extract_with_attention(px), fe8.extract_with_attention(px)):
        np.testing.assert_array_equal(a, b)


def test_feature_extractor_int8_dp_mesh():
    """int8 serving COMPOSES with data parallelism: a {data: N} mesh shards
    the batch while every chip runs the full W8A8 backbone — the supported
    cell of the int8 x parallelism matrix (TP and SP are rejected: TP shards
    the very weights quantization folds, SP shards the token dim the
    per-token scales are computed over).  Sharded extract == unsharded."""
    from ucod_dpl_tpu.parallel import build_mesh

    fe8 = _tiny_fe(quantize="int8")
    rng = np.random.default_rng(11)
    px = rng.standard_normal((8, 56, 56, 3)).astype(np.float32)
    ref = fe8.extract(px)

    fe8_dp = _tiny_fe(quantize="int8", mesh=build_mesh({"data": 8}))
    assert fe8_dp.tp_shard is None and fe8_dp.sp_shard is None
    got = fe8_dp.extract(px)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_dataset_cache_refuses_quantized_extractor(tmp_path):
    """Cache builds are a bitwise regeneration contract: handing a dataset
    a quantized extractor must raise before any cache is written."""
    from PIL import Image

    from ucod_dpl_tpu.config import CfgNode
    from ucod_dpl_tpu.data.dataset import CODDataset

    root = tmp_path / "RefCOD" / "TINY"
    for sub in ("im", "gt"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray((rng.random((40, 40, 3)) * 255).astype(np.uint8)).save(
            root / "im" / f"{i}.jpg"
        )
        Image.fromarray((rng.random((40, 40)) > 0.5).astype(np.uint8) * 255).save(
            root / "gt" / f"{i}.png"
        )
    fe_cfg = CfgNode(
        {
            "type": "dinov2",
            "backbone": "facebook/dinov2-base",
            "backbone_weights": "none",
            "arch": {
                "hidden_size": 64, "num_layers": 2, "num_heads": 4,
                "patch_size": 14, "image_size": 56,
            },
        }
    )
    set_cfg = CfgNode(
        {"DATASET": "TINY", "image_size": [56, 56], "load_gt": True}
    )
    from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor

    with pytest.raises(ValueError, match="serving-only"):
        CODDataset(
            set_cfg,
            fe_cfg,
            str(tmp_path / "RefCOD"),
            str(tmp_path / "cache"),
            mode="eval",
            image_size=(56, 56),
            feature_extractor=FeatureExtractor(fe_cfg, quantize="int8"),
        )
    assert not (tmp_path / "cache").exists() or not any(
        (tmp_path / "cache").rglob("*.npy")
    )


@pytest.mark.heavy  # oracle/e2e composition: full gate only (quick-loop rebalance, round 11)
def test_refine_predictor_int8_smoke():
    """Stage-2 serving opt-in: a quantized RefinePredictor yields valid
    masks that substantially agree with the f32 one (all three live
    extraction resolutions ride the W8A8 backbone)."""
    from ucod_dpl_tpu.models.udlr import init_sparse_refiner
    from ucod_dpl_tpu.serving import RefinePredictor

    decoder = init_rev_decoder(jax.random.PRNGKey(0), 64)
    refiner = init_sparse_refiner(jax.random.PRNGKey(1), dim=64)
    kw = dict(
        image_size=(56, 56), window_size=3, window_length=8,
        use_m_patches=False, max_batch=2,
    )
    rp32 = RefinePredictor(_tiny_fe(), decoder, refiner, **kw)
    rp8 = RefinePredictor(_tiny_fe(quantize="int8"), decoder, refiner, **kw)
    rng = np.random.default_rng(9)
    imgs = [(rng.random((64, 72, 3)) * 255).astype(np.uint8) for _ in range(2)]
    m32, m8 = rp32.predict(imgs), rp8.predict(imgs)
    for a, b in zip(m32, m8):
        assert b.shape == (56, 56)
        assert set(np.unique(b)).issubset({0.0, 1.0})
        assert np.mean(a == b) > 0.9, np.mean(a == b)
