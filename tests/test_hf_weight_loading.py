"""Loading real HuggingFace checkpoint *directories* (the production weight
path): save a tiny random Dinov2Model with save_pretrained, load it through
our converter, verify forward parity."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ucod_dpl_tpu.models.dino import DinoConfig, dino_forward, load_hf_checkpoint


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from transformers import Dinov2Config, Dinov2Model

    hf_cfg = Dinov2Config(
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        mlp_ratio=2,
        image_size=32,
        patch_size=8,
        attn_implementation="eager",
    )
    torch.manual_seed(3)
    model = Dinov2Model(hf_cfg).eval()
    out = tmp_path_factory.mktemp("hf") / "dinov2-tiny"
    model.save_pretrained(str(out))
    return str(out), model


def test_load_hf_directory_and_forward_parity(hf_dir):
    path, model = hf_dir
    cfg = DinoConfig(
        variant="dinov2",
        image_size=32,
        patch_size=8,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        mlp_ratio=2,
        use_layerscale=True,
    )
    params = load_hf_checkpoint(path, cfg)

    captured = {}
    model.encoder.layer[-1].attention.attention.key.register_forward_hook(
        lambda m, i, o: captured.__setitem__("key", o.detach())
    )
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        model(torch.from_numpy(x))

    ours = dino_forward(params, jnp.asarray(np.transpose(x, (0, 2, 3, 1))), cfg)
    np.testing.assert_allclose(
        np.asarray(ours["key_tokens"]), captured["key"].numpy(), rtol=1e-4, atol=1e-4
    )


def test_feature_extractor_discovers_weights(hf_dir, tmp_path):
    """FeatureExtractor finds HF weights through the config search paths."""
    path, _ = hf_dir
    from ucod_dpl_tpu.config import CfgNode
    from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor

    fe = FeatureExtractor(
        CfgNode(
            {
                "type": "dinov2",
                "backbone": "facebook/dinov2-base",
                "backbone_weights": path,
                "arch": {
                    "hidden_size": 64,
                    "num_layers": 2,
                    "num_heads": 4,
                    "patch_size": 8,
                    "image_size": 32,
                },
            }
        )
    )
    rng = np.random.default_rng(1)
    feats = fe.extract(rng.standard_normal((1, 32, 32, 3)).astype(np.float32))
    assert feats.shape == (1, 4, 4, 64)
    assert np.all(np.isfinite(np.asarray(feats)))


def test_extract_raises_on_nonfinite_features(monkeypatch):
    """The finiteness guard must fail loudly — a NaN forward otherwise
    poisons every cache and evaluates as all-background masks (round-4)."""
    import jax.numpy as jnp
    import pytest

    from ucod_dpl_tpu.config.config import CfgNode
    from ucod_dpl_tpu.data import feature_extractor as FE

    fe = FE.FeatureExtractor(
        CfgNode({
            "type": "dinov2", "backbone": "facebook/dinov2-base",
            "arch": {"hidden_size": 64, "num_layers": 1, "num_heads": 4,
                     "patch_size": 8, "image_size": 32},
        })
    )
    rng = np.random.default_rng(0)
    monkeypatch.setattr(
        fe, "_forward",
        lambda want: (lambda p, x, q: jnp.full((1, 4, 4, 64), jnp.nan)),
    )
    with pytest.raises(FloatingPointError, match="non-finite"):
        fe.extract(rng.standard_normal((1, 32, 32, 3)).astype(np.float32))


def test_resolve_compute_dtype():
    import jax.numpy as jnp

    from ucod_dpl_tpu.config.config import CfgNode
    from ucod_dpl_tpu.device import resolve_compute_dtype

    # unset: the platform default (float32 on the CPU)
    assert resolve_compute_dtype(CfgNode({})) == jnp.float32
    assert resolve_compute_dtype(
        CfgNode({"tpu_cfg": {"compute_dtype": "bfloat16"}})
    ) == jnp.bfloat16
    assert resolve_compute_dtype(
        CfgNode({"tpu_cfg": {"compute_dtype": "float32"}})
    ) == jnp.float32
