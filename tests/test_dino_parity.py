"""DINO ViT parity vs HuggingFace torch implementations.

No pretrained weights are available offline, so parity is proven on small
randomly-initialised Dinov2Model / ViTModel instances: we convert their state
dicts into our params and require matching key-features (the hook contract),
CLS attention rows, and final hidden states — including at off-grid input
sizes that exercise bicubic position-embedding interpolation.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ucod_dpl_tpu.models.dino import (
    DinoConfig,
    convert_hf_state_dict,
    dino_forward,
)


def _run_ours(params, cfg, pixels_nchw, want_attn=True):
    pixels = jnp.asarray(np.transpose(pixels_nchw, (0, 2, 3, 1)))
    return dino_forward(params, pixels, cfg, want_cls_attention=want_attn)


@pytest.fixture(scope="module")
def tiny_dinov2():
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
    torch.manual_seed(0)
    model = Dinov2Model(hf_cfg).eval()
    cfg = DinoConfig(
        variant="dinov2",
        image_size=32,
        patch_size=8,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        mlp_ratio=2,
        layer_norm_eps=hf_cfg.layer_norm_eps,
        use_layerscale=True,
    )
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = convert_hf_state_dict(sd, cfg)
    return model, cfg, params


@pytest.fixture(scope="module")
def tiny_vit():
    from transformers import ViTConfig, ViTModel

    hf_cfg = ViTConfig(
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        image_size=32,
        patch_size=8,
        attn_implementation="eager",
    )
    torch.manual_seed(1)
    model = ViTModel(hf_cfg, add_pooling_layer=False).eval()
    cfg = DinoConfig(
        variant="dinov1",
        image_size=32,
        patch_size=8,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        mlp_ratio=2,
        layer_norm_eps=hf_cfg.layer_norm_eps,
        use_layerscale=False,
    )
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = convert_hf_state_dict(sd, cfg)
    return model, cfg, params


def _hook_key(model):
    captured = {}

    def hook(module, inp, out):
        captured["key"] = out.detach()

    model.encoder.layer[-1].attention.attention.key.register_forward_hook(hook)
    return captured


@pytest.mark.parametrize("size", [32, 48])  # native + interpolated pos-embed
def test_dinov2_parity(tiny_dinov2, size):
    model, cfg, params = tiny_dinov2
    captured = _hook_key(model)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, size, size)).astype(np.float32)

    with torch.no_grad():
        out_t = model(torch.from_numpy(x), output_attentions=True)

    ours = _run_ours(params, cfg, x)

    key_t = captured["key"].numpy()
    np.testing.assert_allclose(
        np.asarray(ours["key_tokens"]), key_t, rtol=1e-4, atol=1e-4
    )
    g = size // cfg.patch_size
    np.testing.assert_allclose(
        np.asarray(ours["key_features"]).reshape(2, g * g, -1),
        key_t[:, 1:, :],
        rtol=1e-4,
        atol=1e-4,
    )
    cls_attn_t = out_t.attentions[-1][:, :, 0, :].numpy()
    np.testing.assert_allclose(
        np.asarray(ours["cls_attention"]), cls_attn_t, rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(ours["last_hidden"]),
        out_t.last_hidden_state.numpy(),
        rtol=1e-3,
        atol=1e-4,
    )


@pytest.mark.parametrize("size", [32, 48])
def test_dinov1_parity(tiny_vit, size):
    model, cfg, params = tiny_vit
    captured = _hook_key(model)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, size, size)).astype(np.float32)

    with torch.no_grad():
        out_t = model(
            torch.from_numpy(x), output_attentions=True, interpolate_pos_encoding=True
        )

    ours = _run_ours(params, cfg, x)
    key_t = captured["key"].numpy()
    np.testing.assert_allclose(
        np.asarray(ours["key_tokens"]), key_t, rtol=1e-4, atol=1e-4
    )
    cls_attn_t = out_t.attentions[-1][:, :, 0, :].numpy()
    np.testing.assert_allclose(
        np.asarray(ours["cls_attention"]), cls_attn_t, rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(ours["last_hidden"]),
        out_t.last_hidden_state.numpy(),
        rtol=1e-3,
        atol=1e-4,
    )


def test_key_fold_matches_unfused_eval_path():
    """dino_forward(key_fold=Wk@Wd) + rev_decoder_forward_decoupled must
    reproduce the unfused composition (full key projection -> decoupling ->
    resize -> decoder body) exactly (f32: same maths, different association)."""
    import jax

    from ucod_dpl_tpu.models.dba import (
        init_rev_decoder,
        key_decoupling_fold,
        rev_decoder_forward_decoupled,
        rev_decoder_forward_resized,
    )
    from ucod_dpl_tpu.models.dino import init_dino

    cfg = DinoConfig(
        variant="dinov2", image_size=32, patch_size=8, hidden_size=64,
        num_layers=2, num_heads=4, mlp_ratio=2,
    )
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    backbone = init_dino(k1, cfg)
    decoder = init_rev_decoder(k2, cfg.hidden_size)
    pixels = jnp.asarray(
        np.random.default_rng(6).standard_normal((2, 32, 32, 3)).astype(np.float32)
    )

    out = dino_forward(backbone, pixels, cfg)
    fg_ref, bg_ref, _ = rev_decoder_forward_resized(
        decoder, out["key_features"], 8, with_loss=False
    )

    last_k = backbone["layers"][-1]["k"]
    fold = key_decoupling_fold(last_k["w"], last_k["b"], decoder)
    out_f = dino_forward(backbone, pixels, cfg, key_fold=fold)
    assert "last_hidden" not in out_f and "key_tokens" not in out_f
    assert out_f["folded_features"].shape == (2, 4, 4, 128)
    fg, bg, _ = rev_decoder_forward_decoupled(
        decoder, out_f["folded_features"], 8, with_loss=False
    )
    np.testing.assert_allclose(np.asarray(fg), np.asarray(fg_ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(bg), np.asarray(bg_ref), rtol=2e-4, atol=2e-5)


def test_fg_logits_live_non_square_native_grid():
    """size=None must keep the native (gh, gw) grid — non-square inputs
    (serving Predictor with rectangular image_size feeds the LookTwice crop
    pass) must not be silently resized square."""
    import jax

    from ucod_dpl_tpu.models.dba import fg_logits_live, init_rev_decoder, rev_decoder_forward
    from ucod_dpl_tpu.models.dino import init_dino

    cfg = DinoConfig(
        variant="dinov2", image_size=32, patch_size=8, hidden_size=64,
        num_layers=2, num_heads=4, mlp_ratio=2,
    )
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    backbone = init_dino(k1, cfg)
    decoder = init_rev_decoder(k2, cfg.hidden_size)
    pixels = jnp.asarray(
        np.random.default_rng(8).standard_normal((2, 24, 40, 3)).astype(np.float32)
    )  # grid (3, 5)

    fg, bg, _ = fg_logits_live(backbone, decoder, pixels, cfg, compute_dtype=jnp.float32)
    assert fg.shape == (2, 3, 5, 1)

    out = dino_forward(backbone, pixels, cfg)
    fg_ref, _, _ = rev_decoder_forward(decoder, out["key_features"], with_loss=False)
    np.testing.assert_allclose(np.asarray(fg), np.asarray(fg_ref), rtol=2e-4, atol=2e-5)
