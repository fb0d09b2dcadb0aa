"""LoRA backbone adaptation: zero-init identity, merge math, trainability."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ucod_dpl_tpu.models.dino import DinoConfig, dino_forward, init_dino
from ucod_dpl_tpu.models.lora import apply_lora, init_lora, lora_forward

CFG = DinoConfig(
    variant="dinov2",
    image_size=28,
    patch_size=14,
    hidden_size=32,
    num_layers=2,
    num_heads=4,
    mlp_ratio=2,
    use_layerscale=True,
)


def _setup(seed=0):
    bb = init_dino(jax.random.PRNGKey(seed), CFG)
    lora = init_lora(jax.random.PRNGKey(seed + 1), bb, rank=2)
    px = jnp.asarray(
        np.random.default_rng(0).standard_normal((2, 28, 28, 3)).astype(np.float32)
    )
    return bb, lora, px


def test_zero_init_is_identity():
    bb, lora, px = _setup()
    base = dino_forward(bb, px, CFG)["key_features"]
    adapted = lora_forward(bb, lora, px, CFG)["key_features"]
    np.testing.assert_allclose(np.asarray(base), np.asarray(adapted), rtol=1e-6)


def test_merge_matches_explicit_delta():
    bb, lora, px = _setup()
    # random B so the delta is non-trivial
    rng = np.random.default_rng(1)
    for entry in lora:
        for t in entry:
            entry[t]["b"] = jnp.asarray(
                rng.standard_normal(entry[t]["b"].shape).astype(np.float32) * 0.1
            )
    merged = apply_lora(bb, lora)
    w0 = np.asarray(bb["layers"][0]["q"]["w"])
    a = np.asarray(lora[0]["q"]["a"])
    b = np.asarray(lora[0]["q"]["b"])
    expect = w0 + (4.0 / 2.0) * (a @ b)
    np.testing.assert_allclose(
        np.asarray(merged["layers"][0]["q"]["w"]), expect, rtol=1e-5, atol=1e-6
    )


def test_remat_forward_and_grad_match():
    """jax.checkpoint layers: same forward, same LoRA gradients."""
    bb, lora, px = _setup()
    base = dino_forward(bb, px, CFG)["key_features"]
    remat = dino_forward(bb, px, CFG, remat=True)["key_features"]
    np.testing.assert_allclose(np.asarray(base), np.asarray(remat), rtol=1e-6)

    def loss(lora_params, use_remat):
        out = lora_forward(
            jax.lax.stop_gradient(bb), lora_params, px, CFG, remat=use_remat
        )
        return jnp.sum(out["key_features"] ** 2)

    g1 = jax.grad(lambda l: loss(l, False))(lora)
    for mode in (True, "dots"):  # layer-granularity and matmul-saving policy
        g2 = jax.grad(lambda l: loss(l, mode))(lora)
        np.testing.assert_allclose(
            np.asarray(g1[0]["q"]["b"]), np.asarray(g2[0]["q"]["b"]),
            rtol=1e-5, atol=1e-6, err_msg=f"remat={mode}",
        )
    with pytest.raises(ValueError, match="dots"):
        dino_forward(bb, px, CFG, remat="typo")


def test_lora_gradients_flow_only_to_adapters():
    bb, lora, px = _setup()

    def loss_fn(lora_params):
        out = lora_forward(jax.lax.stop_gradient(bb), lora_params, px, CFG)
        return jnp.sum(out["key_features"] ** 2)

    grads = jax.grad(loss_fn)(lora)
    ga = np.asarray(grads[0]["q"]["a"])
    gb = np.asarray(grads[0]["q"]["b"])
    # with B=0, dL/dB is nonzero while dL/dA is zero (classic LoRA init)
    assert np.allclose(ga, 0)
    assert not np.allclose(gb, 0)
    assert np.all(np.isfinite(gb))
