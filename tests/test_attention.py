"""The backbone's attention wrapper (``ops/attention.py``): agreement with
the plain XLA reference, its gradient, garbage outside the attended rows,
and the implementation choice over platform x dtype x differentiation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ucod_dpl_tpu import device
from ucod_dpl_tpu.ops.attention import _xla_attention, multi_head_attention

# (batch, length, heads, head_dim): ViT-B's 12x64 at odd and 64-multiple
# lengths, and an odd head count
SHAPES = [(2, 37, 12, 64), (1, 64, 12, 64), (2, 50, 3, 16)]
# bf16 rounds inputs, probabilities and output (~2e-3 norm-relative each)
TOL = {jnp.float32: 1e-5, jnp.bfloat16: 1e-2}


def _qkv(b, l, nh, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.standard_normal((b, l, nh * hd)), dtype) for _ in range(3))


def _reference(q, k, v, nh, scale):
    """f32 per-head XLA reference on the packed layout."""
    b, l, d = q.shape
    hd = d // nh
    split = lambda x: x.astype(jnp.float32).reshape(b, l, nh, hd).transpose(0, 2, 1, 3).reshape(b * nh, l, hd)  # noqa: E731
    o = _xla_attention(split(q), split(k), split(v), scale)
    return o.reshape(b, nh, l, hd).transpose(0, 2, 1, 3).reshape(b, l, d)


def _norm_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_matches_xla_reference(shape, dtype):
    b, l, nh, hd = shape
    q, k, v = _qkv(b, l, nh, hd, dtype)
    scale = 1.0 / np.sqrt(hd)
    got = jax.jit(lambda q, k, v: multi_head_attention(q, k, v, nh, scale=scale))(q, k, v)
    assert got.shape == q.shape and got.dtype == dtype
    assert _norm_rel(got, _reference(q, k, v, nh, scale)) < TOL[dtype]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2]], ids=lambda s: "x".join(map(str, s)))
def test_attention_grad_matches_xla_vjp(shape, dtype):
    b, l, nh, hd = shape
    q, k, v = _qkv(b, l, nh, hd, dtype, seed=1)
    scale = 1.0 / np.sqrt(hd)
    cot = jnp.asarray(np.random.default_rng(2).standard_normal((b, l, nh * hd)), jnp.float32)

    def loss(f):
        return lambda q, k, v: jnp.sum(f(q, k, v).astype(jnp.float32) * cot)

    g = jax.grad(loss(lambda *a: multi_head_attention(*a, nh, scale=scale)), argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(loss(lambda *a: _reference(*a, nh, scale)), argnums=(0, 1, 2))(
        *(x.astype(jnp.float32) for x in (q, k, v))
    )
    for a, r in zip(g, g_ref):
        assert a.dtype == dtype  # cotangents come back in the primal dtype
        assert _norm_rel(a, r) < 2 * TOL[dtype]


@pytest.mark.parametrize("garbage", [np.inf, np.nan, 3e38])
def test_attention_garbage_tail_rows(garbage):
    """q/k/v sliced on device out of a larger buffer whose tail rows hold
    garbage: nothing outside the attended rows may reach the output."""
    b, l, nh, hd = 2, 37, 12, 64
    q, k, v = _qkv(b, l, nh, hd, jnp.float32, seed=3)
    tail = jnp.full((b, 27, nh * hd), garbage, jnp.float32)
    scale = 1.0 / np.sqrt(hd)

    @jax.jit
    def run(q, k, v):
        bq, bk, bv = (jnp.concatenate([x, tail], axis=1) for x in (q, k, v))
        return multi_head_attention(bq[:, :l], bk[:, :l], bv[:, :l], nh, scale=scale)

    got = run(q, k, v)
    assert np.isfinite(np.asarray(got)).all()
    assert _norm_rel(got, _reference(q, k, v, nh, scale)) < TOL[jnp.float32]


@pytest.mark.parametrize("differentiated", [False, True], ids=["fwd", "grad"])
@pytest.mark.parametrize(
    "dtype", [jnp.float32, jnp.bfloat16, jnp.float16], ids=["f32", "bf16", "f16"]
)
@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_attention_implementation_choice(platform, dtype, differentiated, monkeypatch):
    """cuDNN for half precision on the GPU, XLA for f32 and on the CPU —
    the same choice for the forward and for the gradient."""
    monkeypatch.setattr(device, "platform", lambda: platform)
    chosen = []
    real = jax.nn.dot_product_attention

    def recording(*a, implementation=None, **kw):
        chosen.append(implementation)
        return real(*a, implementation="xla", **kw)  # cuDNN itself needs the card

    monkeypatch.setattr(jax.nn, "dot_product_attention", recording)
    q, k, v = _qkv(1, 9, 2, 8, dtype)
    f = lambda q: jnp.sum(multi_head_attention(q, k, v, 2, scale=0.3).astype(jnp.float32))  # noqa: E731
    (jax.grad(f) if differentiated else f)(q)
    want = "cudnn" if platform == "gpu" and dtype != jnp.float32 else "xla"
    assert chosen and set(chosen) == {want}


@pytest.mark.parametrize("head_dim", [12, 264])
def test_attention_gpu_refuses_unsupported_shape(head_dim, monkeypatch):
    """A head width cuDNN's flash kernel cannot take raises on the GPU; the
    program never switches implementation behind the caller's back."""
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    q, k, v = _qkv(1, 5, 2, head_dim, jnp.bfloat16)
    with pytest.raises(ValueError, match="cuDNN flash attention"):
        multi_head_attention(q, k, v, 2, scale=0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 1370, 12, 64), (4, 2917, 12, 64)], ids=["518px", "756px"])
def test_cudnn_attention_matches_reference_on_card(shape, gpu_device):
    """On the card: cuDNN bf16 attention at the backbone's real shapes
    against the f32 XLA reference at the highest matmul precision."""
    b, l, nh, hd = shape
    q, k, v = _qkv(b, l, nh, hd, jnp.bfloat16)
    scale = 1.0 / np.sqrt(hd)
    assert device.attention_implementation(q.dtype, hd) == "cudnn"
    got = jax.jit(lambda q, k, v: multi_head_attention(q, k, v, nh, scale=scale))(q, k, v)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda q, k, v: _reference(q, k, v, nh, scale))(q, k, v)
    assert _norm_rel(got, ref) < TOL[jnp.bfloat16]
