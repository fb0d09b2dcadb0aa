"""The numpy safetensors reader/writer (``models/safetensors_io.py``):
round trips through real files in every layout the framework ships, and
malformed files are refused."""

import json
import struct

import jax
import numpy as np
import pytest

from ucod_dpl_tpu.models import safetensors_io as st


def _decoder_layout():
    from ucod_dpl_tpu.models.dba import init_rev_decoder

    d = init_rev_decoder(jax.random.PRNGKey(0), 64)
    flat = {**st._tower_to_flat(d, "decoder"), **st._tower_to_flat(d, "decoder_ema")}
    return flat


def _backbone_layout():
    from ucod_dpl_tpu.models.dino import DinoConfig, export_hf_state_dict, init_dino

    cfg = DinoConfig(variant="dinov2", image_size=28, patch_size=14, hidden_size=32,
                     num_layers=1, num_heads=2, mlp_ratio=2)
    return export_hf_state_dict(init_dino(jax.random.PRNGKey(1), cfg), cfg)


def _mixed_dtypes():
    import ml_dtypes

    rng = np.random.default_rng(0)
    return {
        "f32": rng.standard_normal((3, 4)).astype(np.float32),
        "f16": rng.standard_normal((5,)).astype(np.float16),
        "bf16": rng.standard_normal((2, 2)).astype(ml_dtypes.bfloat16),
        "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
        "u8": np.arange(7, dtype=np.uint8),
        "scalar": np.float32(3.5).reshape(()),
        "transposed_view": rng.standard_normal((4, 6)).astype(np.float32).T,
    }


@pytest.mark.parametrize(
    "layout", [_decoder_layout, _backbone_layout, _mixed_dtypes], ids=["decoder", "hf_backbone", "dtypes"]
)
def test_safetensors_numpy_roundtrip(layout, tmp_path):
    flat = layout()
    path = str(tmp_path / "x.safetensors")
    st.save_file(flat, path)
    back = st.load_file(path)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], np.asarray(v)), k
    try:  # the reference implementation reads our file identically
        from safetensors.numpy import load_file as ref_load
    except ImportError:
        return
    ref = ref_load(path)
    assert all(np.array_equal(ref[k], back[k]) for k in flat)


def test_decoder_checkpoint_roundtrip_through_file(tmp_path):
    """The shipped checkpoint layout: save -> file -> load gives the same
    student and teacher params."""
    from ucod_dpl_tpu.models.dba import init_rev_decoder

    d = init_rev_decoder(jax.random.PRNGKey(3), 64)
    e = init_rev_decoder(jax.random.PRNGKey(4), 64)
    path = str(tmp_path / "ckpt.safetensors")
    st.save_decoder_checkpoint(path, d, e)
    d2, e2 = st.load_decoder_checkpoint(path)
    for a, b in zip(jax.tree.leaves((d, e)), jax.tree.leaves((d2, e2))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _header_file(tmp_path, header: dict, data: bytes = b"") -> str:
    hb = json.dumps(header).encode()
    p = tmp_path / "bad.safetensors"
    p.write_bytes(struct.pack("<Q", len(hb)) + hb + data)
    return str(p)


@pytest.mark.parametrize(
    "case", ["short", "header_past_end", "not_json", "offsets_past_end", "shape_mismatch", "bad_dtype"]
)
def test_safetensors_rejects_malformed(case, tmp_path):
    if case == "short":
        p = tmp_path / "bad.safetensors"
        p.write_bytes(b"abc")
        path = str(p)
    elif case == "header_past_end":
        p = tmp_path / "bad.safetensors"
        p.write_bytes(struct.pack("<Q", 1 << 40) + b"{}")
        path = str(p)
    elif case == "not_json":
        p = tmp_path / "bad.safetensors"
        p.write_bytes(struct.pack("<Q", 4) + b"\xff\xfe{{")
        path = str(p)
    elif case == "offsets_past_end":
        path = _header_file(tmp_path, {"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8)
    elif case == "shape_mismatch":
        path = _header_file(tmp_path, {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 16]}}, b"\0" * 16)
    else:
        path = _header_file(tmp_path, {"a": {"dtype": "Q7", "shape": [1], "data_offsets": [0, 1]}}, b"\0")
    with pytest.raises(ValueError):
        st.load_file(path)
