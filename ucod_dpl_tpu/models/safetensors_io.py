"""Checkpoint compatibility with the reference's safetensors format.

The released UCOD-DPL checkpoints (``weights/UCOD_DPL_dinov{1,2}.safetensors``)
contain 14 fp32 tensors: ``decoder{,_ema}.decoupling.{weight,bias}``,
``...conv_out_{fg,bg}.{weight,bias}`` and ``...learnable_embedding`` —
verified against the reference's save path (``runner.py:165-185``).

This module reads and writes the safetensors format with numpy alone
(:func:`load_file`, :func:`save_file`), and converts between that
torch-layout checkpoint (OIHW conv kernels) and our NHWC/matmul parameter
pytrees, in both directions, so checkpoints are interchangeable with the
PyTorch reference.

The format: an 8-byte little-endian header length N, N bytes of JSON
mapping each tensor name to ``{"dtype", "shape", "data_offsets": [begin,
end]}`` (offsets into the byte buffer that follows the header; an optional
``"__metadata__"`` entry holds strings), then the raw little-endian,
C-order tensor bytes.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import ml_dtypes
import numpy as np

from .dba import RevDecoderParams

_DTYPES = {
    "F64": np.dtype("<f8"),
    "F32": np.dtype("<f4"),
    "F16": np.dtype("<f2"),
    "BF16": np.dtype(ml_dtypes.bfloat16),
    "I64": np.dtype("<i8"),
    "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"),
    "U8": np.dtype("u1"),
    "BOOL": np.dtype("?"),
}
_CODES = {dt: code for code, dt in _DTYPES.items()}


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Read every tensor of a safetensors file into numpy arrays.  Raises
    ``ValueError`` on a malformed file (bad header, unknown dtype, offsets
    outside the buffer or disagreeing with the shape)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", raw[:8])
    if n > len(raw) - 8:
        raise ValueError(f"{path}: header length {n} exceeds the file size {len(raw)}")
    try:
        header = json.loads(raw[8 : 8 + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: unreadable safetensors header ({e})") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: safetensors header is not a JSON object")
    buf = memoryview(raw)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dt = _DTYPES[info["dtype"]]
            shape = tuple(int(d) for d in info["shape"])
            begin, end = (int(o) for o in info["data_offsets"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: bad header entry for {name!r}: {info!r}") from e
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= len(buf) or end - begin != count * dt.itemsize:
            raise ValueError(
                f"{path}: tensor {name!r} offsets {begin}:{end} do not hold "
                f"{shape} {info['dtype']} inside a {len(buf)}-byte buffer"
            )
        out[name] = np.frombuffer(buf[begin:end], dtype=dt).reshape(shape).copy()
    return out


def save_file(
    tensors: Dict[str, np.ndarray], path: str, metadata: Optional[Dict[str, str]] = None
) -> None:
    """Write numpy arrays as a safetensors file (C-order, little-endian;
    non-contiguous views are copied into C order first)."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    chunks, offset = [], 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name], order="C")
        dt = arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype
        if dt not in _CODES:
            raise ValueError(f"safetensors has no dtype for {name!r}: {arr.dtype}")
        data = arr.astype(dt, copy=False).tobytes()
        header[name] = {
            "dtype": _CODES[dt],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(data)],
        }
        chunks.append(data)
        offset += len(data)
    hb = json.dumps(header, separators=(",", ":")).encode()
    hb += b" " * (-len(hb) % 8)  # the data buffer starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for data in chunks:
            f.write(data)


def _tower_from_flat(flat: Dict[str, np.ndarray], prefix: str) -> RevDecoderParams:
    def get(name):
        key = f"{prefix}.{name}"
        if key not in flat:
            raise KeyError(f"Checkpoint missing tensor {key!r}; has {sorted(flat)[:6]}...")
        return flat[key]

    dw = get("decoupling.weight")  # (2E, F, 1, 1) OIHW
    fw = get("conv_out_fg.weight")  # (1, E, 1, 1)
    bw = get("conv_out_bg.weight")
    return RevDecoderParams(
        decoupling_w=jnp.asarray(dw[:, :, 0, 0].T),  # -> (F, 2E)
        decoupling_b=jnp.asarray(get("decoupling.bias")),
        learnable_embedding=jnp.asarray(get("learnable_embedding")),
        conv_out_fg_w=jnp.asarray(fw[:, :, 0, 0].T),  # -> (E, 1)
        conv_out_fg_b=jnp.asarray(get("conv_out_fg.bias")),
        conv_out_bg_w=jnp.asarray(bw[:, :, 0, 0].T),
        conv_out_bg_b=jnp.asarray(get("conv_out_bg.bias")),
    )


def _tower_to_flat(params: RevDecoderParams, prefix: str) -> Dict[str, np.ndarray]:
    def np32(x):
        return np.ascontiguousarray(np.asarray(x, dtype=np.float32))

    def conv_oihw(w):
        return np32(np.asarray(w, dtype=np.float32).T[:, :, None, None])

    return {
        f"{prefix}.decoupling.weight": conv_oihw(params.decoupling_w),
        f"{prefix}.decoupling.bias": np32(params.decoupling_b),
        f"{prefix}.learnable_embedding": np32(params.learnable_embedding),
        f"{prefix}.conv_out_fg.weight": conv_oihw(params.conv_out_fg_w),
        f"{prefix}.conv_out_fg.bias": np32(params.conv_out_fg_b),
        f"{prefix}.conv_out_bg.weight": conv_oihw(params.conv_out_bg_w),
        f"{prefix}.conv_out_bg.bias": np32(params.conv_out_bg_b),
    }


def load_decoder_checkpoint(path: str) -> Tuple[RevDecoderParams, RevDecoderParams]:
    """Load a reference-format checkpoint -> (student, ema_teacher) params."""
    flat = load_file(path)
    return _tower_from_flat(flat, "decoder"), _tower_from_flat(flat, "decoder_ema")


def save_file_atomic(flat, path: str) -> None:
    """:func:`save_file` via temp + os.replace.

    Auto-resume picks the NEWEST epoch*.safetensors by mtime with no
    fallback, so a crash/OOM-kill mid-write must never leave a truncated
    file at the final path — with the rename, the newest file is always a
    complete one."""
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        save_file(flat, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_decoder_checkpoint(
    path: str, decoder: RevDecoderParams, decoder_ema: RevDecoderParams
) -> None:
    """Save params in the reference's safetensors layout."""
    flat = {**_tower_to_flat(decoder, "decoder"), **_tower_to_flat(decoder_ema, "decoder_ema")}
    save_file_atomic(flat, path)
