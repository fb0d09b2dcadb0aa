"""Where the program runs, in which precision it computes, and which
attention implementation it uses there.

Every platform-dependent decision of the framework lives here:

* ``platform()`` — JAX's default backend: ``"gpu"`` (an NVIDIA card) or
  ``"cpu"`` (tests and rehearsals).
* ``default_compute_dtype()`` — bfloat16 on the GPU, float32 on the CPU.
  ``tpu_cfg.compute_dtype`` in a config overrides it
  (``resolve_compute_dtype``); the key keeps its historical name because
  user configs set it.
* ``attention_implementation()`` — cuDNN's fused flash attention for half
  precision on the GPU, XLA's attention otherwise.  A shape cuDNN cannot
  take raises: the program never switches implementation behind the
  caller's back.
* ``enable_compilation_cache()`` — the persistent XLA compile cache.
* ``card_name_and_power_limit()`` — what every timing is reported beside.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp

# fixed, checkout-local cache path (listed in .gitignore): the path is part of
# the cache key, so a directory that moves between runs never hits
COMPILATION_CACHE_DIR = str(Path(__file__).resolve().parent.parent / ".jax_cache")


def platform() -> str:
    """JAX's default backend: ``"gpu"`` or ``"cpu"``."""
    return jax.default_backend()


def default_compute_dtype():
    """bfloat16 on the GPU (tensor cores); float32 on the CPU (exact parity
    with the float32 reference in tests)."""
    return jnp.bfloat16 if platform() == "gpu" else jnp.float32


def resolve_compute_dtype(cfg):
    """``cfg.tpu_cfg.compute_dtype`` when the config sets it, else the
    platform default.  The dtype is part of every jit cache key, so all
    construction sites resolve it through here."""
    name = (cfg.get("tpu_cfg", None) or {}).get("compute_dtype")
    if not name:
        return default_compute_dtype()
    return jnp.dtype(name).type


def attention_implementation(dtype, head_dim: int) -> str:
    """``"cudnn"`` for bf16/f16 attention on the GPU, ``"xla"`` for float32
    (cuDNN has no float32 flash kernel; float32 is the reference precision)
    and on the CPU.  Raises for a half-precision head width that cuDNN's
    flash kernel refuses (a multiple of 8, at most 256 on Hopper)."""
    if platform() != "gpu" or jnp.dtype(dtype) == jnp.float32:
        return "xla"
    if jnp.dtype(dtype) not in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16)):
        raise ValueError(f"no GPU attention for dtype {jnp.dtype(dtype)}")
    if head_dim % 8 or head_dim > 256:
        raise ValueError(
            f"cuDNN flash attention needs a head width that is a multiple of 8 "
            f"and at most 256, got {head_dim}"
        )
    return "cudnn"


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of each NVIDIA card, as nvidia-smi reports them
    (a card below its 700 W maximum runs slower under load, so every timing
    is reported beside this line)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return r.stdout.strip() or r.stderr.strip()


def enable_compilation_cache() -> None:
    """Persistent XLA compile cache.  Where ``JAX_COMPILATION_CACHE_DIR`` is
    set, JAX reads it itself and nothing is set here; otherwise the cache
    lives at :data:`COMPILATION_CACHE_DIR` inside the checkout."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", COMPILATION_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
