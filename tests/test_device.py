"""The one module that decides platform, precision and the compile cache
(``ucod_dpl_tpu/device.py``), and the construction sites that must honour
it."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from ucod_dpl_tpu import device
from ucod_dpl_tpu.config import CfgNode
from ucod_dpl_tpu.data.feature_extractor import FeatureExtractor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_FE = {
    "type": "dinov2",
    "backbone": "facebook/dinov2-base",
    "backbone_weights": "/nonexistent",
    "arch": {"hidden_size": 32, "num_layers": 1, "num_heads": 2, "patch_size": 14, "image_size": 28},
}


@pytest.mark.parametrize(
    "platform,cfg_dtype,want",
    [
        ("cpu", None, jnp.float32),
        ("gpu", None, jnp.bfloat16),
        ("gpu", "float32", jnp.float32),
        ("cpu", "bfloat16", jnp.bfloat16),
    ],
)
def test_compute_dtype_table(platform, cfg_dtype, want, monkeypatch):
    monkeypatch.setattr(device, "platform", lambda: platform)
    cfg = CfgNode({"tpu_cfg": {"compute_dtype": cfg_dtype}} if cfg_dtype else {})
    assert device.resolve_compute_dtype(cfg) == want
    assert device.default_compute_dtype() == (jnp.bfloat16 if platform == "gpu" else jnp.float32)


class _Recorder:
    """Stands in for FeatureExtractor at a construction site: records the
    dtype the site asked for, then stops the site."""

    def __init__(self):
        self.dtypes = []

    def __call__(self, fe_cfg, compute_dtype=None, **kw):
        real = FeatureExtractor(CfgNode(dict(TINY_FE)), compute_dtype=compute_dtype)
        self.dtypes.append(real.compute_dtype)
        raise _Stop


class _Stop(Exception):
    pass


@pytest.mark.parametrize(
    "site", ["predictor", "refine_predictor", "dataset_cache_build", "pseudo_label_cli"]
)
def test_construction_sites_honour_compute_dtype(site, monkeypatch, tmp_path):
    """Serving honours ``tpu_cfg.compute_dtype``; sites without a config
    (the lazy dataset extractor, the pseudo-label CLI) take the platform
    default — bf16 on the GPU, never a silent f32."""
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    rec = _Recorder()
    if site in ("predictor", "refine_predictor"):
        import ucod_dpl_tpu.config as config_mod
        from ucod_dpl_tpu import serving

        cfg = config_mod.load_config(os.path.join(REPO, "configs/uscod/UCOD-DPL_dinov2.py"))
        cfg.tpu_cfg.compute_dtype = "float16"  # neither platform's default
        monkeypatch.setattr(config_mod, "load_config", lambda *a, **k: cfg)
        monkeypatch.setattr(serving, "FeatureExtractor", rec)
        with pytest.raises(_Stop):
            if site == "predictor":
                serving.Predictor.from_config("cfg.py", "ckpt.safetensors")
            else:
                serving.RefinePredictor.from_config("cfg.py", "ckpt.safetensors", "ref.safetensors")
        assert rec.dtypes == [jnp.float16]
        return
    if site == "dataset_cache_build":
        from ucod_dpl_tpu.data import dataset

        monkeypatch.setattr(dataset, "FeatureExtractor", rec)
        ds = dataset.CODDataset.__new__(dataset.CODDataset)
        ds._feature_extractor, ds.feature_extractor_cfg = None, CfgNode(dict(TINY_FE))
        with pytest.raises(_Stop):
            ds.feature_extractor
    else:
        from ucod_dpl_tpu import cli
        from ucod_dpl_tpu.data import feature_extractor

        monkeypatch.setattr(feature_extractor, "FeatureExtractor", rec)
        with pytest.raises(_Stop):
            cli.generate_pseudo_label_main(["--image_path", str(tmp_path / "{}")])
    assert rec.dtypes == [jnp.bfloat16]


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compilation_cache_location(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: nothing is set in code; unset: the
    fixed checkout-local directory."""
    updates = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    device.enable_compilation_cache()
    if env_set:
        assert updates == {}
    else:
        assert updates["jax_compilation_cache_dir"] == device.COMPILATION_CACHE_DIR
        assert device.COMPILATION_CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_compilation_cache_written_where_env_says(tmp_path):
    """End to end in a fresh process: with JAX_COMPILATION_CACHE_DIR set,
    compiled programs land there."""
    cache = tmp_path / "cache"
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import jax, jax.numpy as jnp\n"
        "from ucod_dpl_tpu.device import enable_compilation_cache\n"
        "enable_compilation_cache()\n"
        "assert jax.config.jax_compilation_cache_dir == %r, jax.config.jax_compilation_cache_dir\n"
        "jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((64, 64))).block_until_ready()\n"
    ) % (REPO, str(cache))
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(cache),
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
    )
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert any(cache.iterdir())
