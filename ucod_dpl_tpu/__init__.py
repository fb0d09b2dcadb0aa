"""UCOD-DPL in JAX — a framework for unsupervised camouflaged object
detection via dynamic pseudo-label learning (UCOD-DPL, CVPR 2025) and
adaptive pseudo-label learning with dynamic local refinement (CORAL).

A ground-up rebuild of the capabilities of the PyTorch reference
implementation (Heartfirey/UCOD-DPL) for NVIDIA GPUs: pure jitted step
functions over explicit state pytrees, cuDNN flash attention on the
backbone's hot path, GSPMD sharding over device meshes, and host-side NumPy
only where the algorithm is inherently sequential (connected components,
streaming metrics).
"""

__version__ = "0.4.0"


def __getattr__(name):
    # lazy top-level API (keeps bare `import ucod_dpl_tpu` dependency-free)
    if name == "Predictor":
        from ucod_dpl_tpu.serving import Predictor

        return Predictor
    if name == "Runner":
        from ucod_dpl_tpu.engine import Runner

        return Runner
    if name == "load_config":
        from ucod_dpl_tpu.config import load_config

        return load_config
    raise AttributeError(name)
