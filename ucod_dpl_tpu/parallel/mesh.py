"""Device mesh construction and sharding helpers.

The reference's only parallelism is NCCL data-parallel via HuggingFace
Accelerate (SURVEY §2.4/§5.8).  Here the substrate is a
``jax.sharding.Mesh`` with a ``data`` axis (DP; GSPMD inserts the
collectives, which XLA runs over NCCL on NVIDIA cards) plus optional
``model`` (tensor-parallel) and ``seq`` (sequence-parallel) axes for the
ViT backbone.  The default ``{data: -1}`` spreads the batch over every
visible card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def build_mesh(mesh_cfg: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """Create a mesh from {axis: size} with -1 meaning 'all remaining'."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    cfg = dict(mesh_cfg or {"data": -1, "model": 1})
    fixed = int(np.prod([v for v in cfg.values() if v != -1])) or 1
    if n % fixed:
        raise ValueError(
            f"mesh axes {cfg} do not divide the device count {n}; a silent "
            f"partial mesh would strand {n - (n // fixed) * fixed} device(s) — "
            "fix the axis sizes (use -1 for 'all remaining')."
        )
    sizes = {k: (n // fixed if v == -1 else v) for k, v in cfg.items()}
    total = int(np.prod(list(sizes.values())))
    if total != n:
        raise ValueError(
            f"mesh {sizes} covers {total} of {n} devices; refusing to "
            "silently drop devices — fix the axis sizes (use -1 for 'all "
            "remaining')."
        )
    dev_array = np.asarray(devices[:total]).reshape(tuple(sizes.values()))
    return Mesh(dev_array, tuple(sizes.keys()))


def data_sharding(mesh: Mesh, ndim: int, batch_size: Optional[int] = None) -> NamedSharding:
    """Shard the leading (batch) dim over the 'data' axis.

    When ``batch_size`` is given and does not divide the data-axis size, the
    array is replicated instead (keeps small/ragged batches working on wide
    meshes — e.g. bs=1 eval on an 8-device mesh).  Scalars (ndim == 0 —
    step counters, loss weights) have no batch dim and are replicated."""
    if ndim == 0 or (
        batch_size is not None and batch_size % mesh.shape.get("data", 1) != 0
    ):
        return NamedSharding(mesh, P())
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch: Any, mesh: Mesh):
    """Device-put a pytree of numpy batch arrays, batch-dim sharded."""
    return jax.tree.map(
        lambda x: jax.device_put(
            x, data_sharding(mesh, np.ndim(x), batch_size=np.shape(x)[0] if np.ndim(x) else None)
        ),
        batch,
    )
