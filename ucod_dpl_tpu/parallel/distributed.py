"""Multi-host (multi-process) SPMD support.

JAX replacement for the reference's NCCL/Accelerate substrate (SURVEY
§5.8): ``jax.distributed.initialize`` bootstraps the process group (the
coordinator address, process count and id come from the environment, see
``maybe_initialize_distributed``); XLA hands GSPMD's collectives to NCCL
on NVIDIA cards.  Per-process dataset sharding replaces DistributedSampler;
metric gathering replaces ``accelerator.gather_for_metrics``.
"""

from __future__ import annotations

import os
from typing import Any, List

import jax
import numpy as np


_dist_initialized = False


def maybe_initialize_distributed() -> None:
    """Initialize jax.distributed when launched multi-process.

    Triggered by UCOD_DIST=1 or explicit coordinator env vars; a no-op in
    single-process runs (the common dev path).

    ORDER MATTERS: the trigger check must not touch jax — even
    ``jax.process_count()`` initialises the XLA backend, after which
    ``jax.distributed.initialize`` refuses to run ("must be called before
    any JAX calls").  So the env-var gate comes first and a module flag
    (plus the coordinator-client probe for callers that initialised jax
    themselves) stands in for the old backend-touching "already
    initialised" check.
    """
    global _dist_initialized
    if _dist_initialized:
        return
    if not (os.environ.get("UCOD_DIST") or os.environ.get("JAX_COORDINATOR_ADDRESS")):
        return  # single-process: never touches the backend
    try:
        from jax._src import distributed as _jax_dist

        if getattr(_jax_dist.global_state, "client", None) is not None:
            _dist_initialized = True  # caller ran jax.distributed.initialize
            return
    except Exception:
        pass  # private-API drift: fall through and let initialize() decide
    kwargs = {}
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs = dict(
            coordinator_address=addr,
            num_processes=int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
        )
    jax.distributed.initialize(**kwargs)
    _dist_initialized = True


def process_shard() -> tuple:
    """(index, count) slice of the dataset this process reads."""
    return jax.process_index(), jax.process_count()


def is_main_process() -> bool:
    return jax.process_index() == 0


def gather_object_lists(local: List[Any]) -> List[Any]:
    """Gather per-process python lists of numpy arrays to every process
    (counterpart of accelerator.gather_for_metrics for streaming metrics).

    Single-process: identity.  Multi-process: delegates to
    :func:`gather_ragged` — the collective SEQUENCE must be identical on
    every rank, and a rank with an EMPTY local list (dataset shard smaller
    than the process count) cannot run a naive np.stack+allgather
    (np.stack([]) raises, deadlocking the other ranks mid-collective); the
    ragged protocol exchanges counts/shapes first and tolerates empties on
    any subset of ranks.  Payloads travel as float64 (the metric-gathering
    contract this function exists for).
    """
    if jax.process_count() == 1:
        return local
    return gather_ragged(local)


def gather_ragged(local: List[Any]) -> List[Any]:
    """Gather ragged-count (equal-shape) array lists from all processes.

    Processes may hold differing numbers of items (dataset shards differ by
    up to one); counts are exchanged first, payloads padded to the max and
    trimmed after the allgather."""
    if jax.process_count() == 1:
        return local
    from jax.experimental import multihost_utils

    arrays = [np.asarray(x, dtype=np.float64) for x in local]
    shape = arrays[0].shape if arrays else ()
    # counts AND per-item shape exchanged up front: a zero-item process
    # (dataset smaller than the process count) has no local shape, and an
    # allgather with mismatched payload shapes would fail — every process
    # must agree on the padded payload geometry before building it
    ndim = np.zeros((8,), np.int32)
    ndim[0] = len(arrays)
    ndim[1] = len(shape)
    ndim[2 : 2 + len(shape)] = shape
    meta = np.asarray(multihost_utils.process_allgather(ndim)).reshape(-1, 8)
    counts = meta[:, 0]
    have = meta[meta[:, 0] > 0]
    if have.size == 0:
        return []
    rank = int(have[0, 1])
    shape = tuple(int(s) for s in have[0, 2 : 2 + rank])
    maxc = int(counts.max())
    payload = np.zeros((maxc,) + shape, np.float64)
    if arrays:
        payload[: len(arrays)] = np.stack(arrays)
    gathered = np.asarray(multihost_utils.process_allgather(payload))
    out: List[Any] = []
    for p in range(gathered.shape[0]):
        out.extend(gathered[p, : counts[p]])
    return out


def barrier(name: str = "barrier") -> None:
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
