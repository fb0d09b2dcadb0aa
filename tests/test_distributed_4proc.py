"""Four-process jax.distributed fidelity.

Four CPU processes x 2 virtual devices = an 8-device global mesh, covering
in ONE multi-process program the three things real pods exercise:

  1. sharded stage-1 training steps (GSPMD grad psum across processes);
  2. the ragged eval metric allgather (``parallel/distributed.py::
     gather_ragged``) with per-process counts differing — including a
     ZERO-item process (a dataset smaller than the process count);
  3. an orbax sharded save -> restore -> continue cycle, asserted LOSSLESS:
     the restored-then-stepped state is bitwise equal to the uninterrupted
     in-memory continuation.

Processes must end bitwise-identical (one SPMD program), which is exactly
the property the reference's post-prepare ``.module`` unwrap broke.
"""

import pytest

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np

pytestmark = pytest.mark.heavy  # multi-process / e2e: excluded from the quick loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    '''
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
    )
    import jax
    jax.config.update("jax_platforms", "cpu")
    port, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    NPROC = 4
    jax.distributed.initialize(
        coordinator_address="127.0.0.1:" + port, num_processes=NPROC, process_id=pid
    )
    sys.path.insert(0, "__REPO__")

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ucod_dpl_tpu.config import CfgNode
    from ucod_dpl_tpu.engine.checkpoint import load_train_state, save_train_state
    from ucod_dpl_tpu.engine.train_step import (
        TrainState, make_optimizer, make_train_step,
    )
    from ucod_dpl_tpu.models.dba import init_rev_decoder
    from ucod_dpl_tpu.models.discriminator import init_discriminator
    from ucod_dpl_tpu.parallel import build_mesh
    from ucod_dpl_tpu.parallel.distributed import barrier, gather_ragged

    assert jax.process_count() == NPROC and len(jax.devices()) == 8

    cfg = CfgNode({
        "model_cfg": {"dim": 32, "feature_size": 8, "ema_weight": 0.99,
                      "dis_use_features": False},
        "train_cfg": {"merge_method": "dis", "max_epoch": 25,
                      "start_finetune": -5},
    })
    mesh = build_mesh({"data": -1, "model": 1})

    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    dec = init_rev_decoder(k1, 32)
    dec_ema = init_rev_decoder(k2, 32)
    dis_params, dis_stats = init_discriminator(
        jax.random.PRNGKey(1), feature_size=8, feature_dim=32, use_features=False,
    )
    opt = make_optimizer(2e-4, 0.95, 25)
    dis_opt = make_optimizer(1e-3, 0.95, 25)
    state = TrainState(
        decoder=dec, decoder_ema=dec_ema, opt_state=opt.init(dec),
        dis_params=dis_params, dis_stats=dis_stats,
        dis_opt_state=dis_opt.init(dis_params), ema_step=jnp.int32(0),
    )
    step = jax.jit(make_train_step(cfg, opt))
    state = jax.device_put(state, NamedSharding(mesh, P()))

    rng = np.random.default_rng(42)
    def batch():
        feats_g = rng.standard_normal((8, 6, 6, 32)).astype(np.float32)
        pl_g = (rng.random((8, 10, 10, 1)) > 0.5).astype(np.float32)
        def put(g):
            sh = NamedSharding(mesh, P("data", None, None, None))
            per = g.shape[0] // NPROC
            return jax.make_array_from_process_local_data(
                sh, g[pid * per : (pid + 1) * per], g.shape
            )
        return put(feats_g), put(pl_g)

    # --- 1) two sharded train steps ---------------------------------------
    for _ in range(2):
        f, p = batch()
        state, aux = step(state, f, p, jnp.float32(0.0), jnp.float32(1.0))
    assert np.isfinite(float(aux["loss"]))

    # --- 3a) orbax sharded save (every process writes its shards) ---------
    ckpt = os.path.join(outdir, "state4")
    save_train_state(ckpt, state, {"epoch": 2}, backend="orbax")
    barrier("after-save")
    assert os.path.isdir(ckpt + ".orbax")

    # --- 3b) restore into the sharded template and CONTINUE --------------
    restored, meta = load_train_state(ckpt, state)
    assert meta["epoch"] == 2
    f, p = batch()
    cont_mem, _ = step(state, f, p, jnp.float32(1.0), jnp.float32(1.0))
    cont_restored, _ = step(restored, f, p, jnp.float32(1.0), jnp.float32(1.0))
    flat_mem = np.concatenate([
        np.asarray(jax.device_get(x)).ravel() for x in cont_mem.decoder
    ])
    flat_res = np.concatenate([
        np.asarray(jax.device_get(x)).ravel() for x in cont_restored.decoder
    ])
    # the save->restore->step cycle must be LOSSLESS
    np.testing.assert_array_equal(flat_mem, flat_res)

    # --- 2) ragged metric gather: counts 2,1,0,3 per process -------------
    counts = [2, 1, 0, 3]
    local = [np.full((2,), 10.0 * pid + i) for i in range(counts[pid])]
    gathered = gather_ragged(local)
    expect = [
        np.full((2,), 10.0 * q + i) for q in range(NPROC) for i in range(counts[q])
    ]
    assert len(gathered) == len(expect) == 6
    for a, b in zip(gathered, expect):
        np.testing.assert_array_equal(np.asarray(a), b)

    np.save(os.path.join(outdir, f"params4_{pid}.npy"), flat_res)
    print("DONE", pid, float(np.abs(flat_res).sum()))
    '''
).replace("__REPO__", REPO)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_four_process_train_gather_orbax_resume(tmp_path):
    worker = tmp_path / "worker4.py"
    worker.write_text(_WORKER)
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), port, str(pid), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for pid in range(4)
    ]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:  # never leak hung workers into the session
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]

    flats = [np.load(tmp_path / f"params4_{pid}.npy") for pid in range(4)]
    # all four processes hold the same model, bitwise (grad psum held)
    for pid in range(1, 4):
        np.testing.assert_array_equal(flats[0], flats[pid])
    assert np.abs(flats[0]).sum() > 0
