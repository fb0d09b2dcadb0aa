"""Time the candidate implementations of each hot-path kernel on the GPU.

Decides, by measurement at the real ViT-B/14 shapes, which attention and
which q/k/v projection layout the backbone uses (PERF.md, "Kernel decisions
on H100"):

* attention forward, standalone, at bs16 x L=1370 (518px), bs4 x 2917
  (756px) and bs4 x 5477 (1036px), 12 heads of 64, bf16:
  - ``xla``: the plain XLA attention (f32 scores in device memory);
  - ``cudnn``: ``jax.nn.dot_product_attention(implementation="cudnn")`` on
    the (B, L, 12, 64) view, unpadded;
  - ``cudnn_pad``: the same, padded to a multiple of 128 with
    ``key_value_seq_lengths`` masking the padding;
  - ``triton``: JAX's library Pallas/Triton flash kernel
    (``jax.experimental.pallas.ops.gpu.attention.mha``), padded to a
    multiple of 128, padding masked with segment ids;
  - ``mgpu``: JAX's library Mosaic GPU kernel
    (``jax.experimental.pallas.ops.gpu.attention_mgpu.attention``), padded
    and UNMASKED (it takes no mask): a speed reference only;
* attention forward + backward at bs16 x 1370;
* the full bf16 ``dino_forward`` at bs16@518px with each attention, and
  with the three q/k/v GEMMs against one concatenated 768x2304 GEMM;
* the LoRA-shaped backward (grad of the forward w.r.t. the q/k/v weights)
  at bs16@518px with each attention.

Usage (on a machine with the GPU):

    python scripts/kernel_ab.py [--out chiprun_out/kernel_ab.json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timeit(fns: dict, args_of: dict, rounds: int = 3, reps: int = 10) -> dict:
    """Interleaved timing: every candidate is compiled and warmed first, then
    each round times every candidate in turn.  Returns ms quantiles."""
    import jax

    for name, f in fns.items():
        jax.block_until_ready(f(*args_of[name]))
    samples = {name: [] for name in fns}
    for r in range(rounds):
        order = list(fns) if r % 2 == 0 else list(reversed(list(fns)))
        for name in order:
            f, a = fns[name], args_of[name]
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(f(*a))
                samples[name].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for name, s in samples.items():
        q = statistics.quantiles(s, n=4)
        out[name] = {"median_ms": statistics.median(s), "q1_ms": q[0], "q3_ms": q[2]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        print("kernel_ab.py needs a GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print("card:", card, "| jax", jax.__version__, jax.devices())
    result = {"card": card, "device_kind": jax.devices()[0].device_kind}

    from jax.experimental.pallas.ops.gpu import attention as tri
    from jax.experimental.pallas.ops.gpu import attention_mgpu as mg

    from ucod_dpl_tpu.ops.attention import _xla_attention

    nh, hd = 12, 64
    scale = 1.0 / np.sqrt(hd)

    def pad_to(x, lp):
        return jnp.pad(x, [(0, 0), (0, lp - x.shape[1]), (0, 0), (0, 0)])

    def xla_attn(q, k, v):  # (B, L, D) packed, as the backbone calls it
        b, l, d = q.shape
        sp = lambda x: x.reshape(b, l, nh, hd).transpose(0, 2, 1, 3).reshape(b * nh, l, hd)
        o = _xla_attention(sp(q), sp(k), sp(v), scale)
        return o.reshape(b, nh, l, hd).transpose(0, 2, 1, 3).reshape(b, l, d)

    def cudnn_attn(q, k, v):
        b, l, d = q.shape
        v4 = lambda x: x.reshape(b, l, nh, hd)
        o = jax.nn.dot_product_attention(
            v4(q), v4(k), v4(v), scale=scale, implementation="cudnn"
        )
        return o.reshape(b, l, d)

    def cudnn_pad_attn(q, k, v):
        b, l, d = q.shape
        lp = -(-l // 128) * 128
        v4 = lambda x: pad_to(x.reshape(b, l, nh, hd), lp)
        o = jax.nn.dot_product_attention(
            v4(q), v4(k), v4(v), scale=scale, implementation="cudnn",
            key_value_seq_lengths=jnp.full((b,), l, jnp.int32),
        )
        return o[:, :l].reshape(b, l, d)

    def triton_attn(q, k, v):
        b, l, d = q.shape
        lp = -(-l // 128) * 128
        v4 = lambda x: pad_to(x.reshape(b, l, nh, hd), lp)
        seg = jnp.broadcast_to((jnp.arange(lp) < l).astype(jnp.int32), (b, lp))
        o = tri.mha(v4(q), v4(k), v4(v), seg, sm_scale=float(scale))
        return o[:, :l].reshape(b, l, d)

    mg_cfg = mg.TuningConfig(block_q=64, block_kv=128, max_concurrent_steps=2)

    def mgpu_attn(q, k, v):  # unmasked padding: speed reference only
        b, l, d = q.shape
        lp = -(-l // 128) * 128
        v4 = lambda x: pad_to(x.reshape(b, l, nh, hd), lp)
        o = mg.attention(v4(q), v4(k), v4(v), mg_cfg)
        return o[:, :l].reshape(b, l, d)

    cands = {
        "xla": xla_attn, "cudnn": cudnn_attn, "cudnn_pad": cudnn_pad_attn,
        "triton": triton_attn, "mgpu": mgpu_attn,
    }

    # ---- 1. standalone forward ------------------------------------------
    rng = np.random.default_rng(0)
    fwd = {}
    for b, l in ((16, 1370), (4, 2917), (4, 5477)):
        q, k, v = (
            jnp.asarray(rng.standard_normal((b, l, nh * hd)), jnp.bfloat16)
            for _ in range(3)
        )
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(
                jax.jit(xla_attn)(*(x.astype(jnp.float32) for x in (q, k, v)))
            )
        fns, args_of, errs = {}, {}, {}
        for name, f in cands.items():
            jf = jax.jit(f)
            try:
                o = np.asarray(jf(q, k, v)).astype(np.float32)
            except Exception as e:  # noqa: BLE001 — a refused candidate is a finding
                errs[name] = f"{type(e).__name__}: {str(e)[:300]}"
                continue
            errs[name] = float(np.linalg.norm(o - ref) / np.linalg.norm(ref))
            fns[name], args_of[name] = jf, (q, k, v)
        t = _timeit(fns, args_of)
        fwd[f"bs{b}xL{l}"] = {"time": t, "norm_rel_err": errs}
        print(f"attention fwd bs{b} L={l}:", json.dumps({n: round(x["median_ms"], 4) for n, x in t.items()}), errs)
    result["attention_fwd"] = fwd

    # ---- 2. forward + backward at 518px ---------------------------------
    b, l = 16, 1370
    q, k, v = (
        jnp.asarray(rng.standard_normal((b, l, nh * hd)), jnp.bfloat16) for _ in range(3)
    )
    fns, args_of = {}, {}
    for name in ("xla", "cudnn", "cudnn_pad", "triton"):
        f = cands[name]
        g = jax.jit(jax.grad(lambda q, k, v, f=f: jnp.sum(f(q, k, v).astype(jnp.float32) ** 2), argnums=(0, 1, 2)))
        try:
            jax.block_until_ready(g(q, k, v))
        except Exception as e:  # noqa: BLE001
            print("bwd", name, "refused:", type(e).__name__, str(e)[:300])
            continue
        fns[name], args_of[name] = g, (q, k, v)
    t = _timeit(fns, args_of)
    result["attention_fwd_bwd_bs16xL1370"] = t
    print("attention fwd+bwd bs16 L=1370:", json.dumps({n: round(x["median_ms"], 4) for n, x in t.items()}))

    # ---- 3. full forward at bs16@518px ------------------------------------
    import ucod_dpl_tpu.models.dino as dino_mod
    from ucod_dpl_tpu.models.dino import DinoConfig, _dense, init_dino

    cfg = DinoConfig.dinov2_base()
    params = init_dino(jax.random.PRNGKey(0), cfg)
    pixels = jnp.asarray(rng.standard_normal((16, 518, 518, 3)), jnp.float32)

    qkv_concat = dino_mod._qkv_concat

    def qkv_three(h, layer, dtype):
        return tuple(_dense(h, layer[t], dtype) for t in ("q", "k", "v"))

    def make_fwd(attn, qkv):
        def f(p, px):
            dino_mod.multi_head_attention = lambda q, k, v, n, scale: attn(q, k, v)
            dino_mod._qkv_concat = qkv
            return dino_mod.dino_forward(p, px, cfg, compute_dtype=jnp.bfloat16)["key_features"]
        return jax.jit(f)

    variants = {
        "xla+3gemm": (xla_attn, qkv_three),
        "cudnn+3gemm": (cudnn_attn, qkv_three),
        "cudnn_pad+3gemm": (cudnn_pad_attn, qkv_three),
        "triton+3gemm": (triton_attn, qkv_three),
        "cudnn+concat": (cudnn_attn, qkv_concat),
    }
    fns, args_of = {}, {}
    for name, (a, qk) in variants.items():
        f = make_fwd(a, qk)
        try:
            jax.block_until_ready(f(params, pixels))  # traces with this variant's patch
        except Exception as e:  # noqa: BLE001
            print("forward", name, "refused:", type(e).__name__, str(e)[:300])
            continue
        fns[name], args_of[name] = f, (params, pixels)
    t = _timeit(fns, args_of, rounds=4, reps=5)
    result["dino_forward_bs16_518"] = t
    print("dino_forward bs16@518:", json.dumps({n: round(x["median_ms"], 3) for n, x in t.items()}))

    # ---- 4. LoRA-shaped backward at bs16@518px ----------------------------
    def make_grad(attn):
        def loss(qkv_w, p, px):
            dino_mod.multi_head_attention = lambda q, k, v, n, scale: attn(q, k, v)
            dino_mod._qkv_concat = qkv_three
            layers = [
                {**lay, "q": {**lay["q"], "w": w[0]}, "k": {**lay["k"], "w": w[1]},
                 "v": {**lay["v"], "w": w[2]}}
                for lay, w in zip(p["layers"], qkv_w)
            ]
            out = dino_mod.dino_forward(
                {**p, "layers": layers}, px, cfg, compute_dtype=jnp.bfloat16
            )["key_features"]
            return jnp.mean(out.astype(jnp.float32) ** 2)
        return jax.jit(jax.grad(loss))

    qkv_w = [(lay["q"]["w"], lay["k"]["w"], lay["v"]["w"]) for lay in params["layers"]]
    fns, args_of = {}, {}
    for name in ("xla", "cudnn", "cudnn_pad"):
        g = make_grad(cands[name])
        try:
            jax.block_until_ready(g(qkv_w, params, pixels))
        except Exception as e:  # noqa: BLE001
            print("grad", name, "refused:", type(e).__name__, str(e)[:300])
            continue
        fns[name], args_of[name] = g, (qkv_w, params, pixels)
    t = _timeit(fns, args_of, rounds=2, reps=5)
    result["qkv_grad_bs16_518"] = t
    print("qkv-weight grad bs16@518:", json.dumps({n: round(x["median_ms"], 3) for n, x in t.items()}))
    result["peak_bytes_in_use"] = jax.devices()[0].memory_stats().get("peak_bytes_in_use")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
