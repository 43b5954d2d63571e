#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases (each one raises, and the script exits non-zero, if it fails):

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, all started together);
2. each kernel against its plain PyTorch version on the card, in float32 and
   bfloat16, at the shapes the llama3-8b serving path gives it;
3. the reduced llama3-8b served on the card against the same weights served
   on the CPU (plain versions): identical greedy tokens, close logits;
4. llama3-8b at full width (32 layers, d_model 4096, vocab 128256) in bf16
   served through ``Server``, with the kernels' launch counts checked:
   193 DiP-matmul launches per forward, 32 flash launches per prefill chunk;
5. kernel times (CUDA events, L2 flushed between launches) beside their
   bound, the plain version's time and one library call's time.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  It imports nothing
of JAX or of the JAX package.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# NVIDIA H100 SXM data sheet, dense rates: the least time a launch could take
# is the larger of its bytes over the memory rate and its operations over the
# peak rate for its input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain: max|err| <= TOL * max(1, max|plain|).  float32: both sides
# multiply the same operands in IEEE f32 (no TF32) and differ only in the
# order of the sums; bfloat16: both accumulate the same bf16 operands in f32,
# so after the final cast they differ by about one bf16 step (2^-8) at most
TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# reduced model, card against CPU, f32 logits: two layers of the above
MODEL_TOL = 1e-4


def log(msg):
    print(msg, flush=True)


def close(name, got, want, tol):
    """Check one comparison; returns max|err|."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    ok = err <= tol * scale
    log(f"  {name}: max|err| {err:.3e} (limit {tol:g} x {scale:.3g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.device import make_generator
    from repro_torch.kernels import _build
    from repro_torch.kernels import epilogue as epi
    from repro_torch.kernels import prologue as pro
    from repro_torch.kernels.dip_matmul import dip_matmul, dip_matmul_plain
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention
    from repro_torch.models import transformer as tf_model
    from repro_torch.runtime import Request, Server, ServerConfig
    import numpy as np
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)} ({gpu}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    # ------------------------------------------------------------ 1. build --
    log("phase 1: build")
    took = _build.build()
    log(f"  built {list(_build.SOURCES)} in {took:.1f} s")
    for name in _build.SOURCES:
        lines = _build.library_path(name).with_suffix(".log").read_text().splitlines()
        for line in lines:
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---------------------------------------------- 2. kernels vs plain -----
    log("phase 2: each kernel against its plain version on the card")
    g = torch.Generator(device=dev).manual_seed(SEED)
    d, d_ff, kv, vocab = 4096, 14336, 1024, 131072
    # (label, K, N, epilogue, prologue): every projection of the main path
    proj = [
        ("q", d, d, "none", "rmsnorm"),
        ("k/v", d, kv, "none", "rmsnorm"),
        ("o", d, d, "residual", "none"),
        ("gate+up", d, d_ff, "swiglu", "rmsnorm"),
        ("down", d_ff, d, "residual", "none"),
        ("lm_head", d, vocab, "none", "none"),
    ]
    extra = [("bias", d, d, "bias", "none"), ("bias_gelu", d, d, "bias_gelu", "none"),
             ("bias_silu", d, d, "bias_silu", "none")]

    def dip_inputs(m, k, n, epilogue, prologue, dtype):
        x = torch.randn(m, k, generator=g, device=dev).to(dtype)
        p = (torch.randn(k, n, generator=g, device=dev) * k ** -0.5).to(dtype)
        s = epi.spec(epilogue)
        if s.dual_weight:
            eops = ((torch.randn(k, n, generator=g, device=dev) * k ** -0.5).to(dtype),)
        elif s.bias:
            eops = (torch.randn(n, generator=g, device=dev),)
        elif s.residual:
            eops = (torch.randn(m, n, generator=g, device=dev).to(dtype),)
        else:
            eops = ()
        pops = (torch.rand(k, generator=g, device=dev) + 0.5,) if prologue == "rmsnorm" else ()
        return x, p, eops, dict(epilogue=epilogue, prologue=prologue, prologue_operands=pops)

    worst = {"dip_matmul": 0.0, "flash_attention": 0.0}
    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for m in (4, 256):
            for label, k, n, e, pr in proj + (extra if m == 256 else []):
                x, p, eops, kw = dip_inputs(m, k, n, e, pr, dtype)
                got = dip_matmul(x, p, *eops, **kw)
                want = dip_matmul_plain(x, p, *eops, **kw)
                err = close(f"dip {dt_name} M={m} {label} K={k} N={n} {e}/{pr}", got, want, TOL[dt_name])
                worst["dip_matmul"] = max(worst["dip_matmul"], err)
                del x, p, eops, got, want
        x, p, eops, kw = dip_inputs(256, d, d, "residual", "none", dtype)
        err = close(f"ws {dt_name} M=256 K={d} N={d} residual (fuse_deshear=False)",
                    dip_matmul(x, p, *eops, fuse_deshear=False, **kw),
                    dip_matmul_plain(x, p, *eops, fuse_deshear=False, **kw), TOL[dt_name])
        worst["dip_matmul"] = max(worst["dip_matmul"], err)
        # one ragged shape through the registry shim: the same call with the
        # same inputs on the CPU runs the plain version behind the same shim
        x = torch.randn(3, 37, 1000, generator=g, device=dev).to(dtype)
        w = api.DipWeight.from_natural((torch.randn(1000, 700, generator=g, device=dev)
                                        * 1000 ** -0.5).to(dtype))
        r = torch.randn(3, 37, 700, generator=g, device=dev).to(dtype)
        gain = torch.rand(1000, generator=g, device=dev) + 0.5
        err = close(f"registry dip {dt_name} ragged (3,37,1000)@(1000,700) residual/rmsnorm",
                    api.matmul(x, w, backend="dip", epilogue="residual", epilogue_operands=(r,),
                               prologue="rmsnorm", prologue_operands=(gain,)).cpu(),
                    api.matmul(x.cpu(), w.with_data(w.data.cpu()), backend="dip", epilogue="residual",
                               epilogue_operands=(r.cpu(),), prologue="rmsnorm",
                               prologue_operands=(gain.cpu(),)), TOL[dt_name])
        worst["dip_matmul"] = max(worst["dip_matmul"], err)

    bh, sq, sk, hd = 32, 256, 1024, 128
    flash_cases = [  # (label, D, Dv, q_offset, kv_len per row)
        ("q_offset 0", hd, hd, 0, torch.full((bh,), sk, dtype=torch.int32, device=dev)),
        ("q_offset 512", hd, hd, 512, torch.full((bh,), 768, dtype=torch.int32, device=dev)),
        ("kv_len 0 on every 4th row", hd, hd, 512,
         torch.tensor([0 if i % 4 == 0 else 700 - 5 * i for i in range(bh)], dtype=torch.int32, device=dev)),
        ("Dv != D (192/128)", 192, 128, 512, torch.full((bh,), 768, dtype=torch.int32, device=dev)),
    ]

    def flash_inputs(dk, dvv, dtype):
        return (torch.randn(bh, sq, dk, generator=g, device=dev).to(dtype),
                torch.randn(bh, sk, dk, generator=g, device=dev).to(dtype),
                torch.randn(bh, sk, dvv, generator=g, device=dev).to(dtype))

    for dt_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dt_name)
        for label, dk, dvv, qo, kvl in flash_cases:
            q, k, v = flash_inputs(dk, dvv, dtype)
            kw = dict(q_offset=torch.tensor(qo, device=dev), kv_len=kvl, causal=True)
            got = flash_attention(q, k, v, **kw)
            err = close(f"flash {dt_name} BH={bh} Sq={sq} Sk={sk} D={dk} Dv={dvv} {label}",
                        got, attention_plain(q, k, v, **kw), TOL[dt_name])
            worst["flash_attention"] = max(worst["flash_attention"], err)
            dead = kvl == 0
            if dead.any():
                if not bool((got[dead] == 0).all()):
                    raise AssertionError("flash: fully masked rows are not exactly 0")
                log(f"  flash {dt_name}: {int(dead.sum())} fully masked rows are exactly 0")
    torch.cuda.synchronize()

    # ---------------------------------------- 3. reduced model, card vs CPU --
    log("phase 3: reduced llama3-8b, f32, dip backend: card against CPU")
    rcfg = dataclasses.replace(get_config("llama3-8b").reduced(), matmul_backend="dip",
                               param_dtype="float32", compute_dtype="float32")
    cpu_params = tf_model.init_params(rcfg, make_generator(SEED, "cpu"), "cpu")

    def to_dev(t):
        if isinstance(t, dict):
            return {k: to_dev(v) for k, v in t.items()}
        if isinstance(t, api.DipWeight):
            return t.with_data(t.data.to(dev))
        return t.to(dev)

    def recorded(server):
        """Wrap the engine's two steps to keep their logits (on the CPU)."""
        eng, seen = server.engine, []
        for attr in ("_prefill_fwd", "_decode"):
            def wrap(*a, _f=getattr(eng, attr), _tag=attr):
                out = _f(*a)
                seen.append((_tag, out[0][..., :rcfg.vocab_size].float().cpu()))
                return out
            setattr(eng, attr, wrap)
        return seen

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(2, rcfg.vocab_size, size=n) for n in (11, 19)]
    scfg = ServerConfig(batch_slots=2, max_seq=64, max_new_tokens=4, temperature=0.0, prefill_chunk=16)
    outs, logits = {}, {}
    for where, params in (("cuda", to_dev(cpu_params)), ("cpu", cpu_params)):
        server = Server(rcfg, scfg, params, device=where)
        logits[where] = recorded(server)
        outs[where] = server.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    log(f"  greedy tokens card {outs['cuda']} / cpu {outs['cpu']}")
    if outs["cuda"] != outs["cpu"]:
        raise AssertionError("reduced model: greedy tokens differ between card and CPU")
    if [t for t, _ in logits["cuda"]] != [t for t, _ in logits["cpu"]]:
        raise AssertionError("reduced model: the engines took different steps")
    for i, ((tag, a), (_, b)) in enumerate(zip(logits["cuda"], logits["cpu"])):
        close(f"reduced {tag} call {i} logits (f32)", a, b, MODEL_TOL)
    del cpu_params

    # -------------------------------------------------- 4. full width -------
    log("phase 4: llama3-8b full width, bf16, dip storage, through Server")
    cfg = dataclasses.replace(get_config("llama3-8b"), matmul_backend="dip",
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (32, 4096, 128256)
    t0 = time.perf_counter()
    params = tf_model.init_params(cfg, make_generator(SEED, "cuda"), "cuda")
    torch.cuda.synchronize()
    log(f"  parameters drawn on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    server = Server(cfg, ServerConfig(batch_slots=4, max_seq=1024, max_new_tokens=16, temperature=0.0,
                                      prefill_chunk=256), params, device="cuda")
    eng = server.engine
    times = {"_prefill_fwd": [], "_decode": []}

    def timed(attr):
        f = getattr(eng, attr)

        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = f(*a)
            torch.cuda.synchronize()
            times[attr].append(time.perf_counter() - t)
            if not bool(torch.isfinite(out[0][..., :cfg.vocab_size]).all()):
                raise AssertionError(f"full width: non-finite logits from {attr}")
            return out
        setattr(eng, attr, run)

    timed("_prefill_fwd")
    timed("_decode")
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, size=int(rng.integers(200, 601))))
            for i in range(4)]
    torch.cuda.reset_peak_memory_stats()
    dip_matmul.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    results = server.serve(reqs)
    wall = time.perf_counter() - t0
    launches = {"dip_matmul": dip_matmul.launches, "flash_attention": flash_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    st = server.last_stats
    n_prefill, n_decode = len(times["_prefill_fwd"]), len(times["_decode"])
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    generated = sum(len(v) for v in results.values())
    log(f"  results: { {k: v[:6] for k, v in results.items()} }")
    log(f"  prompts {[len(r.prompt) for r in reqs]}, {generated} tokens generated, "
        f"{n_prefill} prefill chunks, {n_decode} decode steps, wall {wall:.2f} s")
    if sorted(results) != [0, 1, 2, 3] or any(not v for v in results.values()):
        raise AssertionError("full width: not every request was served")
    if (n_prefill, n_decode) != (st["prefill_chunks"], st["decode_steps"]):
        raise AssertionError("full width: step counts disagree with the engine's stats")
    want = {"dip_matmul": 193 * (n_prefill + n_decode), "flash_attention": 32 * n_prefill}
    log(f"  launches {launches}; expected {want} "
        f"(193 DiP launches per forward, 32 flash launches per prefill chunk)")
    if launches != want:
        raise AssertionError("full width: launch counts differ from 193/forward and 32/prefill chunk")
    prefill_s, decode_s = sum(times["_prefill_fwd"]), sum(times["_decode"])
    serving = {
        "prefill_tok_per_s": prompt_tokens / prefill_s,
        "decode_tok_per_s": (generated - len(reqs)) / decode_s,
        "median_prefill_chunk_ms": 1e3 * statistics.median(times["_prefill_fwd"]),
        "median_decode_step_ms": 1e3 * statistics.median(times["_decode"]),
        "peak_memory_gib": peak / 2**30,
        "wall_s": wall,
        "prefill_chunks": n_prefill,
        "decode_steps": n_decode,
    }
    log("  serving " + json.dumps(serving))
    del server, eng, params
    torch.cuda.empty_cache()

    # --------------------------------------------------------- 5. times -----
    log("phase 5: times (ms, median of 10 after 3 warm-ups, L2 flushed before each)")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def time_ms(fn, iters=10, warmup=3):
        for _ in range(warmup):
            fn()
        ts = []
        for _ in range(iters):
            flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)

    def bound_ms(nbytes, flops, dt_name):
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dt_name]
        return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"

    rows_out = []
    for dt_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dt_name)
        isz = torch.finfo(dtype).bits // 8
        for m in (4, 256):
            for label, k, n, e, pr in proj:
                x, p, eops, kw = dip_inputs(m, k, n, e, pr, dtype)
                s = epi.spec(e)
                nw = 2 if s.dual_weight else 1
                wn = [api.DipWeight(w, k, n).to_natural().contiguous() for w in (p,) + eops[:nw - 1]]
                gain = kw["prologue_operands"][0] if pr == "rmsnorm" else None

                def library():
                    xx = pro.apply("rmsnorm", x, gain) if gain is not None else x
                    z = torch.matmul(xx, wn[0])
                    if s.dual_weight:
                        return F.silu(z) * torch.matmul(xx, wn[1])
                    return z + eops[0] if s.residual else z

                nbytes = (m * k + nw * k * n + m * n * (2 if s.residual else 1)) * isz
                nbytes += (4 * (k + m) if gain is not None else 0)
                b_ms, b_by = bound_ms(nbytes, 2 * m * k * n * nw, dt_name)
                row = dict(kernel="dip_matmul", dtype=dt_name, shape=f"M={m} {label} K={k} N={n} {e}/{pr}",
                           ms=time_ms(lambda: dip_matmul(x, p, *eops, **kw)),
                           plain_ms=time_ms(lambda: dip_matmul_plain(x, p, *eops, **kw)),
                           library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)
                rows_out.append(row)
                log("  " + json.dumps(row))
                del x, p, eops, wn
        for label, dk, dvv, qo, kvl in flash_cases:
            q, k, v = flash_inputs(dk, dvv, dtype)
            kw = dict(q_offset=torch.tensor(qo, device=dev), kv_len=kvl, causal=True)
            i = torch.arange(sq, device=dev)
            live = torch.clamp(torch.minimum(kvl.view(-1, 1).long(), qo + i.view(1, -1) + 1), min=0).sum().item()
            # only the keys some query of the row can see must be read: those
            # below min(Sk, kv_len, q_offset + Sq)
            keys = torch.clamp(torch.clamp(kvl.long(), max=min(sk, qo + sq)), min=0).sum().item()
            nbytes = (q.numel() + keys * (dk + dvv) + bh * sq * dvv) * isz + 8 * bh
            b_ms, b_by = bound_ms(nbytes, 2 * live * (dk + dvv), dt_name)
            mask = (torch.arange(sk, device=dev).view(1, 1, -1) < kvl.view(-1, 1, 1)) & (
                qo + i.view(1, -1, 1) >= torch.arange(sk, device=dev).view(1, 1, -1))
            q4, k4, v4, m4 = q[None], k[None], v[None], mask[None]
            row = dict(kernel="flash_attention", dtype=dt_name,
                       shape=f"BH={bh} Sq={sq} Sk={sk} D={dk} Dv={dvv} {label}",
                       ms=time_ms(lambda: flash_attention(q, k, v, **kw)),
                       plain_ms=time_ms(lambda: attention_plain(q, k, v, **kw)),
                       library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                           q4, k4, v4, attn_mask=m4, scale=dk ** -0.5)),
                       bound_ms=b_ms, bound_by=b_by)
            rows_out.append(row)
            log("  " + json.dumps(row))
            del q, k, v, mask

    # one line per kernel: the served dtype at the prefill chunk's largest launch
    pick = {"dip_matmul": "M=256 gate+up", "flash_attention": "q_offset 512"}
    sources = {"dip_matmul": ("src/repro_torch/kernels/csrc/dip_matmul.cu", "src/repro/kernels/dip_matmul.py:100"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:117")}
    kernels = []
    for name in ("dip_matmul", "flash_attention"):
        row = next(r for r in rows_out if r["kernel"] == name and r["dtype"] == "bfloat16"
                   and pick[name] in r["shape"])
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1], "launches": launches[name],
                        "max_abs_err": worst[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": f"bfloat16 {row['shape']}"})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
