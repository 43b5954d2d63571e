"""The port stands alone: importing every module of ``repro_torch`` pulls in
neither ``jax`` nor the reference package ``repro``, and the entry points
run on the card unless the caller asks for the CPU."""

import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.device import make_generator, resolve_device
from repro_torch.models import transformer as tf_model
from repro_torch.runtime import Server, ServerConfig
from repro_torch.serving import Engine, EngineConfig

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_reference():
    mods = _all_modules()
    assert "repro_torch.kernels.dip_matmul" in mods and "repro_torch.launch.serve" in mods
    # the training slice's modules are walked too
    assert {"repro_torch.kernels.lm_head_ce", "repro_torch.optim.adamw", "repro_torch.optim.schedules",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.manager", "repro_torch.runtime.trainer",
            "repro_torch.launch.train", "repro_torch.tree"} <= set(mods)
    # and the quantized serving slice's
    assert {"repro_torch.api.quant", "repro_torch.kernels.dip_matmul_q",
            "repro_torch.kernels.dip_systolic"} <= set(mods)
    # and the SSM / hybrid serving slice's
    assert {"repro_torch.models.ssm", "repro_torch.configs.mamba2_370m",
            "repro_torch.configs.zamba2_2_7b"} <= set(mods)
    # and the reliability layer's
    assert {"repro_torch.reliability", "repro_torch.reliability.abft", "repro_torch.reliability.guard",
            "repro_torch.reliability.inject"} <= set(mods)
    # and the distributed layer's
    assert {"repro_torch.distributed", "repro_torch.distributed.comm", "repro_torch.distributed.plan",
            "repro_torch.distributed.world", "repro_torch.kernels.dip_matmul_sharded"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(bad)); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"}, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _reduced():
    return dataclasses.replace(get_config("llama3-8b").reduced(), matmul_backend="dip",
                               compute_dtype="float32")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a card")
    cfg = _reduced()
    params = tf_model.init_params(cfg, make_generator(0, "cpu"), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Server(cfg, ServerConfig(), params)
    with pytest.raises(RuntimeError, match="cuda"):
        tf_model.init_params(cfg, make_generator(0, "cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "llama3-8b", "--requests", "1"])
    from repro_torch.runtime import Trainer, TrainerConfig
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, TrainerConfig())


def test_cpu_server_serves_when_asked():
    cfg = _reduced()
    params = tf_model.init_params(cfg, make_generator(0, "cpu"), device="cpu")
    server = Server(cfg, ServerConfig(batch_slots=2, max_seq=32, max_new_tokens=3, temperature=0.0,
                                      prefill_chunk=8), params, device="cpu")
    from repro_torch.runtime import Request
    out = server.serve([Request(rid=0, prompt=[5, 6, 7]), Request(rid=1, prompt=[9, 10])])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())


def test_launch_serve_on_cpu(capsys):
    from repro_torch.launch import serve
    results = serve.main(["--arch", "llama3-8b", "--reduced", "--dtype", "float32", "--requests", "2",
                          "--max-new", "2", "--max-seq", "64", "--prefill-chunk", "16",
                          "--device", "cpu"])
    assert sorted(results) == [0, 1]
    assert '"serve"' in capsys.readouterr().out


@pytest.mark.parametrize("scheme", ["int8", "fp8_e4m3"])
def test_launch_serve_quantized_on_cpu(scheme, capsys):
    from repro_torch.launch import serve
    results = serve.main(["--arch", "llama3-8b", "--reduced", "--dtype", "float32", "--requests", "2",
                          "--max-new", "2", "--max-seq", "64", "--prefill-chunk", "16", "--device", "cpu",
                          "--quantize", scheme, "--kv-quant", "int8"])
    assert sorted(results) == [0, 1] and all(len(v) == 2 for v in results.values())
    assert '"serve"' in capsys.readouterr().out


@pytest.mark.parametrize("what", ["verify", "ttl", "kv_int8", "moe", "backend", "quant_grad"])
def test_branches_outside_the_slice_raise(what):
    cfg = _reduced()
    params = tf_model.init_params(cfg, make_generator(0, "cpu"), device="cpu")
    if what == "verify":  # the screen serves now (test_torch_reliability_serving.py)
        eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=1, max_seq=32, prefill_chunk=8, verify=True),
                     device="cpu")
        rid = eng.add_request([5, 6, 7])
        assert len(eng.run()[rid]) > 0 and eng.last_stats["faults_detected"] == 0
        assert eng._decode_xla is None  # the degraded step is built on a first fault only
    elif what == "ttl":  # request deadlines too: an engine-wide TTL stamps every request
        eng = Engine(cfg, params, engine_cfg=EngineConfig(slots=1, max_seq=32, prefill_chunk=8, ttl_s=1e6),
                     device="cpu")
        eng.add_request([5, 6, 7])
        req = eng.scheduler.waiting[0]
        assert req.deadline_s == pytest.approx(req.arrival_s + 1e6)
    elif what == "kv_int8":  # int8 KV serves now, MLA's latent pools too (test_torch_quant_families.py)
        from repro_torch.serving import kv_cache
        mla = dataclasses.replace(cfg, use_mla=True, kv_lora_rank=64)
        # (rank + rope) one-byte codes and two f32 scales per token and layer
        assert kv_cache.bytes_per_block(mla, 16, "int8") == cfg.n_layers * 16 * (64 + mla.qk_rope_head_dim + 8)
    elif what == "moe":  # MoE serves (test_torch_moe_serving.py) and trains (test_torch_train_families.py)
        moe_cfg = dataclasses.replace(cfg, family="moe", n_experts=4, moe_top_k=2, d_ff_expert=64)
        params = tf_model.init_params(moe_cfg, make_generator(0, "cpu"), device="cpu")
        toks = torch.arange(2, 10, dtype=torch.long)[None]
        batch = {"tokens": toks, "labels": toks}
        loss = tf_model.loss_fn(params, moe_cfg, batch)
        _, _, aux = tf_model.forward(params, moe_cfg, tokens=toks, return_aux=True)
        # the loss is the cross entropy plus the router aux (load balance +
        # z-loss); without the load-balance weight only the z-loss is left
        no_lb = dataclasses.replace(moe_cfg, router_aux_loss=0.0)
        _, _, z = tf_model.forward(params, no_lb, tokens=toks, return_aux=True)
        assert torch.isfinite(loss) and float(aux) > float(z) > 0
        torch.testing.assert_close(loss - aux, tf_model.loss_fn(params, no_lb, batch) - z)
    elif what == "quant_grad":  # the straight-through backward (test_torch_quant_grad.py)
        from repro_torch import api
        x = torch.randn(2, 64, requires_grad=True)
        qw = api.quant.quantize(torch.randn(64, 64), "int8")
        api.matmul(x, qw).sum().backward()
        # d(sum)/dx against the dequantized weight: its row sums
        torch.testing.assert_close(x.grad, qw.to_natural().sum(1).expand(2, 64))
    else:  # dip_tp / dip_fsdp / dip_sp / dip_ep serve now (test_torch_sharded_*.py)
        from repro_torch import api
        assert api.backend_layout("dip_tp") == api.backend_layout("dip_ep") == "sharded"
        assert api.get_backend("dip_ep").fn is api.get_backend("dip_tp").fn  # dip_tp's placement
