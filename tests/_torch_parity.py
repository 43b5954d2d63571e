"""Helpers for the port's parity tests: the same numpy inputs go through
the JAX reference and the PyTorch port, and the outputs are compared as
float32 numpy arrays under a stated tolerance."""

import dataclasses

import numpy as np
import torch

# max|port - reference| <= TOL * max(1, max|reference|).
# float32: both sides compute in IEEE f32 and differ only in summation order.
# bfloat16: both accumulate the same bf16 operands in f32, so after the final
# cast to bf16 they differ by at most about one bf16 step (2^-8).
TOL = {"float32": 1e-5, "bfloat16": 8e-3}


def as_np(a) -> np.ndarray:
    """A torch tensor or JAX/numpy array as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def assert_close(got, want, tol) -> float:
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, f"shape {got.shape} != {want.shape}"
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= tol * scale, f"max|err| {err} > {tol} * {scale}"
    return err


def reduced_configs(backend_ref="pallas_dip", backend_port="dip", dtype="float32", quantization="none",
                    kv_quant="none"):
    """The reduced llama3-8b on both sides with the same fields."""
    from repro.configs import get_config as ref_get
    from repro_torch.configs import get_config as port_get

    kw = dict(param_dtype=dtype, compute_dtype=dtype, quantization=quantization, kv_quant=kv_quant)
    return (dataclasses.replace(ref_get("llama3_8b").reduced(), matmul_backend=backend_ref, **kw),
            dataclasses.replace(port_get("llama3-8b").reduced(), matmul_backend=backend_port, **kw))


def reference_params(cfg, seed=0):
    """The reference's init_params output, and the same weights as numpy."""
    import jax
    from repro.models import transformer as ref_tf

    params = ref_tf.init_params(jax.random.PRNGKey(seed), cfg)
    return params, jax.tree_util.tree_map(np.asarray, params)


# the families that train beside llama3-8b (tests/test_torch_train_families*.py)
FAMILIES = ["deepseek-v2-lite-16b", "qwen3-moe-235b-a22b", "zamba2-2.7b", "mamba2-370m", "musicgen-medium",
            "phi-3-vision-4.2b"]


def family_configs(name, **over):
    """``reduced()`` of ``name`` in f32 on both sides: the reference on its
    ``xla`` backend over DiP storage (``dip_weights=True``, cheap on the
    CPU), the port on ``dip``."""
    from repro.configs import get_config as ref_get
    from repro_torch.configs import get_config as port_get

    kw = dict(param_dtype="float32", compute_dtype="float32", **over)
    return (dataclasses.replace(ref_get(name).reduced(), matmul_backend="xla", dip_weights=True, **kw),
            dataclasses.replace(port_get(name).reduced(), matmul_backend="dip", **kw))


def family_batch(cfg, step=0, batch=2, seq=32):
    """The trainer's batch for ``cfg`` (tokens, or a stub frontend's
    embeddings) as JAX arrays and as torch tensors."""
    import jax.numpy as jnp
    from repro_torch.data import SyntheticLM

    emb = cfg.d_model if cfg.frontend != "none" else None
    host = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, emit_embeddings=emb).batch(step)
    return ({k: jnp.asarray(v) for k, v in host.items()}, {k: torch.as_tensor(v) for k, v in host.items()})


def leaf_close(got, want, rel) -> None:
    """max|got - want| <= rel * max|want| (a gradient or moment leaf)."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), f"max|err| {err} > {rel} x max|ref|"
