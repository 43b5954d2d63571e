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
