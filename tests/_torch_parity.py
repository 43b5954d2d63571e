"""Helpers for the port's parity tests: the same numpy inputs go through
the JAX reference and the PyTorch port, and the outputs are compared as
float32 numpy arrays under a stated tolerance."""

import dataclasses

import numpy as np
import torch

from repro_torch.kernels._bf16_parts import F32_PRODUCTS, split_matmul
from repro_torch.kernels.flash_attention import per_row_i32

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


def lm_head_ce_parts_plain(x, w, labels, vocab_size, products=F32_PRODUCTS):
    """``(logz, label_logit)`` of the card's f32 x f32 ``lm_head_ce`` route
    in dense torch: each logit the sum of ``products`` bf16 part products
    (``split_matmul``), columns past ``vocab_size`` masked, a label of -100
    matching no column."""
    z = split_matmul(x.float(), w.float(), products)
    z = torch.where(torch.arange(w.shape[1]) < vocab_size, z, -torch.inf)
    lab = labels.long()
    hit = z.gather(1, lab.clamp(min=0).view(-1, 1)).view(-1)
    return torch.logsumexp(z, dim=1), torch.where(lab >= 0, hit, 0.0)


def attention_parts_plain(q, k, v, *, q_offset=None, kv_len=None, causal=True, products=F32_PRODUCTS):
    """The card's f32 flash routes in dense torch: the scores q k^T and the
    unnormalised probabilities exp(s - max) times v, each as ``products``
    bf16 part products (``split_matmul``), the scale D^-1/2 applied to the
    scores after the product, the row sum over the f32 probabilities
    divided out at the end; fully masked rows exactly 0."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    k_pos = torch.arange(sk, dtype=torch.int32).view(1, 1, sk)
    live = k_pos < per_row_i32(kv_len, bh, sk, q.device).view(bh, 1, 1)
    if causal:
        q_pos = per_row_i32(q_offset, bh, 0, q.device).view(bh, 1, 1) + torch.arange(
            sq, dtype=torch.int32).view(1, sq, 1)
        live = live & (q_pos >= k_pos)
    s = torch.stack([split_matmul(q[b].float(), k[b].float().T, products) for b in range(bh)]) * d ** -0.5
    s = torch.where(live, s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - torch.where(torch.isinf(m), 0.0, m)), 0.0)
    o = torch.stack([split_matmul(p[b], v[b].float(), products) for b in range(bh)])
    return (o / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)).to(q.dtype)


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
