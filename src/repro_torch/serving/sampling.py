"""Vectorized host-side token sampling (Gumbel-max); numpy only, copied
from ``repro/serving/sampling.py``.

Replaces the per-row ``rng.choice`` Python loop of the legacy server —
O(batch * vocab) Python-object work per token — with one numpy pass over the
(B, V) logits.  The Gumbel-max identity,

    argmax_i (logits_i / T + g_i),   g_i ~ Gumbel(0, 1)

draws from softmax(logits / T) exactly, so no normalized probabilities (and
no ``rng.choice``) are ever materialized.  Per-row temperature / top-k /
top-p / greedy all vectorize as masks on the scaled logits.

Randomness comes in as explicit per-row uniforms so callers control
determinism: the engine draws each row from its request's own seeded
generator (a request's sample stream is independent of which slot or
batch-mates it runs with), the legacy server from one shared generator.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sample_tokens", "gumbel_from_uniform"]

_EPS = 1e-20
# largest double strictly below 1.0: the old `1.0 - 1e-20` upper clip rounds
# to exactly 1.0 in float64, so a boundary uniform of 1.0 sailed through to
# -log(-log(1.0)) = +inf — one inf noise lane then hijacks the argmax (and
# lands on a -inf-masked token as inf + -inf = nan)
_ONE_BELOW = np.nextafter(1.0, 0.0)


def gumbel_from_uniform(u: np.ndarray) -> np.ndarray:
    """Standard Gumbel(0,1) noise from uniforms in [0, 1)."""
    return -np.log(-np.log(np.clip(u, _EPS, _ONE_BELOW)))


def sample_tokens(
    logits: np.ndarray,          # (B, V) float
    *,
    temperature: np.ndarray,     # (B,) — rows with T <= 0 decode greedily
    top_k: np.ndarray,           # (B,) int — 0 disables
    top_p: np.ndarray,           # (B,) float — 1.0 disables
    uniforms: np.ndarray,        # (B, V) in [0, 1)
) -> np.ndarray:
    """Draw one token per row; returns (B,) int32.

    Greedy rows (temperature <= 0) take ``argmax`` of the raw logits and
    ignore top-k/top-p/noise entirely, so a greedy request is bit-stable
    regardless of the uniforms supplied for its row.
    """
    logits = np.asarray(logits, np.float32)
    b, v = logits.shape
    temperature = np.asarray(temperature, np.float32)
    top_k = np.asarray(top_k, np.int64)
    top_p = np.asarray(top_p, np.float32)

    greedy = temperature <= 0.0
    t_safe = np.where(greedy, 1.0, temperature)[:, None]
    scaled = logits / t_safe

    # ranks of each logit within its row, descending (rank 0 = largest)
    order = np.argsort(-scaled, axis=-1, kind="stable")         # (B, V)
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.broadcast_to(np.arange(v), (b, v)), -1)

    # top-k: keep ranks < k (k <= 0 keeps everything)
    k_eff = np.where(top_k <= 0, v, top_k)[:, None]
    keep = ranks < k_eff

    # top-p (nucleus): over the *descending* row, keep the smallest prefix
    # whose probability mass reaches top_p.  "cum - p < top_p" keeps the
    # first token crossing the threshold, so at least one survives.
    p_mask = top_p < 1.0
    if p_mask.any():
        masked = np.where(keep, scaled, -np.inf)        # nucleus after top-k
        shifted = masked - masked.max(-1, keepdims=True)
        probs = np.exp(shifted)
        probs /= probs.sum(-1, keepdims=True)
        p_sorted = np.take_along_axis(probs, order, -1)
        cum = np.cumsum(p_sorted, -1)
        keep_sorted = (cum - p_sorted) < top_p[:, None]
        keep_p = np.empty_like(keep)
        np.put_along_axis(keep_p, order, keep_sorted, -1)
        keep &= ~p_mask[:, None] | keep_p

    noisy = np.where(keep, scaled, -np.inf) + gumbel_from_uniform(uniforms)
    drawn = noisy.argmax(-1)
    return np.where(greedy, logits.argmax(-1), drawn).astype(np.int32)
