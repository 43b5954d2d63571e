"""Architecture configuration schema (port of ``repro/configs/base.py``).

The ``ArchConfig`` dataclass is copied from the reference with the same
field names and defaults, so a configuration means the same thing on both
sides.  ``quant_scheme`` and ``uses_dip_storage`` ask the port's
``api.quant`` and matmul registry instead of the reference's.
``matmul_backend`` keeps the reference's names: the port's registry
resolves ``xla``, ``pallas_dip`` and ``pallas_systolic`` to its ``torch``,
``dip`` and ``systolic`` backends.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeCell", "SHAPE_CELLS"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    # transformer backbone
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001
    # MLA (DeepSeek multi-head latent attention)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (Zamba2-style shared attention)
    attn_every: int = 0              # 0 = no shared attention blocks
    # modality frontend (stubbed per assignment: precomputed embeddings)
    frontend: str = "none"           # none | vision_stub | audio_stub
    # numerics / implementation
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    matmul_backend: str = "xla"      # registered repro.api backend name
                                     # (xla | ws | pallas_dip | pallas_systolic
                                     #  | dip_int8w | dip_fp8 | plugins)
    dip_weights: bool = False        # force DiP permutated weight storage even
                                     # for natural-layout backends (e.g. dip
                                     # checkpoints served through XLA/GSPMD)
    quantization: str = "none"       # weight-quantization scheme for the DiP
                                     # projections: none | int8 | fp8_e4m3
                                     # (inference-only; see docs/quantization.md)
    kv_block_size: int = 16          # paged-KV block size (tokens per block)
                                     # for the serving engine (repro.serving);
                                     # see docs/serving.md §Paged KV layout
    kv_quant: str = "none"           # KV-cache storage for paged serving:
                                     #   none  compute-dtype (bf16) reference
                                     #   int8  per-token/head int8 + f32 scales
                                     #         (~2x more sequences per byte;
                                     #          bound in docs/serving.md)
    sharding: str = "gspmd"          # declared parallelism strategy consumed
                                     # by repro.distributed.plan.make_plan:
                                     #   gspmd  implicit XLA partitioning of
                                     #          the plain dot (default)
                                     #   tp     explicit column/row shard_map
                                     #          kernels (dip_tp backend)
                                     #   fsdp   explicit K-sharded
                                     #          all-gather-on-load (dip_fsdp)
                                     #   sp     sequence-parallel: activations
                                     #          stay M-sharded, x blocks ring
                                     #          through the kernel's load
                                     #          stage (dip_sp backend)
                                     #   ep     expert-parallel MoE: expert
                                     #          banks sharded, all-to-all
                                     #          token dispatch (dip_ep)
                                     #   pp     pipeline stages over a "stage"
                                     #          mesh axis (GPipe microbatching
                                     #          via distributed.pipeline)
                                     # (see docs/distributed.md)
    remat: str = "block"             # none | block  (remat each scanned block)
    # notes for DESIGN.md §Arch-applicability
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab storage padded so logits/embeddings shard over any mesh axis
        (multiple of 2048 covers TP<=64 x FSDP<=32); padded lanes are masked
        to -inf in the loss and never indexed by token ids."""
        mult = 2048
        return -(-self.vocab_size // mult) * mult

    @property
    def quant_scheme(self) -> Optional[str]:
        """Validated quantization scheme name, or None when unquantized."""
        if self.quantization == "none":
            return None
        from repro_torch.api import quant  # deferred: keep config import light

        return quant.scheme_info(self.quantization).name

    @property
    def uses_dip_storage(self) -> bool:
        """Whether linear weights are held as permutated-storage pytree nodes
        (``api.DipWeight`` / ``api.QuantizedDipWeight``): forced
        (``dip_weights``), implied by quantization (quantized storage is
        permutated by construction), or required by the backend's declared
        layout (the dip-consuming Pallas kernels)."""
        if self.dip_weights or self.quantization != "none":
            return True
        from repro_torch import api  # deferred: keep config import light

        # the sharded backends run the dip-layout kernels on the local shards
        return api.backend_layout(self.matmul_backend) in ("dip", "dip_q", "sharded")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and self.attn_every == 0 and self.n_heads == 0

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.attn_every > 0

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid families)."""
        return self.ssm_state > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + stacked blocks)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim if self.n_heads else 0
        per_layer = 0
        if self.n_heads and not self.use_mla:
            per_layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.use_mla:
            per_layer += d * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            per_layer += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            per_layer += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            per_layer += self.n_heads * self.v_head_dim * d
        if self.is_moe:
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * self.d_ff_expert
            per_layer += self.n_shared_experts * 3 * d * self.d_ff_expert
        elif self.d_ff:
            per_layer += 3 * d * self.d_ff
        if self.ssm_state:
            di = self.d_inner
            ssm = d * (2 * di + 2 * self.ssm_state + self.n_ssm_heads) + di * d
            per_layer = ssm if not self.is_hybrid else per_layer  # hybrid counts ssm below
            if self.is_hybrid:
                # mamba blocks every layer + one shared attention block
                return total + self.n_layers * ssm + (
                    d * self.n_heads * hd * 2 + 2 * d * self.n_kv_heads * hd + 3 * d * self.d_ff
                )
        return total + self.n_layers * per_layer

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        dense = self.param_count()
        expert = 3 * self.d_model * self.d_ff_expert
        inactive = (self.n_experts - self.moe_top_k) * expert * self.n_layers
        return dense - inactive

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else 2 * max(1, self.attn_every)),
            d_model=128,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else None,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2),
            d_ff_expert=64 if self.d_ff_expert else 0,
            kv_lora_rank=64 if self.kv_lora_rank else 0,
            qk_nope_head_dim=32 if self.use_mla else self.qk_nope_head_dim,
            qk_rope_head_dim=16 if self.use_mla else self.qk_rope_head_dim,
            v_head_dim=32 if self.use_mla else self.v_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            remat="none",
        )
        if self.attn_every:
            small["n_layers"] = 4
            small["attn_every"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell: what gets lowered in the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)
