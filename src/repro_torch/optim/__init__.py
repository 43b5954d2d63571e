"""Optimizers and schedules (port of ``repro.optim``)."""

from repro_torch.optim.adamw import AdamW, clip_by_global_norm
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["AdamW", "clip_by_global_norm", "cosine_schedule", "linear_warmup"]
