"""Serving engine (port of ``repro.serving``): continuous batching over a
fixed slot pool, a paged block KV cache, chunked prefill through the flash
kernel, per-request sampling, FCFS admission with LIFO preemption."""

from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.kv_cache import BlockAllocator, PagedKVCache, make_import_fn
from repro_torch.serving.sampling import sample_tokens
from repro_torch.serving.scheduler import FCFSScheduler, SamplingParams, ServeRequest

__all__ = [
    "Engine",
    "EngineConfig",
    "SamplingParams",
    "ServeRequest",
    "FCFSScheduler",
    "BlockAllocator",
    "PagedKVCache",
    "make_import_fn",
    "sample_tokens",
]
