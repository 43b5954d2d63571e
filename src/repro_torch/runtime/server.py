"""``Server``: the batch serving API over the engine (port of
``repro/runtime/server.py``).

``Server`` keeps the reference's surface — ``ServerConfig`` / ``Request`` /
``serve()`` / ``last_stats`` — over :class:`repro_torch.serving.Engine`.
The static-batch ``WaveServer`` baseline comes with the benchmarks
(ROADMAP.md Queue 1 "Tooling").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import SamplingParams

__all__ = ["Server", "ServerConfig", "Request"]


@dataclasses.dataclass
class ServerConfig:
    batch_slots: int = 4
    max_seq: int = 512
    max_new_tokens: int = 64
    temperature: float = 0.8
    top_k: int = 50
    eos_id: int = 1
    prefill_chunk: int = 32
    block_size: Optional[int] = None
    kv_quant: Optional[str] = None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    max_new: Optional[int] = None      # per-request cap (None -> ServerConfig)


class Server:
    """The batch API served by the engine on ``device`` (default
    ``"cuda"``; raises without a card unless ``device="cpu"``); ``plan``
    serves this rank's part of a sharded world (``Engine(plan=)``)."""

    def __init__(self, cfg, scfg: ServerConfig, params, *, device="cuda", plan=None):
        self.cfg = cfg
        self.scfg = scfg
        self.engine = Engine(
            cfg, params,
            engine_cfg=EngineConfig(
                slots=scfg.batch_slots, max_seq=scfg.max_seq, prefill_chunk=scfg.prefill_chunk,
                block_size=scfg.block_size, kv_quant=scfg.kv_quant, eos_id=scfg.eos_id,
            ),
            device=device, plan=plan,
        )
        self.params = self.engine.params
        self.last_stats: Dict = {}

    def _sampling_for(self, req: Request) -> SamplingParams:
        return SamplingParams(
            temperature=self.scfg.temperature,
            top_k=self.scfg.top_k,
            max_new_tokens=req.max_new or self.scfg.max_new_tokens,
            seed=req.rid,
        )

    def serve(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Run all requests to completion through the engine's slot pool."""
        for r in requests:
            self.engine.add_request(r.prompt, self._sampling_for(r), rid=r.rid)
        results = self.engine.run()
        for r in requests:
            r.out_tokens = list(results.get(r.rid, []))
            r.done = r.rid in results
        self.last_stats = dict(self.engine.last_stats)
        return results
