"""Deterministic, shardable, restart-safe synthetic LM data pipeline.

Port of ``repro/data/pipeline.py``, copied unchanged: the module is pure
numpy, so the same ``(seed, step)`` gives the reference's batches bit for
bit.  The port keeps its own copy and imports nothing of the reference.

Design goals (the ones that matter at 1000+ nodes):

  * **Stateless addressing** — batch ``i`` is a pure function of
    ``(seed, i)`` via counter-based hashing (threefry, same family as JAX
    PRNG).  Any host can produce any batch shard without coordination, so
    elastic re-sharding and restart-after-failure need only the integer
    ``step`` stored in the checkpoint (see DataState).
  * **Host sharding** — each host materializes only its
    ``global_batch / num_shards`` slice.
  * **Prefetch** — a small background thread keeps ``prefetch`` batches
    ready (overlaps host-side generation with device steps).

The token stream is structured (document lengths ~ geometric, EOS-delimited,
Zipf-ish unigram distribution) so losses behave like a language-modeling
run, not uniform noise.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["SyntheticLM", "DataState"]


@dataclasses.dataclass
class DataState:
    """Checkpointable pipeline position."""

    step: int = 0

    def to_dict(self) -> Dict:
        return {"step": int(self.step)}

    @staticmethod
    def from_dict(d: Dict) -> "DataState":
        return DataState(step=int(d["step"]))


class SyntheticLM:
    def __init__(
        self,
        *,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
        emit_embeddings: Optional[int] = None,  # [vlm]/[audio]: d_model or None
        prefetch: int = 2,
    ):
        if global_batch % num_shards:
            raise ValueError("global_batch must divide num_shards")
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard = shard_index
        self.num_shards = num_shards
        self.emit_embeddings = emit_embeddings
        self._prefetch_n = prefetch
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._cursor = 0
        self._stop = threading.Event()

    # --------------------------------------------------------- batch math --
    def _rng_for(self, step: int, row: int) -> np.random.Generator:
        # counter-based: unique stream per (seed, step, global row index)
        gidx = self.shard * self.local_batch + row
        return np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(step, gidx))
        )

    def _row(self, step: int, row: int) -> np.ndarray:
        rng = self._rng_for(step, row)
        out = np.empty(self.seq + 1, np.int32)
        pos = 0
        while pos < self.seq + 1:
            doc_len = int(rng.geometric(1.0 / 384.0))
            # clamp to the remaining room LAST (min-of-max, not max-of-min:
            # the other order overruns the buffer when < 8 slots remain)
            doc_len = min(max(8, doc_len), self.seq + 1 - pos)
            # Zipf-ish unigrams, rejected down into the vocab
            toks = rng.zipf(1.3, size=doc_len).astype(np.int64)
            toks = (toks - 1) % max(2, self.vocab - 2) + 2  # ids 0/1 reserved
            out[pos : pos + doc_len] = toks
            pos += doc_len
            if pos < self.seq + 1:
                out[pos - 1] = 1  # EOS
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The shard-local batch for global step ``step`` (pure function)."""
        rows = np.stack([self._row(step, r) for r in range(self.local_batch)])
        item = {"tokens": rows[:, : self.seq], "labels": rows[:, : self.seq]}
        if self.emit_embeddings:
            rng = self._rng_for(step, 1 << 30)
            item = {
                "embeddings": rng.standard_normal(
                    (self.local_batch, self.seq, self.emit_embeddings), np.float32
                )
                * 0.02,
                "labels": rows[:, : self.seq],
            }
        return item

    # ----------------------------------------------------------- prefetch --
    def start(self, state: DataState) -> None:
        self._cursor = state.step
        self._queue = queue.Queue(maxsize=self._prefetch_n)
        self._stop.clear()

        def worker():
            s = self._cursor
            while not self._stop.is_set():
                try:
                    item = (s, self.batch(s))
                except Exception as exc:  # surface worker death to the consumer
                    item = ("error", exc)
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if item[0] == "error":
                    return
                s += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self._queue = None

    def __iter__(self) -> Iterator:
        if self._queue is None:
            raise RuntimeError("call start(DataState) first")
        while True:
            step, item = self._queue.get()
            if step == "error":
                raise RuntimeError("data pipeline worker failed") from item
            yield step, item
