"""CUDA graphs of the serving steps: the port's counterpart of the
reference engine's ``jax.jit`` (``repro/serving/engine.py``: the paged
decode step and the chunked-prefill forward, each one compiled shape).

:class:`CapturedStep` wraps a step ``fn(params, cache, *inputs) -> (out,
cache)`` that reads the parameters, updates the cache's tensors in place
and takes small integer inputs (tokens, positions, block tables).  Its
first call with an input shape

1. copies the inputs into static device buffers (one byte buffer, every
   input a 16-byte-aligned view of it);
2. runs the step eagerly on the capture stream, on the real parameters and
   cache: this is the call's own step (its launches are real and counted),
   and it makes every lazy set-up happen outside the capture: a kernel
   library's first load and ``cudaFuncSetAttribute``, cuBLAS's workspace
   for the stream, flash's split tickets for the stream, the RoPE and
   permutation constants on the device;
3. captures the same call into a graph under ``torch.no_grad()`` (a capture
   records and runs nothing, so the cache is not written twice) and returns
   the eager step's outputs;

every later call stages the inputs (host tensors, as the engine holds them)
into the static buffers through one pinned buffer and one asynchronous
copy, replays the graph on the current stream and returns the captured
outputs.  The step must read no device value into Python and copy no host
data to the device: a capture that meets either raises
(``capture_error_mode="global"``).

Every graph of the object draws its memory from one pool, ``pool`` (give
several objects one ``torch.cuda.graph_pool_handle()`` and they share it):
graphs that never run at once then hold the largest step's intermediates,
not the sum.  So a replay's outputs stay valid until the next replay of any
graph of the pool: a caller reads what it needs (the engine copies its
logits rows to the host) before the next call.  A call with parameters or a
cache other than the objects it was built on, an input shape not given at
construction, or another input dtype raises: nothing falls back to the
eager step.  The call returns the caller's cache object (the step updated
its tensors in place), so the engine keeps one tree.  The graphs and their
pool belong to the object and are freed with it.

Launch counts stay true: a replay runs no Python, so at capture the step's
increase of every kernel wrapper's counters (``launches*``) is recorded and
taken back (the capture launched nothing), and each replay adds it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import lm_head_ce
from repro_torch.kernels.dip_matmul import dip_matmul
from repro_torch.kernels.dip_matmul_q import dip_matmul_q
from repro_torch.kernels.dip_systolic import dip_systolic
from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["CapturedStep", "launch_counts"]

_COUNTED = (dip_matmul, dip_matmul_q, dip_systolic, flash_attention, lm_head_ce.lm_head_ce)
_ALIGN = 16
Shapes = Tuple[Tuple[int, ...], ...]


def launch_counts() -> Dict[Tuple[Any, str], int]:
    """Every kernel wrapper's launch counters (``launches``,
    ``launches_tc``, ...), keyed by (wrapper, attribute)."""
    return {(fn, nm): getattr(fn, nm) for fn in _COUNTED for nm in vars(fn) if nm.startswith("launches")}


def _add_counts(delta: Dict[Tuple[Any, str], int], sign: int = 1) -> None:
    for (fn, nm), n in delta.items():
        setattr(fn, nm, getattr(fn, nm) + sign * n)


_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per device for every first call and capture, so
    that the per-stream state the kernels keep (flash's split tickets) is
    made once, outside any capture, and graphs that share a pool are
    captured on one stream."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    host_inputs: List[torch.Tensor]  # views of ``pinned``, laid out as the graph's inputs in ``device_buf``
    device_buf: torch.Tensor
    pinned: torch.Tensor
    out: Any
    launches: Dict[Tuple[Any, str], int]  # counter increase per replay


class CapturedStep:
    """``fn(params, cache, *inputs)`` as CUDA graphs, one per input shape
    in ``shapes`` (a list of tuples of input shapes), each captured at its
    first call.  ``params`` and ``cache`` are the objects every call must
    pass (the graph reads and writes their tensors in place, so neither
    tree's tensors may be replaced).  ``pool`` is the graphs' memory pool
    (default: one of their own).  ``captures`` records, per input shape,
    the seconds the capture took, the device memory it reserved in the pool
    and the counter increase of one replay."""

    def __init__(self, fn, params, cache, shapes: Sequence[Sequence[Sequence[int]]], pool=None):
        self.fn = fn
        self.params, self.cache = params, cache
        devices = {t.device for t in _tensors(cache)}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"a captured step needs a cache on one CUDA device, got {sorted(map(str, devices))}")
        self.device = next(iter(devices))
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.shapes = {tuple(tuple(int(d) for d in s) for s in sh) for sh in shapes}
        self._graphs: Dict[Shapes, _Graph] = {}
        self.captures: Dict[Shapes, Dict[str, Any]] = {}
        self._staged = torch.cuda.Event()  # the last call's host-to-device copy

    def __call__(self, params, cache, *inputs: torch.Tensor):
        if params is not self.params or cache is not self.cache:
            raise ValueError("captured step called with parameters or a cache other than the ones it was captured on")
        key = tuple(tuple(t.shape) for t in inputs)
        g = self._graphs.get(key)
        if g is None:
            if key not in self.shapes:
                raise ValueError(f"captured step called with input shapes {key}; it captures {sorted(self.shapes)}")
            out = self._first_call(key, inputs)
        else:
            self._stage(g, inputs)
            g.graph.replay()
            _add_counts(g.launches)
            out = g.out
        return out, cache

    def _stage(self, g: _Graph, inputs) -> None:
        """The inputs into the pinned buffer, then one asynchronous copy to
        the static device buffer, on the current stream ahead of the
        replay."""
        for t, h in zip(inputs, g.host_inputs):
            if t.dtype != h.dtype:
                raise TypeError(f"captured step input is {t.dtype}, it was captured with {h.dtype}")
        self._staged.synchronize()  # the pinned buffer's last copy has left
        for t, h in zip(inputs, g.host_inputs):
            h.copy_(t)
        g.device_buf.copy_(g.pinned, non_blocking=True)
        self._staged.record()

    def _first_call(self, key: Shapes, example):
        """The step run eagerly on the capture stream, then captured; the
        eager step's outputs are the call's."""
        dev = self.device
        offsets, size = [], 0
        for t in example:
            offsets.append(size)
            size += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        device_buf = torch.empty(max(size, _ALIGN), dtype=torch.uint8, device=dev)
        pinned = torch.empty(max(size, _ALIGN), dtype=torch.uint8, pin_memory=True)

        def views(buf):
            return [buf[o:o + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
                    for o, t in zip(offsets, example)]

        inputs, host_inputs = views(device_buf), views(pinned)
        for t, h in zip(example, host_inputs):
            h.copy_(t)
        device_buf.copy_(pinned)
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), torch.no_grad():
            out = self.fn(self.params, self.cache, *inputs)[0]
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # what the pool reserves below is the graph's alone
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.no_grad(), torch.cuda.graph(graph, pool=self.pool, stream=stream):
                captured = self.fn(self.params, self.cache, *inputs)[0]
        finally:
            launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
            _add_counts(launches, -1)  # the capture launched nothing
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.captures[key] = {"seconds": time.perf_counter() - t0,
                              "reserved_bytes": torch.cuda.memory_reserved(dev) - reserved,
                              "launches": {f"{fn.__name__}.{nm}": n for (fn, nm), n in launches.items()}}
        self._graphs[key] = _Graph(graph, host_inputs, device_buf, pinned, captured, launches)
        return out


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []
