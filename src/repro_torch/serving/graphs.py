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
taken back (the capture launched nothing), and each replay adds it.  Each
graph is kept beside its executable form (host memory only), and
:meth:`CapturedStep.kernel_nodes` lists its kernel nodes by function name,
so that a check can hold the counters' increase to the kernels a replay
really launches (:func:`kernels_by_group` against :func:`counters_by_group`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import re
import tempfile
import time
from collections import Counter
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import lm_head_ce
from repro_torch.kernels.dip_matmul import dip_matmul
from repro_torch.kernels.dip_matmul_q import dip_matmul_q
from repro_torch.kernels.dip_systolic import dip_systolic
from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["CapturedStep", "launch_counts", "kernels_by_group", "counters_by_group"]

_COUNTED = (dip_matmul, dip_matmul_q, dip_systolic, flash_attention, lm_head_ce.lm_head_ce)
_ALIGN = 16
Shapes = Tuple[Tuple[int, ...], ...]

# the kernels a counted wrapper call launches once (a split-K reduce after a
# product belongs to the same call), by function name, in the groups the
# counters can tell apart
_GROUPS = {"dip products": ("dip_mma_kernel", "dip_wgmma_kernel", "dip_matmul_kernel", "dip_mma_s8_kernel",
                            "dip_wgmma_s8_kernel"),
           "quantizing passes": ("quantize_int8_kernel",), "cast passes": ("cast_bf16_kernel",),
           "wavefront": ("dip_systolic_kernel",),
           "flash tensor_cores": ("flash_tc_kernel",), "flash split_kv": ("flash_split_kernel",),
           "flash cuda_cores": ("flash_attention_kernel",), "lm_head_ce": ("lm_head_tc_kernel", "lm_head_f32_kernel")}


def kernels_by_group(names: Dict[str, int]) -> Dict[str, int]:
    """Kernel launches counted by function name (``kernel_nodes``, or a
    profiler's trace), summed into the groups of :func:`counters_by_group`."""
    return {group: sum(names.get(nm, 0) for nm in members) for group, members in _GROUPS.items()}


def counters_by_group(delta: Dict[Tuple[Any, str], int]) -> Dict[str, int]:
    """An increase of the wrappers' counters (keys as ``launch_counts``)
    in the groups of :func:`kernels_by_group`."""
    def d(fn, nm="launches"):
        return delta.get((fn, nm), 0)
    return {"dip products": d(dip_matmul) + d(dip_matmul_q),
            "quantizing passes": d(dip_matmul_q, "launches_quant"),
            "cast passes": d(dip_matmul_q, "launches_cast"),
            "wavefront": d(dip_systolic),
            "flash tensor_cores": d(flash_attention, "launches_tc") - d(flash_attention, "launches_split"),
            "flash split_kv": d(flash_attention, "launches_split"),
            "flash cuda_cores": d(flash_attention) - d(flash_attention, "launches_tc"),
            "lm_head_ce": d(lm_head_ce.lm_head_ce)}


def function_name(symbol: str) -> str:
    """A kernel's own name from its symbol: the last identifier of an
    Itanium-mangled name's (nested) name, before any template arguments
    (``_ZN12_GLOBAL__N_116dip_wgmma_kernelI...`` -> ``dip_wgmma_kernel``);
    an unmangled symbol as it is."""
    if not symbol.startswith("_Z"):
        return symbol
    i, last = 2, symbol
    nested = symbol[i:i + 1] == "N"
    i += nested
    while i < len(symbol) and symbol[i] in "rVK":
        i += 1
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        n = int(symbol[i:j])
        last, i = symbol[j:j + n], j + n
        if not nested or symbol[i:i + 1] in ("I", "E", ""):
            break
    return last


def dot_kernel_nodes(dot: str) -> Counter:
    """The kernel nodes of a ``cuGraphDebugDotPrint`` dump, counted by
    function name: each node statement (``"graph_<g>_node_<n>"[...]``)
    that is a KERNEL node names its function's symbol before its launch
    configuration (``<symbol>\\<\\<\\<grid,block,smem\\>\\>\\>``)."""
    out: Counter = Counter()
    for chunk in re.split(r'"graph_\d+_node_\d+"\s*\[', dot)[1:]:
        if "KERNEL" not in chunk:
            continue
        sym = re.search(r"([A-Za-z_]\w*)\s*\\?<\\?<\\?<", chunk)
        if sym is None:
            raise ValueError(f"a kernel node without a function name: {chunk[:300]!r}")
        out[function_name(sym.group(1))] += 1
    return out


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
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for kernel_nodes
        before = launch_counts()
        try:
            with torch.no_grad(), torch.cuda.graph(graph, pool=self.pool, stream=stream):
                captured = self.fn(self.params, self.cache, *inputs)[0]
        finally:
            launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
            _add_counts(launches, -1)  # the capture launched nothing
        graph.instantiate()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.captures[key] = {"seconds": time.perf_counter() - t0,
                              "reserved_bytes": torch.cuda.memory_reserved(dev) - reserved,
                              "launches": {f"{fn.__name__}.{nm}": n for (fn, nm), n in launches.items()}}
        self._graphs[key] = _Graph(graph, host_inputs, device_buf, pinned, captured, launches)
        return out

    def kernel_nodes(self, key: Shapes) -> Counter:
        """The kernel nodes of the graph captured for the input shapes
        ``key``, counted by function name: the kernels one replay launches."""
        graph = self._graphs[key].graph
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "graph.dot")
            err = ctypes.CDLL("libcuda.so.1").cuGraphDebugDotPrint(
                ctypes.c_void_p(graph.raw_cuda_graph()), path.encode(), ctypes.c_uint(1))  # 1: verbose
            if err:
                raise RuntimeError(f"cuGraphDebugDotPrint failed with CUresult {err}")
            with open(path) as f:
                return dot_kernel_nodes(f.read())


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []
