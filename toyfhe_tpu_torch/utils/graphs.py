"""The port's ``jax.jit``: a function of the engine's pytrees, captured
once into a CUDA graph and replayed with one launch.

The reference compiles every unit of its serving path into one XLA program
(the steps, each layer, the BSGS dense layers, the exhaust and the whole
refresh). On Hopper the counterpart of such a program is a CUDA graph:
:func:`jit` records the kernel sequence of one call and replays it.

Ciphertexts, keys, ring elements and the bootstrap context are pytrees
(``torch.utils._pytree``; registered beside each class in ``core/``), with
the reference's split into tensor leaves and static metadata (params,
rings, the exact ``Fraction`` scale tags, Galois elements, the refresh's
plan). A compiled function keeps one graph per (tree structure with its
static metadata, leaf shapes, strides, dtypes and devices, the other
leaves' values): the host-side scale algebra runs only at capture, which
is correct because it depends on that metadata alone.

On CUDA inputs, the first call of a key

1. copies the tensor leaves into private input buffers;
2. calls the function once eagerly on a side stream (the warm-up), which
   fills every host-built cache of the path: ring tables, index and
   constant tensors (``ops.modmath.const``), the kernels' argument caches,
   the encoded plaintexts of ``encode_cache`` and the library loads;
3. captures a second call into a ``torch.cuda.CUDAGraph`` on the function's
   memory pool (:class:`Pool`; a pipeline's stages share one), with
   ``torch.cuda.set_sync_debug_mode("error")`` on.

Both calls see fresh objects unflattened from the input buffers, never the
caller's own. Each call then copies every tensor leaf into the input
buffers, replays, and returns the outputs, cloned out of the pool, under
the structure and metadata recorded at capture: a result the caller keeps
is never overwritten by the next replay.

A ``torch.Generator`` leaf is keyed by its device alone, so every generator
of the card shares one graph. The graph draws from a generator of its own,
registered with it at capture; the warm-up draws from a copy of the
caller's state, so neither call moves the caller's generator. Each replay
copies the caller's state (seed and offset, host values) into the graph's
generator, replays, and copies the advanced state back: a replay draws what
the eager call on that state draws, bit for bit, and advances the caller's
generator as far, so two calls draw fresh numbers.

A replay runs no Python, so the port's call-time counters (the kernels'
``launches`` and ``transforms``, ``rlwe.hoist_counts``,
``metrics.counters``) would not move: the capture's increments are taken
back and added again on every replay, and a census reads the same eager
and compiled. What a replay really launches is read from the graph itself:
each captured graph is kept beside its instantiation (``keep_graph``), and
``Pool.graphs[i].kernel_names()`` lists its kernel nodes through the CUDA
graph API of ``libcuda`` (``_Graph.replays`` counts its replays).

Under a running ``torch.profiler`` each call is a ``toyfhe.stage.<name>``
span (:func:`.metrics.span`) holding a ``toyfhe.capture`` span where it
captures and, around a replay, ``toyfhe.replay.inputs`` (the input copies
and the generator states), ``toyfhe.replay.launch`` (the graph's launch)
and ``toyfhe.replay.outputs`` (the counters, the output clones and the
unflatten). A call that runs inline inside another's body opens none.

On CPU inputs :func:`jit` calls the function eagerly: that is the plain
version the CPU tests run. On CUDA inputs it captures or raises
(:class:`CaptureError`): a failed capture, a sync or an upload of host data
inside the capture, or a sharded (mesh) argument never falls back to the
eager call. A compiled function called while another is warming up or
capturing runs inline, as a nested ``jax.jit`` does.

Everything a graph reads stays alive and in place while it exists: the
input buffers and pool are the function's, the keys and constants it
closes over belong to its caller (an ``nn.Module`` drops its graphs when it
is moved).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from .metrics import span

__all__ = ["CaptureError", "Pool", "jit", "capturing", "counters", "trace", "tracing"]


class CaptureError(RuntimeError):
    """A function could not be captured into a CUDA graph."""


_local = threading.local()


def tracing() -> bool:
    """True while a compiled function's body runs to be recorded (its
    warm-up or its capture, on the card; or inside :func:`trace`)."""
    return getattr(_local, "depth", 0) > 0


@contextlib.contextmanager
def trace():
    """Run the block as a warm-up or capture runs: constants that a graph
    would read are kept (``core.ring.scalar_mul``), and compiled functions
    called inside run inline."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def capturing() -> bool:
    """True while the current CUDA stream is being captured."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def counters() -> List[Dict[str, int]]:
    """The port's call-time counters, read where they live (a caller may
    reset them in place at any time)."""
    from ..core import rlwe
    from ..ops import (fbc_cuda, hybrid_ks_cuda, keyprod_cuda, ntt_cuda, ntt_mxu_pallas_cuda,
                       ntt_pallas_cuda, pallas_keyswitch_cuda)
    from . import metrics
    return [ntt_cuda.launches, ntt_cuda.transforms, hybrid_ks_cuda.launches,
            ntt_pallas_cuda.launches, ntt_pallas_cuda.polymul_launches,
            pallas_keyswitch_cuda.launches, ntt_mxu_pallas_cuda.launches,
            rlwe.hoist_counts, metrics.counters, fbc_cuda.launches, keyprod_cuda.launches]


def _snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in counters()]


def _restore(snap: List[Dict[str, int]]) -> None:
    for c, s in zip(counters(), snap):
        c.clear()
        c.update(s)


class Pool:
    """A CUDA-graph memory pool and its capture stream (made at the first
    capture). Captures in one pool share memory, so graphs that run in
    turn, as a pipeline's stages do, may share one. Keeps each capture's
    record: ``captures`` holds
    dicts of ``name``, ``capture_ms`` (the traced call) and
    ``instantiate_ms`` (ending the capture and instantiating the graph);
    ``graphs`` holds the graphs themselves, in the same order."""

    def __init__(self):
        self._handle = self._stream = None
        self.captures: List[dict] = []
        self.graphs: List["_Graph"] = []

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def stream(self) -> "torch.cuda.Stream":
        """The side stream every warm-up and capture of the pool runs on
        (one stream, so that the captures reuse each other's freed
        memory)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        return self._stream

    def mib(self) -> float:
        """MiB of device memory the pool's segments hold now."""
        if self._handle is None:
            return 0.0
        want = tuple(self._handle)
        segs = torch.cuda.memory_snapshot()
        return sum(s["total_size"] for s in segs
                   if tuple(s.get("segment_pool_id", ())) == want) / 2 ** 20


def _check_leaf(x) -> None:
    from ..parallel.sharding import Mesh
    from ..parallel.layers import MeshPlacement
    if isinstance(x, (Mesh, MeshPlacement)):
        raise CaptureError("a sharded path stays eager: its collectives cannot be captured")


def _leaf_key(x, i: int, gens: dict):
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), x.stride(), x.dtype, x.device)
    if isinstance(x, torch.Generator):
        # the device, and which earlier generator leaf is the same object
        return ("g", x.device, gens.setdefault(id(x), i))
    _check_leaf(x)
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"jit takes tensors, generators and hashable static values, "
                        f"got {type(x).__name__}") from None
    return ("s", type(x), x)


def _copy_generator(gen: torch.Generator) -> torch.Generator:
    if gen.device.type != "cuda":
        raise CaptureError(f"a generator on {gen.device} cannot be captured with CUDA inputs")
    twin = torch.Generator(device=gen.device)
    twin.set_state(gen.get_state())
    return twin


_CU: list = []


def _libcuda():
    """``libcuda`` (loaded at the first use)."""
    if not _CU:
        import ctypes
        _CU.append(ctypes.CDLL("libcuda.so.1"))
    return _CU[0]


def _kernel_nodes(handle: int) -> List[str]:
    """The names, mangled as ``libcuda`` holds them, of the kernel nodes of
    the ``cudaGraph_t`` ``handle``."""
    import ctypes
    cu = _libcuda()

    def ok(res: int, what: str) -> None:
        if res != 0:
            raise RuntimeError(f"{what} failed with CUresult {res}")

    graph, count = ctypes.c_void_p(handle), ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    kind, name = ctypes.c_int(), ctypes.c_char_p()
    params = (ctypes.c_uint8 * 72)()          # CUDA_KERNEL_NODE_PARAMS_v2
    names = []
    for node in nodes:
        node = ctypes.c_void_p(node)
        ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:                   # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        ok(cu.cuGraphKernelNodeGetParams_v2(node, params), "cuGraphKernelNodeGetParams")
        func = ctypes.c_void_p.from_buffer(params, 0).value      # CUfunction func
        if func:
            ok(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)), "cuFuncGetName")
        else:                                                    # CUkernel kern
            kern = ctypes.c_void_p(ctypes.c_void_p.from_buffer(params, 56).value)
            ok(cu.cuKernelGetName(ctypes.byref(name), kern), "cuKernelGetName")
        names.append(name.value.decode())
    return names


class _Graph:
    """One capture: the graph, its input buffers, its generators and its
    output record. ``replays`` counts its replays."""

    def __init__(self, graph, static: list, out_leaves: list, out_spec, deltas, gens: dict):
        self.graph, self.static = graph, static
        self.out_leaves, self.out_spec = out_leaves, out_spec
        self.deltas = deltas
        self.gens = gens                  # first leaf index -> the graph's own generator
        self.replays = 0
        self._kernels: Optional[List[str]] = None

    def kernel_names(self) -> List[str]:
        """The kernels every replay launches: the names (mangled) of the
        captured graph's kernel nodes, read through ``libcuda``."""
        if self._kernels is None:
            self._kernels = _kernel_nodes(self.graph.raw_cuda_graph())
        return self._kernels

    def replay(self, leaves: list):
        with span("toyfhe.replay.inputs"):
            for x, buf in zip(leaves, self.static):
                if isinstance(x, torch.Tensor):
                    buf.copy_(x)
            for i, own in self.gens.items():
                own.set_state(leaves[i].get_state())
        with span("toyfhe.replay.launch"):
            self.graph.replay()
        self.replays += 1
        with span("toyfhe.replay.outputs"):
            for i, own in self.gens.items():
                leaves[i].set_state(own.get_state())
            for c, d in zip(counters(), self.deltas):
                for k, v in d.items():
                    c[k] = c.get(k, 0) + v
            outs = [y.clone() if isinstance(y, torch.Tensor) else y for y in self.out_leaves]
            return pytree.tree_unflatten(outs, self.out_spec)


class Compiled:
    """:func:`jit`'s result: call it as the function."""

    def __init__(self, fn: Callable, pool: Optional[Pool], name: str):
        self.fn = fn
        self.pool = pool if pool is not None else Pool()
        self.name = name
        self.span_name = f"toyfhe.stage.{name}"
        self._graphs: Dict[Any, List[tuple]] = {}

    def __call__(self, *args, **kwargs):
        if tracing():
            return self.fn(*args, **kwargs)
        with span(self.span_name):
            leaves, spec = pytree.tree_flatten((args, kwargs))
            tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
            if not any(t.is_cuda for t in tensors):
                return self.fn(*args, **kwargs)
            if len({t.device for t in tensors}) != 1:
                raise ValueError("jit needs every tensor argument on one CUDA device")
            firsts: dict = {}
            key = tuple(_leaf_key(x, i, firsts) for i, x in enumerate(leaves))
            for got_spec, g in self._graphs.get(key, ()):
                if got_spec == spec:
                    return g.replay(leaves)
            with span("toyfhe.capture"):
                g = self._capture(leaves, spec, tensors[0].device,
                                  sorted(set(firsts.values())))
            self._graphs.setdefault(key, []).append((spec, g))
            return g.replay(leaves)

    def _capture(self, leaves: list, spec, device, gen_at: list) -> _Graph:
        def inputs(gens: dict) -> list:
            # the input buffers, each generator leaf replaced by its stand-in
            first = {id(leaves[i]): i for i in gen_at}
            return [gens[first[id(x)]] if isinstance(x, torch.Generator) else y
                    for x, y in zip(leaves, static)]

        with torch.cuda.device(device):
            static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
            side = self.pool.stream()
            side.wait_stream(torch.cuda.current_stream())
            with trace(), torch.cuda.stream(side):
                a, kw = pytree.tree_unflatten(
                    inputs({i: _copy_generator(leaves[i]) for i in gen_at}), spec)
                self.fn(*a, **kw)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            before = _snapshot()
            graph = torch.cuda.CUDAGraph(keep_graph=True)    # kept for kernel_names
            own = {i: _copy_generator(leaves[i]) for i in gen_at}
            for gen in own.values():
                if not hasattr(graph, "register_generator_state"):
                    raise CaptureError("this torch cannot register a generator with a graph")
                graph.register_generator_state(gen)
            static = inputs(own)
            mode = torch.cuda.get_sync_debug_mode()
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                graph.capture_begin(self.pool.handle())
                try:
                    torch.cuda.set_sync_debug_mode("error")
                    with trace():
                        a, kw = pytree.tree_unflatten(static, spec)
                        out = self.fn(*a, **kw)
                except BaseException as e:
                    torch.cuda.set_sync_debug_mode(mode)
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    _restore(before)
                    raise CaptureError(f"capturing {self.name} failed: {e}") from e
                torch.cuda.set_sync_debug_mode(mode)
                t1 = time.perf_counter()
                graph.capture_end()
                graph.instantiate()
                t2 = time.perf_counter()
            torch.cuda.current_stream().wait_stream(side)
            after = _snapshot()
            _restore(before)
            deltas = [{k: v - b.get(k, 0) for k, v in a_.items() if v != b.get(k, 0)}
                      for a_, b in zip(after, before)]
            out_leaves, out_spec = pytree.tree_flatten(out)
            self.pool.captures.append(dict(name=self.name, capture_ms=(t1 - t0) * 1e3,
                                           instantiate_ms=(t2 - t1) * 1e3))
            g = _Graph(graph, static, out_leaves, out_spec, deltas, own)
            self.pool.graphs.append(g)
            return g


def jit(fn: Callable, *, pool: Optional[Pool] = None, name: Optional[str] = None) -> Compiled:
    """``fn`` compiled: on CUDA inputs each call replays a CUDA graph of
    ``fn`` (captured at the first call of each input structure, after one
    eager warm-up), on CPU inputs ``fn`` runs eagerly (the plain version).
    ``pool`` shares a :class:`Pool` with other compiled functions that run
    in turn. See the module docstring for the contract."""
    return Compiled(fn, pool, name or getattr(fn, "__qualname__", repr(fn)))
