"""The streaming flow step captured once as a CUDA graph and replayed.

Counterpart of ``jax.jit`` over ``tpuflow.flow.lucas_kanade_pyramidal_step``
(the reference jits its stream, ``bench.py:100-125``,
``tpuflow/eval/profile.py:76-84``): the fast path's step
(``backend="cuda"``) has no host read and the same launches every frame
(``flow.pyramidal``), so it is captured once per (config, shape, device)
and each frame is one graph replay instead of ~150-210 launches from
Python.

``GraphedStream`` holds the stream's state on the card: the frame goes in
by a device-to-device copy into the graph's static frame, the previous
frame's pyramid (the carry) is updated in place by a copy captured in the
graph, and ``u``, ``v`` come back as tensors the caller owns. The kernels'
``launch_counts`` are Python counters that the wrappers increment, which a
replay never calls: the capture records what it launched, and each replay
adds one to the graph's ``kernels.ReplayCounter``. The capture also counts
the graph's nodes by type through the driver API (``graph_nodes``), a
stream's ``nodes``. A step's host work is timed by two spans used back to
back (``telemetry``): ``tpuflow_torch.flow.replay`` (the frame copy, the
replay's launch and its count) and ``tpuflow_torch.flow.clone`` (the two
output clones).

A graph replays the kernel wrappers that were bound when it was captured
(``bound_kernels``): ``GraphedStream.step`` raises where another is bound
now, and the VO front end captures its step again.

CUDA tensors only: a CPU tensor raises (the CPU runs the eager driver,
``lucas_kanade_pyramidal_step``). A capture that fails raises; there is no
fallback to the eager step.

``TiledGraphedStream`` is the same for the tiled flow over an NCCL mesh
(the reference jits ``tpuflow.sharding.tiled_lucas_kanade_pyramidal``'s
``shard_map`` step): the device-controlled step (``sharding.
tiled_pyramidal``, ``backend="cuda"``) issues the same launches and the
same collectives every pair, so every rank captures one step, its halo
exchanges, all-reduces and the final gather included, and each pair is
one replay a rank. Every rank of the mesh must construct the stream and
step it with the same frames, as with the eager call. A gloo mesh stages
its collectives through host memory and is never graphed: it raises, as a
CPU tensor does. Its graph holds the mesh's NCCL communicators, so it is
freed before the mesh's groups are destroyed: ``sharding.release_mesh``
closes every such stream (``close``), and the VO front end's graphs too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpuflow_torch import telemetry
from tpuflow_torch.core import ops
from tpuflow_torch.core.config import PyramidConfig
from tpuflow_torch.flow import pyramidal
from tpuflow_torch.kernels import (ReplayCounter, _build, add_launch_counts, launch_counts, lk,
                                   seed, torch_ref, warp)

WARMUP_STEPS = 2  # eager steps on a side stream before the capture
# The driver API's CUgraphNodeType, by value.
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
              "event_record", "ext_semas_signal", "ext_semas_wait", "mem_alloc", "mem_free",
              "batch_mem_op", "conditional")
_STEP = telemetry.chain("tpuflow_torch.flow.replay", "tpuflow_torch.flow.clone")


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must lie on a CUDA device for a CUDA graph, not {t.device}; "
                         "the eager step runs elsewhere")


def bound_kernels() -> tuple:
    """The kernel wrappers the fast path's steps call, as bound now: the
    flow's rounds (the tiled path's K6 round too) and the VO front end's
    gated seed."""
    return warp.warp_round, lk.refine_round, lk.fused_tile_round, seed.seed_grid


def same_kernels(captured: tuple) -> bool:
    """Whether the wrappers bound now are the ones ``captured``."""
    return all(a is b for a, b in zip(captured, bound_kernels()))


def graph_nodes(graph: torch.cuda.CUDAGraph) -> dict[str, int]:
    """The nodes of a graph captured with ``keep_graph=True``, by type
    (``NODE_TYPES``), those of its child graphs included, read through the
    driver API (``cuGraphGetNodes``, ``cuGraphNodeGetType``)."""
    driver = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.c_void_p
    for fn, args in ((driver.cuGraphGetNodes, [ptr, ptr, ctypes.POINTER(ctypes.c_size_t)]),
                     (driver.cuGraphNodeGetType, [ptr, ctypes.POINTER(ctypes.c_int)]),
                     (driver.cuGraphChildGraphNodeGetGraph, [ptr, ctypes.POINTER(ptr)])):
        fn.argtypes, fn.restype = args, ctypes.c_int

    def call(fn, *args) -> None:
        status = fn(*args)
        if status != 0:
            raise RuntimeError(f"{fn.__name__} failed with CUresult {status}")

    counts: dict[str, int] = {}

    def walk(handle: ctypes.c_void_p) -> None:
        n = ctypes.c_size_t(0)
        call(driver.cuGraphGetNodes, handle, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        call(driver.cuGraphGetNodes, handle, nodes, ctypes.byref(n))
        for node in nodes:
            kind = ctypes.c_int(-1)
            call(driver.cuGraphNodeGetType, ctypes.c_void_p(node), ctypes.byref(kind))
            name = NODE_TYPES[kind.value] if 0 <= kind.value < len(NODE_TYPES) else str(kind.value)
            counts[name] = counts.get(name, 0) + 1
            if name == "graph":
                child = ctypes.c_void_p()
                call(driver.cuGraphChildGraphNodeGetGraph, ctypes.c_void_p(node),
                     ctypes.byref(child))
                walk(child)

    walk(ctypes.c_void_p(graph.raw_cuda_graph()))
    return counts


class Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    out: object  # body's outputs as captured
    replays: ReplayCounter  # the launches the capture recorded; add one a replay
    kernels: tuple  # the wrappers it captured (``bound_kernels``)
    nodes: dict  # its nodes by type (``graph_nodes``)


def capture(body, stream: torch.cuda.Stream) -> Captured:
    """Warm ``body`` up on ``stream`` (the kernels' library loaded, cuBLAS
    handles and cached operator blocks made there), then capture it once on
    the same stream, count its nodes and instantiate it. The launches the
    capture recorded are taken back off the counters (a capture runs
    nothing) and counted again a replay through ``Captured.replays``."""
    _build.load()
    ops.pin_f32_matmul()  # TF32 off around the captured cuBLAS matmuls
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        for _ in range(WARMUP_STEPS):
            body()
    torch.cuda.current_stream(stream.device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    kernels = bound_kernels()
    before = launch_counts()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        out = body()
    after = launch_counts()
    recorded = {name: n - before[name] for name, n in after.items() if n != before[name]}
    add_launch_counts({name: -n for name, n in recorded.items()})
    nodes = graph_nodes(graph)
    graph.instantiate()
    return Captured(graph, out, ReplayCounter(recorded), kernels, nodes)


class _Replayed:
    """What both streams share: the parts of their capture and the step's
    replay, once the frame is checked."""

    def _take(self, captured: Captured) -> None:
        self._graph, self._replays, self._kernels = (captured.graph, captured.replays,
                                                     captured.kernels)
        self._u, self._v, self.level_rounds = captured.out
        self.launches = captured.replays.launches  # a replay's launches by kernel
        self.nodes = captured.nodes

    def _replay(self, frame: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with _STEP as spans:
            self._frame.copy_(frame)
            self._graph.replay()
            self._replays.replays += 1
            spans.next()  # the clones start
            return self._u.clone(), self._v.clone()


class GraphedStream(_Replayed):
    """A pyramidal flow stream on the card, one graph replay a frame.

    ``carry`` seeds the stream: the previous frame's Gaussian pyramid,
    coarse to fine (``torch_ref.build_gaussian_pyramid``), or a frame, whose
    pyramid is built. The step is captured at construction for the carry's
    shape, ``cfg`` and device. ``step(frame)`` returns the flow from the
    carry to ``frame`` and makes ``frame``'s pyramid the carry.
    ``level_rounds`` is the graph's int32 (levels,) tensor of the rounds
    each level ran in the latest step (overwritten by the next replay).
    ``launches`` holds the port's kernel launches a replay, ``nodes`` the
    captured graph's nodes by type (``graph_nodes``).

    A (B, H, W) carry and frames are B independent streams (cameras) in one
    capture and one replay a step: each element takes its own band and
    latch at every level and its flow is its own 2-D stream's bit for bit;
    ``level_rounds`` is then (B, levels), and ``reset`` seeds every
    element's carry at once."""

    def __init__(self, carry, cfg: PyramidConfig) -> None:
        if isinstance(carry, torch.Tensor):
            _check_cuda(carry, "the first frame")
            carry = torch_ref.build_gaussian_pyramid(carry.to(torch.float32), cfg.levels,
                                                     cfg.scale_factor)
        for level in carry:
            _check_cuda(level, "the carry")
        self.cfg = cfg
        self.shape = tuple(carry[-1].shape)
        self.device = carry[-1].device
        self._carry = [torch.zeros_like(level, dtype=torch.float32) for level in carry]
        self._frame = torch.zeros(self.shape, dtype=torch.float32, device=self.device)

        def body():
            u, v, pyr = pyramidal.lucas_kanade_pyramidal_step(self._carry, self._frame, cfg,
                                                              backend="cuda")
            rounds = pyramidal.counters.level_rounds
            for dst, src in zip(self._carry, pyr):
                dst.copy_(src)
            return u, v, rounds

        self._take(capture(body, torch.cuda.Stream(self.device)))
        self.reset(carry)

    def reset(self, carry) -> None:
        """Seed the stream anew with a pyramid of the captured shapes."""
        if len(carry) != len(self._carry):
            raise ValueError(f"the carry needs {len(self._carry)} levels, got {len(carry)}")
        for dst, src in zip(self._carry, carry):
            if src.shape != dst.shape:
                raise ValueError(f"carry level {tuple(src.shape)} is not the captured "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

    def step(self, frame: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One frame: ``(u, v)`` from the carry to ``frame``, caller-owned."""
        _check_cuda(frame, "the frame")
        if tuple(frame.shape) != self.shape or frame.device != self.device:
            raise ValueError(f"frame {tuple(frame.shape)} on {frame.device}: the graph was "
                             f"captured for {self.shape} on {self.device}")
        if not same_kernels(self._kernels):
            raise RuntimeError("the kernel wrappers bound now are not the ones the graph "
                               "captured; make a new GraphedStream")
        return self._replay(frame)


def graphable_mesh(mesh) -> bool:
    """Whether a tiled step over ``mesh`` can be captured: an NCCL mesh on
    the card (gloo stages its collectives through host memory)."""
    import torch.distributed as dist

    return mesh.device.type == "cuda" and dist.get_backend(mesh.spatial) == "nccl"


class TiledGraphedStream(_Replayed):
    """The tiled pyramidal flow over an NCCL mesh, one graph replay a frame
    pair on each rank.

    ``first`` is the stream's first global (B, H, W) frame batch on the
    mesh's card, as ``tiled_lucas_kanade_pyramidal`` takes it. The step is
    captured at construction for its shape, ``cfg`` and ``mesh``;
    ``step(frames)`` returns the global (B, H, W) flow from the previous
    batch to ``frames`` and keeps ``frames`` as the next pair's first. ``level_rounds`` is the graph's
    int32 (local batch, levels) tensor of the rounds each level ran in the
    latest step. Raises ``ValueError`` for a CPU tensor or a gloo mesh."""

    def __init__(self, first: torch.Tensor, cfg: PyramidConfig, mesh) -> None:
        from tpuflow_torch.sharding import mesh as mesh_module
        from tpuflow_torch.sharding import tiled_pyramidal

        _check_cuda(first, "the first frame")
        if not graphable_mesh(mesh):
            raise ValueError("a tiled CUDA graph needs an NCCL mesh on the card; a gloo mesh "
                             "stages its collectives through host memory and runs eagerly")
        if first.device != mesh.device:
            raise ValueError(f"the frames lie on {first.device}, the mesh on {mesh.device}")
        if first.ndim != 3:
            raise ValueError(f"frames must be (B, H, W), got {tuple(first.shape)}")
        self.cfg = cfg
        self.mesh = mesh
        self.shape = tuple(first.shape)
        self.device = first.device
        self._prev = first.to(torch.float32).clone()
        self._frame = torch.zeros(self.shape, dtype=torch.float32, device=self.device)

        def body():
            u, v = tiled_pyramidal.tiled_lucas_kanade_pyramidal(
                self._prev, self._frame, mesh, config=cfg, backend="cuda")
            self._prev.copy_(self._frame)
            return u, v, tiled_pyramidal.counters.level_rounds

        saved = self._prev.clone()
        self._take(capture(body, torch.cuda.Stream(self.device)))
        self._prev.copy_(saved)
        mesh_module.hold_graph(mesh, self)

    def close(self) -> None:
        """Free the graph (and the NCCL work it captured) before the mesh's
        groups go (``sharding.release_mesh`` calls it); a later ``step``
        raises."""
        self._graph = None

    def reset(self, first: torch.Tensor) -> None:
        """Start the stream anew at ``first``, a frame of the captured shape."""
        self._check(first)
        self._prev.copy_(first)

    def _check(self, frame: torch.Tensor) -> None:
        _check_cuda(frame, "the frame")
        if tuple(frame.shape) != self.shape or frame.device != self.device:
            raise ValueError(f"frame {tuple(frame.shape)} on {frame.device}: the graph was "
                             f"captured for {self.shape} on {self.device}")

    def step(self, frame: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One pair: the global ``(u, v)`` from the previous frame to
        ``frame``, caller-owned."""
        if self._graph is None:
            raise RuntimeError("the stream was closed (its mesh released)")
        self._check(frame)
        if not same_kernels(self._kernels):
            raise RuntimeError("the kernel wrappers bound now are not the ones the graph "
                               "captured; make a new TiledGraphedStream")
        return self._replay(frame)
