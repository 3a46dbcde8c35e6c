"""The VO front end on the device: dense flow, track advance,
forward-backward culling, loss detection and fixed-slot keyframe
reseeding, with no host read of its own.

Counterpart of ``tpuflow.vo.device_loop``. The reference jits the step
into one device program and ``lax.scan``s chunks of frames. Here ``step``
is eager PyTorch on the frames' device, and ``scan_steps`` replays it as a
CUDA graph on the card (``backend="cuda"``, no mesh or an NCCL mesh): the
step is captured once per frame shape and device for each front end (its
config, fb check, grid and mesh), its ``FrontEndState`` updated in place
inside the graph, and each replay's ``ObsRecord`` copied out. With an
NCCL mesh every rank captures the tiled flow's step, its halo exchanges,
all-reduces and gathers included, and replays it in step with the others
(the tiled path keeps its early exit on the device,
``sharding.tiled_pyramidal``). A step is captured again where the kernel
wrappers bound now are not the ones it captured
(``graphed.bound_kernels``), so a swapped wrapper is never bypassed.
Elsewhere (the CPU, the parity backend, whose flow reads its early exit to
the host, and a gloo mesh, which stages its collectives through host
memory) a chunk is a loop over eager steps.
Two things keep the step free of host reads:

- every shape is static: the track table is fixed-capacity, reseeding
  writes dead slots by mask, the loss log is a fixed-slot write, and new
  landmark ids come from a device counter plus a cumulative sum;
- the keyframe reseed, a ``lax.cond`` in the reference, is gated on the
  device: on the fast path (``backend="cuda"``, CUDA tensors) the seed
  kernel (``kernels.seed``) reads the keyframe predicate from device
  memory and, off a keyframe or with no dead slot, reads no frame and
  seeds no cell. Elsewhere the plain seed runs every step, masked by the
  predicate. Either way ``good`` is gated by the predicate too, so the
  select then writes nothing and mints no id, bit-identical to the cond.
  Each taken branch adds 1 to ``pyramidal.counters.reseeds(device)``.

The fast path's flow (``flow.pyramidal``, ``backend="cuda"``) keeps its
early exit and band on the device too; the parity path's flow reads them
to the host, and those reads are counted in ``pyramidal.counters``.

The previous frame is carried as its Gaussian pyramid, coarse to fine:
each frame's pyramid is built once and serves as the current pair's
"curr", the next pair's "prev" and the backward check's flow. With a
``mesh`` the dense flow runs tiled over the mesh's ranks
(``sharding.tiled_pyramidal``), which builds its pyramids from the raw
frames itself, so the carry is the raw frame alone.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpuflow_torch.core.config import PyramidConfig
from tpuflow_torch.flow import graphed, pyramidal
from tpuflow_torch.flow.pyramidal import lucas_kanade_pyramidal_from_pyramids
from tpuflow_torch.flow.single_scale import BACKENDS
from tpuflow_torch.kernels import seed, torch_ref
from tpuflow_torch.sharding.tiled_pyramidal import tiled_lucas_kanade_pyramidal
from tpuflow_torch.vo import tracking

# Fixed capacity of the tracking-loss event log. Loss events are rare (one
# per contiguous outage); beyond the cap they are counted, not logged.
LOSS_LOG_CAP = 64


class FrontEndState(NamedTuple):
    """Device-resident tracking state."""

    carry: tuple          # previous frame's pyramid, coarse to fine (with a mesh: the frame)
    xy: torch.Tensor          # (N, 2) f32 current track positions
    start_xy: torch.Tensor    # (N, 2) f32 spawn positions
    age: torch.Tensor         # (N,) i32
    alive: torch.Tensor       # (N,) bool
    track_lm: torch.Tensor    # (N,) i32 landmark id per slot
    n_landmarks: torch.Tensor  # () i32 landmark id counter
    frame_index: torch.Tensor  # () i32
    max_alive: torch.Tensor    # () i32 session peak alive count
    tracking_lost: torch.Tensor  # () bool
    loss_frames: torch.Tensor  # (LOSS_LOG_CAP,) i32, -1-filled event log
    loss_count: torch.Tensor   # () i32


class ObsRecord(NamedTuple):
    """One keyframe's observation snapshot (device tensors)."""

    xy: torch.Tensor          # (N, 2) f32
    lm: torch.Tensor          # (N,) i32
    alive: torch.Tensor       # (N,) bool
    n_landmarks: torch.Tensor  # () i32 counter after this keyframe's reseed


def _tensors(state: FrontEndState) -> list[torch.Tensor]:
    """The state's tensors, the carry's levels first."""
    return [*state.carry, *state[1:]]


def _copy_state(dst: FrontEndState, src: FrontEndState) -> None:
    for d, t in zip(_tensors(dst), _tensors(src)):
        d.copy_(t)


def _clone_state(state: FrontEndState) -> FrontEndState:
    return FrontEndState(tuple(t.clone() for t in state.carry), *(t.clone() for t in state[1:]))


class _GraphedStep:
    """A front end's step captured once as a CUDA graph for one frame
    shape and device: the static state is advanced in place by copies
    captured in the graph, the frame goes in by a device-to-device copy,
    and each replay's ObsRecord is copied out."""

    def __init__(self, fe: FrontEnd, state: FrontEndState, frame: torch.Tensor) -> None:
        self._state = _clone_state(state)
        self._frame = torch.zeros(frame.shape, dtype=torch.float32, device=frame.device)

        def body():
            new_state, obs = fe.step(self._state, self._frame)
            _copy_state(self._state, new_state)
            return obs

        captured = graphed.capture(body, torch.cuda.Stream(frame.device))
        self._graph, self._obs, self._replays, self.kernels, self.nodes = captured
        self.launches = self._replays.launches
        if fe.mesh is not None:
            from tpuflow_torch.sharding import mesh as mesh_module

            mesh_module.hold_graph(fe.mesh, self)

    def close(self) -> None:
        """Free the graph before the mesh's groups go
        (``sharding.release_mesh``); a later ``run`` raises."""
        self._graph = None

    def run(self, state: FrontEndState, frames: torch.Tensor
            ) -> tuple[FrontEndState, ObsRecord]:
        """Step through a (T, H, W) chunk from ``state``; returns the final
        state and the T ObsRecords stacked, all caller-owned."""
        if self._graph is None:
            raise RuntimeError("the front end's graph was closed (its mesh released)")
        _copy_state(self._state, state)
        t = frames.shape[0]
        out = ObsRecord(*(torch.empty((t, *f.shape), dtype=f.dtype, device=f.device)
                          for f in self._obs))
        for i in range(t):
            self._frame.copy_(frames[i])
            self._graph.replay()
            self._replays.replays += 1
            for dst, src in zip(out, self._obs):
                dst[i].copy_(src)
        return _clone_state(self._state), out


def _check_frame(frame) -> torch.Tensor:
    if not isinstance(frame, torch.Tensor):
        raise TypeError(
            f"frames must be torch tensors on the session's device, got {type(frame).__name__}"
        )
    return frame.to(torch.float32)


class FrontEnd:
    """The init/step/chunk functions of one front-end configuration.

    ``mesh``: an optional ``sharding.FlowMesh``; the front end's dense flow
    then runs tiled over its ranks, with the fast path's saturation
    (``rtl_clamp``). Every rank of the mesh runs the same front end on
    the same frames.

    8-bit input contract: with ``config.warp_packed_u8`` (``production``)
    under ``backend="cuda"``, frames carry integer values in [0, 255].
    """

    def __init__(
        self,
        grid_step: int = 16,
        keyframe_stride: int = 1,
        fb_check_threshold: float | None = None,
        backend: str = "torch",
        mesh=None,
        config: PyramidConfig | None = None,
        rtl_clamp: bool = False,
    ) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.grid_step = int(grid_step)
        self.keyframe_stride = int(keyframe_stride)
        self.fb_check_threshold = (
            None if fb_check_threshold is None else float(fb_check_threshold)
        )
        self.backend = backend
        self.mesh = mesh
        # The fast path's saturation for the untiled flow (the tiled flow
        # always clamps): a mesh-tiled session's untiled counterpart.
        self.rtl_clamp = bool(rtl_clamp)
        self.config = config or PyramidConfig(levels=3, window_size=5, iterations=3)
        # The border stripe where the dense flow is unreliable (warp fill,
        # window support and the fast path's clamp meet there).
        self.stripe = self.config.max_disp + self.config.window_size
        # scan_steps' captured steps, by (frame shape, device): one each,
        # replaced where the kernel wrappers have changed since its capture.
        self._graphs: dict[tuple, _GraphedStep] = {}

    def margin_for(self, h: int, w: int, for_cull: bool = True) -> int:
        """Seed/cull border margin for a frame shape: the full stripe where
        it costs little field of view (min(h, w) >= 16x the stripe), else
        cull margin 3 and seed margin 0, as the reference measured."""
        if min(h, w) >= 16 * self.stripe:
            return self.stripe
        return 3 if for_cull else 0

    def carry_of_frame(self, frame: torch.Tensor) -> tuple:
        if self.mesh is not None:
            return (frame,)
        cfg = self.config
        return tuple(torch_ref.build_gaussian_pyramid(frame, cfg.levels, cfg.scale_factor))

    def _flow(self, carry_prev, carry_curr):
        if self.mesh is not None:
            u, v = tiled_lucas_kanade_pyramidal(
                carry_prev[0][None], carry_curr[0][None], self.mesh,
                config=self.config, backend=self.backend,
            )
            return u[0], v[0]
        return lucas_kanade_pyramidal_from_pyramids(
            carry_prev, carry_curr, self.config, backend=self.backend,
            rtl_clamp=self.rtl_clamp,
        )

    def _seed(self, frame: torch.Tensor, predicate: torch.Tensor | None = None,
              taken: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """The grid seed of ``frame`` at the seed margin, (xy, alive): the
        kernel's wrapper on the fast path (the kernel for CUDA tensors),
        the plain version elsewhere, both gated on ``predicate``."""
        fn = seed.seed_grid if self.backend == "cuda" else seed.seed_grid_ref
        return fn(frame, self.grid_step, margin=self.margin_for(*frame.shape, for_cull=False),
                  predicate=predicate, taken=taken)

    def init(self, frame: torch.Tensor) -> tuple[FrontEndState, ObsRecord]:
        """Seed on the first frame; the returned ObsRecord is keyframe 0.
        Every slot gets a landmark id, dead seeds included."""
        frame = _check_frame(frame)
        dev = frame.device
        t = tracking.tracks_at(*self._seed(frame))
        n = t.xy.shape[0]
        lm = torch.arange(n, dtype=torch.int32, device=dev)
        n_lm = torch.full((), n, dtype=torch.int32, device=dev)

        def scalar(value, dtype=torch.int32):
            return torch.full((), value, dtype=dtype, device=dev)

        state = FrontEndState(
            carry=self.carry_of_frame(frame),
            xy=t.xy,
            start_xy=t.start_xy,
            age=t.age,
            alive=t.alive,
            track_lm=lm,
            n_landmarks=n_lm,
            frame_index=scalar(0),
            max_alive=scalar(0),
            tracking_lost=scalar(False, torch.bool),
            loss_frames=torch.full((LOSS_LOG_CAP,), -1, dtype=torch.int32, device=dev),
            loss_count=scalar(0),
        )
        return state, ObsRecord(xy=t.xy, lm=lm, alive=t.alive, n_landmarks=n_lm)

    def step(
        self, state: FrontEndState, frame: torch.Tensor
    ) -> tuple[FrontEndState, ObsRecord]:
        """One tracking step. The ObsRecord comes back every step; only a
        keyframe's (frame_index % keyframe_stride == 0, which the host
        knows) is meant to be kept."""
        frame = _check_frame(frame)
        h, w = frame.shape
        carry_curr = self.carry_of_frame(frame)
        u, v = self._flow(state.carry, carry_curr)
        prev_xy = state.xy
        t = tracking.advance(
            tracking.Tracks(state.xy, state.start_xy, state.age, state.alive),
            u, v, margin=self.margin_for(h, w),
        )
        if self.fb_check_threshold is not None:
            ub, vb = self._flow(carry_curr, state.carry)
            t = tracking.forward_backward_check(
                t, prev_xy, ub, vb, threshold=self.fb_check_threshold
            )

        fi = state.frame_index + 1

        # Loss relative to the session's peak alive count (integer form of
        # alive_now < 0.25 * max_alive); the log write is a masked select.
        alive_now = t.alive.sum().to(torch.int32)
        max_alive = torch.maximum(state.max_alive, alive_now)
        lost = (max_alive > 0) & (alive_now * 4 < max_alive)
        newly_lost = lost & ~state.tracking_lost
        write = newly_lost & (state.loss_count < LOSS_LOG_CAP)
        slot = state.loss_count.clamp(max=LOSS_LOG_CAP - 1)
        at_slot = torch.arange(LOSS_LOG_CAP, device=frame.device) == slot
        loss_frames = torch.where(at_slot & write, fi, state.loss_frames)
        loss_count = state.loss_count + newly_lost.to(torch.int32)

        # Keyframe reseed of the dead slots with fresh corners and new ids
        # from the device counter (ascending in slot order). The reference
        # skips the branch off a keyframe or with no dead slot; here the
        # seed kernel reads the same predicate on the device and then seeds
        # nothing (the plain seed runs and is masked). The predicate also
        # gates ``good``, so the selects below are then no-ops.
        is_kf = ((fi % self.keyframe_stride) == 0) & (~t.alive).any()
        fresh_xy, fresh_alive = self._seed(frame, is_kf, pyramidal.counters.reseeds(frame.device))
        good = fresh_alive & ~t.alive & is_kf
        new_ids = (
            state.n_landmarks + torch.cumsum(good.to(torch.int32), 0, dtype=torch.int32) - 1
        )
        xy = torch.where(good[:, None], fresh_xy, t.xy)
        start = torch.where(good[:, None], fresh_xy, t.start_xy)
        age = torch.where(good, 0, t.age)
        alive = t.alive | good
        lm = torch.where(good, new_ids, state.track_lm)
        n_lm = state.n_landmarks + good.sum().to(torch.int32)

        new_state = FrontEndState(
            carry=carry_curr,
            xy=xy, start_xy=start, age=age, alive=alive,
            track_lm=lm, n_landmarks=n_lm,
            frame_index=fi,
            max_alive=max_alive,
            tracking_lost=lost,
            loss_frames=loss_frames,
            loss_count=loss_count,
        )
        return new_state, ObsRecord(xy=xy, lm=lm, alive=alive, n_landmarks=n_lm)

    def graphed(self, frames: torch.Tensor) -> bool:
        """Whether ``scan_steps`` replays a CUDA graph for these frames: the
        fast path on the card, with no mesh or an NCCL mesh."""
        return (self.backend == "cuda" and frames.device.type == "cuda"
                and (self.mesh is None or graphed.graphable_mesh(self.mesh)))

    def scan_steps(
        self, state: FrontEndState, frames: torch.Tensor
    ) -> tuple[FrontEndState, ObsRecord]:
        """Step through a (T, H, W) chunk that is already on the device.
        Returns the final state and the T ObsRecords stacked. On the card
        (see ``graphed``) each step is one replay of the step captured at
        the first chunk of this shape, or at the first since the kernel
        wrappers were swapped; the same bits as ``step``."""
        if self.graphed(frames):
            key = (tuple(frames.shape[1:]), frames.device)
            captured = self._graphs.get(key)
            if captured is None or not graphed.same_kernels(captured.kernels):
                self._graphs.pop(key, None)  # its memory pool goes with it
                self._graphs[key] = _GraphedStep(self, state, frames[0])
            return self._graphs[key].run(state, frames)
        records = []
        for frame in frames:
            state, obs = self.step(state, frame)
            records.append(obs)
        return state, ObsRecord(*(torch.stack(field) for field in zip(*records)))


@functools.lru_cache(maxsize=None)
def _shared_front_end(
    grid_step: int,
    keyframe_stride: int,
    fb_check_threshold: float | None,
    backend: str,
    config: PyramidConfig | None = None,
) -> FrontEnd:
    """Sessions with the same settings share one FrontEnd, its configuration
    and its captured steps (``PyramidConfig`` is frozen and hashes; a
    captured step holds no session's state between chunks)."""
    return FrontEnd(
        grid_step=grid_step,
        keyframe_stride=keyframe_stride,
        fb_check_threshold=fb_check_threshold,
        backend=backend,
        config=config,
    )


def get_front_end(
    grid_step: int,
    keyframe_stride: int,
    fb_check_threshold: float | None,
    backend: str,
    mesh=None,
    config: PyramidConfig | None = None,
) -> FrontEnd:
    if mesh is not None:
        # A mesh holds process groups: no sharing through the cache.
        return FrontEnd(
            grid_step=grid_step, keyframe_stride=keyframe_stride,
            fb_check_threshold=fb_check_threshold, backend=backend, mesh=mesh, config=config,
        )
    return _shared_front_end(grid_step, keyframe_stride, fb_check_threshold, backend, config)
