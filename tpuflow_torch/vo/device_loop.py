"""The VO front end on the device: dense flow, track advance,
forward-backward culling, loss detection and fixed-slot keyframe
reseeding, with no host read of its own.

Counterpart of ``tpuflow.vo.device_loop``. The reference jits the step
into one device program and ``lax.scan``s chunks of frames; here the step
is eager PyTorch on the frames' device, and a chunk is a loop over frames
that are already there. Two things keep it free of host reads:

- every shape is static: the track table is fixed-capacity, reseeding
  writes dead slots by mask, the loss log is a fixed-slot write, and new
  landmark ids come from a device counter plus a cumulative sum;
- the keyframe reseed, a ``lax.cond`` in the reference, is a masked
  select: the fresh corners are always computed and ``good`` is gated by
  the keyframe predicate, so off a keyframe (or with no dead slot) the
  select writes nothing and mints no id. The result is bit-identical to
  the cond in every case.

The flow itself (``flow.pyramidal``) reads its early-exit flag and band
index to the host as the reference's ``lax.while_loop`` / ``lax.switch``
would; those reads are its own and are counted in ``pyramidal.counters``.

The previous frame is carried as its Gaussian pyramid, coarse to fine:
each frame's pyramid is built once and serves as the current pair's
"curr", the next pair's "prev" and the backward check's flow.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpuflow_torch.core.config import PyramidConfig
from tpuflow_torch.flow.pyramidal import lucas_kanade_pyramidal_from_pyramids
from tpuflow_torch.flow.single_scale import BACKENDS
from tpuflow_torch.kernels import torch_ref
from tpuflow_torch.vo import tracking

# Fixed capacity of the tracking-loss event log. Loss events are rare (one
# per contiguous outage); beyond the cap they are counted, not logged.
LOSS_LOG_CAP = 64


class FrontEndState(NamedTuple):
    """Device-resident tracking state."""

    carry: tuple          # previous frame's pyramid, coarse to fine
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


def _check_frame(frame) -> torch.Tensor:
    if not isinstance(frame, torch.Tensor):
        raise TypeError(
            f"frames must be torch tensors on the session's device, got {type(frame).__name__}"
        )
    return frame.to(torch.float32)


class FrontEnd:
    """The init/step/chunk functions of one front-end configuration.

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
        if mesh is not None:
            raise NotImplementedError(
                "a mesh-tiled front end is multi-GPU work, not ported yet "
                "(ROADMAP.md, queue 1 item 9)"
            )
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.grid_step = int(grid_step)
        self.keyframe_stride = int(keyframe_stride)
        self.fb_check_threshold = (
            None if fb_check_threshold is None else float(fb_check_threshold)
        )
        self.backend = backend
        self.rtl_clamp = bool(rtl_clamp)
        self.config = config or PyramidConfig(levels=3, window_size=5, iterations=3)
        # The border stripe where the dense flow is unreliable (warp fill,
        # window support and the fast path's clamp meet there).
        self.stripe = self.config.max_disp + self.config.window_size

    def margin_for(self, h: int, w: int, for_cull: bool = True) -> int:
        """Seed/cull border margin for a frame shape: the full stripe where
        it costs little field of view (min(h, w) >= 16x the stripe), else
        cull margin 3 and seed margin 0, as the reference measured."""
        if min(h, w) >= 16 * self.stripe:
            return self.stripe
        return 3 if for_cull else 0

    def carry_of_frame(self, frame: torch.Tensor) -> tuple:
        cfg = self.config
        return tuple(torch_ref.build_gaussian_pyramid(frame, cfg.levels, cfg.scale_factor))

    def _flow(self, carry_prev, carry_curr):
        return lucas_kanade_pyramidal_from_pyramids(
            carry_prev, carry_curr, self.config, backend=self.backend,
            rtl_clamp=self.rtl_clamp,
        )

    def init(self, frame: torch.Tensor) -> tuple[FrontEndState, ObsRecord]:
        """Seed on the first frame; the returned ObsRecord is keyframe 0.
        Every slot gets a landmark id, dead seeds included."""
        frame = _check_frame(frame)
        dev = frame.device
        t = tracking.seed_grid(
            frame, grid_step=self.grid_step,
            margin=self.margin_for(*frame.shape, for_cull=False),
        )
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
        # same predicate gates ``good``, so the select is then a no-op.
        is_kf = ((fi % self.keyframe_stride) == 0) & (~t.alive).any()
        fresh = tracking.seed_grid(
            frame, grid_step=self.grid_step,
            margin=self.margin_for(h, w, for_cull=False),
        )
        good = fresh.alive & ~t.alive & is_kf
        new_ids = (
            state.n_landmarks + torch.cumsum(good.to(torch.int32), 0, dtype=torch.int32) - 1
        )
        xy = torch.where(good[:, None], fresh.xy, t.xy)
        start = torch.where(good[:, None], fresh.xy, t.start_xy)
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

    def scan_steps(
        self, state: FrontEndState, frames: torch.Tensor
    ) -> tuple[FrontEndState, ObsRecord]:
        """Step through a (T, H, W) chunk that is already on the device.
        Returns the final state and the T ObsRecords stacked."""
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
    """FrontEnds hold only their configuration, so sessions with the same
    settings share one (``PyramidConfig`` is frozen and hashes)."""
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
        return FrontEnd(mesh=mesh)  # raises: the tiled front end is not ported
    return _shared_front_end(grid_step, keyframe_stride, fb_check_threshold, backend, config)
