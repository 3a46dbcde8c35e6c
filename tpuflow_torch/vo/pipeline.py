"""Incremental visual odometry: frames -> dense flow -> feature tracks ->
keyframe observations -> bundle-adjusted trajectory.

Counterpart of ``tpuflow.vo.pipeline``'s incremental path:
``OdometrySession`` (``start``, ``process_frame``, ``process_frames``,
``solve``) and ``run_odometry``. Monocular: the trajectory is recovered up
to the 7-DOF gauge; landmarks start at their first observation
back-projected to ``init_depth``, and camera 0 is pinned.

The session runs on ``device``: the card unless the caller names another
(``device="cpu"``); without a card the default raises. The front end
(``device_loop.FrontEnd``) keeps its state there, and each keyframe's
observation record stays there until the back end needs it; ``_drain``
then brings every pending record to the host in one copy.

Not in this slice: ``compact`` (and the anchors it leaves for ``solve``),
``state_dict`` / ``meta_dict`` / ``from_state``, the chunked pipeline with
loop closure and the visual-inertial path (ROADMAP.md, queue 1 items 6-7).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from tpuflow_torch.core.config import PYRAMID_CONFIGS
from tpuflow_torch.eval.timing import resolve_device
from tpuflow_torch.vo import ba, device_loop, epipolar, tracking


@dataclasses.dataclass
class OdometryResult:
    poses_r: np.ndarray      # (K, 3, 3) keyframe rotations
    poses_t: np.ndarray      # (K, 3) keyframe translations
    landmarks: np.ndarray    # (M, 3)
    keyframe_indices: list[int]
    track_count: int
    mean_reprojection_error: float
    # Frames where tracking was lost (alive count below a quarter of the
    # session's peak). Segments separated by a loss are not metrically
    # connected. Empty = continuous tracking.
    track_loss_frames: list[int] = dataclasses.field(default_factory=list)


class OdometrySession:
    """Incremental VO: feed frames one at a time or in chunks, solve any
    time.

    ``backend``: ``"torch"`` (the reference's ``"jnp"``, parity) or
    ``"cuda"`` (its ``"pallas"``: the flow's kernels on a CUDA device,
    their plain versions on the CPU).
    """

    def __init__(
        self,
        intrinsics: Sequence[float],
        keyframe_stride: int = 1,
        grid_step: int = 16,
        init_depth: float = 5.0,
        backend: str = "torch",
        fb_check_threshold: float | None = None,
        mesh=None,
        pyramid_config: str = "default",
        *,
        device: torch.device | str | None = None,
    ) -> None:
        self.intrinsics = tuple(float(x) for x in intrinsics)
        self.keyframe_stride = int(keyframe_stride)
        self.grid_step = int(grid_step)
        self.init_depth = float(init_depth)
        self.backend = backend
        if pyramid_config not in PYRAMID_CONFIGS:
            raise ValueError(
                f"unknown pyramid config {pyramid_config!r}; available: "
                f"{', '.join(sorted(PYRAMID_CONFIGS))}"
            )
        self.pyramid_config = pyramid_config
        self.fb_check_threshold = (
            None if fb_check_threshold is None else float(fb_check_threshold)
        )
        self._fe = device_loop.get_front_end(
            grid_step=self.grid_step,
            keyframe_stride=self.keyframe_stride,
            fb_check_threshold=self.fb_check_threshold,
            backend=backend,
            mesh=mesh,
            config=PYRAMID_CONFIGS[pyramid_config],
        )
        self.device = resolve_device(device)

        self.frame_index = -1
        self.keyframes: list[int] = []
        # Front-end state on the device, and (frame index, ObsRecord) pairs
        # still there; ``_drain`` moves them into the NumPy lists below.
        self._dev: device_loop.FrontEndState | None = None
        self._pending: list[tuple[int, device_loop.ObsRecord]] = []
        self._obs_uv: list[np.ndarray] = []     # per keyframe: (N, 2)
        self._obs_lm: list[np.ndarray] = []     # per keyframe: (N,) int32
        self._obs_valid: list[np.ndarray] = []  # per keyframe: (N,) bool
        # Landmark spawn records, rebuilt on drain: ids ascend on the
        # device, so a record's new ids are those >= the previous counter.
        self._lm_first_uv = np.zeros((0, 2), np.float32)
        self._lm_first_kf = np.zeros((0,), np.int32)
        self._n_lm_drained = 0

    def _upload(self, frames) -> torch.Tensor:
        """Frames as float32 on the session's device (no copy if they are
        there already)."""
        if not isinstance(frames, torch.Tensor):
            frames = np.asarray(frames, np.float32)
        return torch.as_tensor(frames, dtype=torch.float32, device=self.device)

    # -- lifecycle ---------------------------------------------------------

    def start(self, first_frame) -> None:
        """Seed features on the first frame and record keyframe 0."""
        self._dev, obs0 = self._fe.init(self._upload(first_frame))
        self.frame_index = 0
        self.keyframes = [0]
        self._pending.append((0, obs0))

    def process_frame(self, frame) -> None:
        """Advance tracks by the dense flow prev -> frame; record keyframes
        (frame_index % keyframe_stride == 0, known on the host)."""
        if self.frame_index < 0:
            self.start(frame)
            return
        self._dev, obs = self._fe.step(self._dev, self._upload(frame))
        self.frame_index += 1
        if self.frame_index % self.keyframe_stride == 0:
            self.keyframes.append(self.frame_index)
            self._pending.append((self.frame_index, obs))

    def process_frames(self, frames) -> None:
        """Process a (T, H, W) chunk, uploaded once (a chunk already on
        the device is not copied). The same steps as ``process_frame``."""
        frames = self._upload(frames)
        if frames.ndim != 3:
            raise ValueError(f"expected (T, H, W) frames, got {tuple(frames.shape)}")
        if self.frame_index < 0:
            self.start(frames[0])
            frames = frames[1:]
        if frames.shape[0] == 0:
            return
        self._dev, obs_stack = self._fe.scan_steps(self._dev, frames)
        first = self.frame_index + 1
        for i in range(frames.shape[0]):
            fi = first + i
            if fi % self.keyframe_stride == 0:
                self.keyframes.append(fi)
                self._pending.append(
                    (fi, device_loop.ObsRecord(*(field[i] for field in obs_stack)))
                )
        self.frame_index += frames.shape[0]

    # -- host copies -------------------------------------------------------

    def _drain(self) -> None:
        """Copy the pending records to the host in one transfer (positions
        as their int32 bits beside ids, flags and counters), then rebuild
        the landmark spawn records from the monotone id counter."""
        if not self._pending:
            return
        recs = [rec for _, rec in self._pending]
        p, n = len(recs), recs[0].xy.shape[0]
        packed = torch.cat([
            torch.stack([r.xy for r in recs]).reshape(p, 2 * n).view(torch.int32),
            torch.stack([r.lm for r in recs]).to(torch.int32),
            torch.stack([r.alive for r in recs]).to(torch.int32),
            torch.stack([r.n_landmarks for r in recs]).to(torch.int32).reshape(p, 1),
        ], dim=1).cpu().numpy()
        xys = packed[:, : 2 * n].view(np.float32).reshape(p, n, 2)
        lms = packed[:, 2 * n : 3 * n]
        alives = packed[:, 3 * n : 4 * n].astype(bool)
        for (gfi, _), xy, lm, alive, n_lm in zip(
            self._pending, xys, lms, alives, packed[:, 4 * n]
        ):
            self._obs_uv.append(xy.copy())
            self._obs_lm.append(lm.copy())
            self._obs_valid.append(alive)
            if n_lm > self._n_lm_drained:
                # Ids >= the previous counter were minted at this keyframe;
                # their first observation is this record's slot position.
                slots = np.where(lm >= self._n_lm_drained)[0]
                order = np.argsort(lm[slots], kind="stable")
                self._lm_first_uv = np.concatenate([self._lm_first_uv, xy[slots][order]])
                self._lm_first_kf = np.concatenate(
                    [self._lm_first_kf, np.full(len(slots), gfi, np.int32)]
                )
                self._n_lm_drained = int(n_lm)
        self._pending.clear()

    # Back-end views. Getters drain pending records; setters keep the
    # device state (landmark counter, slot -> id table) in step.

    @property
    def obs_uv(self) -> list[np.ndarray]:
        self._drain()
        return self._obs_uv

    @obs_uv.setter
    def obs_uv(self, v) -> None:
        self._obs_uv = list(v)

    @property
    def obs_lm(self) -> list[np.ndarray]:
        self._drain()
        return self._obs_lm

    @obs_lm.setter
    def obs_lm(self, v) -> None:
        self._obs_lm = list(v)

    @property
    def obs_valid(self) -> list[np.ndarray]:
        self._drain()
        return self._obs_valid

    @obs_valid.setter
    def obs_valid(self, v) -> None:
        self._obs_valid = list(v)

    @property
    def lm_first_uv(self) -> np.ndarray:
        self._drain()
        return self._lm_first_uv

    @lm_first_uv.setter
    def lm_first_uv(self, v) -> None:
        self._lm_first_uv = np.asarray(v, np.float32)

    @property
    def lm_first_kf(self) -> np.ndarray:
        self._drain()
        return self._lm_first_kf

    @lm_first_kf.setter
    def lm_first_kf(self, v) -> None:
        self._lm_first_kf = np.asarray(v, np.int32)

    @property
    def n_landmarks(self) -> int:
        self._drain()
        return self._n_lm_drained

    @n_landmarks.setter
    def n_landmarks(self, v: int) -> None:
        self._n_lm_drained = int(v)
        if self._dev is not None:
            self._dev = self._dev._replace(
                n_landmarks=torch.full((), int(v), dtype=torch.int32, device=self.device)
            )

    @property
    def track_lm(self) -> np.ndarray:
        """Current slot -> landmark id table (one copy to the host)."""
        return self._dev.track_lm.cpu().numpy()

    @track_lm.setter
    def track_lm(self, v) -> None:
        self._dev = self._dev._replace(
            track_lm=torch.as_tensor(np.asarray(v, np.int32), device=self.device)
        )

    @property
    def track_loss_frames(self) -> list[int]:
        """Frames of healthy -> lost transitions (one copy to the host)."""
        if self._dev is None:
            return []
        log = torch.cat([self._dev.loss_frames, self._dev.loss_count[None]]).cpu().numpy()
        return [int(x) for x in log[: int(log[-1])]]

    @property
    def _tracking_lost(self) -> bool:
        return False if self._dev is None else bool(self._dev.tracking_lost)

    @property
    def _max_alive(self) -> int:
        return 0 if self._dev is None else int(self._dev.max_alive)

    @property
    def _tracks(self) -> tracking.Tracks | None:
        """Live track table (device tensors)."""
        if self._dev is None:
            return None
        return tracking.Tracks(
            xy=self._dev.xy, start_xy=self._dev.start_xy,
            age=self._dev.age, alive=self._dev.alive,
        )

    @property
    def _prev_frame(self) -> torch.Tensor | None:
        """The last processed frame: the finest level of the carried
        pyramid."""
        return None if self._dev is None else self._dev.carry[-1]

    # -- solve -------------------------------------------------------------

    def _essential_initial_poses(self) -> tuple[np.ndarray, np.ndarray]:
        """Pose chain from per-edge essential matrices.

        For each consecutive keyframe pair: the slots that kept their
        landmark id, ``epipolar.two_view_init`` on them, and the relative
        poses chained. Per-edge scale follows the depth ratio of landmarks
        shared with the previous edge; the first edge is scaled so the
        median triangulated depth is ``init_depth``. Degenerate edges (too
        few matches, ~zero motion, a losing vote) keep the previous pose.
        """
        k = len(self.keyframes)
        intr = torch.as_tensor(self.intrinsics, dtype=torch.float32, device=self.device)
        pr = np.tile(np.eye(3, dtype=np.float32)[None], (k, 1, 1))
        pt = np.zeros((k, 3), np.float32)
        prev_edge = None  # (lm_ids, good), points_unit, rel_r, rel_t, scale
        scale = 1.0
        for e in range(k - 1):
            valid = (
                self.obs_valid[e] & self.obs_valid[e + 1]
                & (self.obs_lm[e] == self.obs_lm[e + 1])
            )
            uv1 = self.obs_uv[e]
            uv2 = self.obs_uv[e + 1]
            disp = np.linalg.norm(uv2 - uv1, axis=1)
            moved = float(np.median(disp[valid])) if valid.any() else 0.0
            if int(valid.sum()) < 8 or moved < 0.5:
                pr[e + 1], pt[e + 1] = pr[e], pt[e]
                prev_edge = None
                continue
            init = epipolar.two_view_init(
                torch.as_tensor(uv1, device=self.device), torch.as_tensor(uv2, device=self.device),
                torch.as_tensor(valid, device=self.device), intr,
            )
            if int(init.n_good) < max(8, 0.5 * int(valid.sum())):
                pr[e + 1], pt[e + 1] = pr[e], pt[e]
                prev_edge = None
                continue
            rel_r = init.r.cpu().numpy()
            rel_t = init.t.cpu().numpy()
            depths = init.depths1.cpu().numpy()
            good = init.good.cpu().numpy()
            x1 = epipolar.normalize_pixels(torch.as_tensor(uv1), intr.cpu()).numpy()
            pts_unit = (
                np.concatenate([x1, np.ones((x1.shape[0], 1))], axis=1) * depths[:, None]
            ).astype(np.float32)

            if prev_edge is None:
                scale = self.init_depth / max(float(np.median(depths[good])), 1e-6)
            else:
                p_ids, p_pts, p_r, p_t, p_scale = prev_edge
                common = good & p_ids[1] & (self.obs_lm[e] == p_ids[0])
                if int(common.sum()) >= 4:
                    # The previous edge's points moved into this frame and
                    # scaled: the depth each shared landmark should have.
                    z_prev = p_scale * (p_pts[common] @ p_r.T + p_t)[:, 2]
                    z_cur = depths[common]
                    ratio = z_prev / np.maximum(z_cur, 1e-6)
                    ratio = ratio[(z_prev > 1e-6) & (z_cur > 1e-6)]
                    if ratio.size >= 4:
                        scale = float(np.median(ratio))
            pr[e + 1] = rel_r @ pr[e]
            pt[e + 1] = rel_r @ pt[e] + (rel_t * scale).astype(np.float32)
            prev_edge = ((self.obs_lm[e].copy(), good), pts_unit, rel_r, rel_t, scale)
        return pr, pt

    def solve(
        self,
        ba_iterations: int = 8,
        window: int | None = None,
        essential_init: bool = False,
    ) -> OdometryResult:
        """Bundle-adjust the keyframe poses recorded so far.

        ``window``: only the last ``window`` keyframes are free (older
        poses held fixed; landmarks stay free). Camera 0 is always pinned.
        ``essential_init``: start from the essential-matrix pose chain and
        multi-view triangulated landmarks instead of identity poses and
        flat-depth landmarks.
        """
        fx, fy, cx, cy = self.intrinsics
        k = len(self.keyframes)
        n_tracks = self.obs_uv[0].shape[0]
        uv = np.concatenate(self.obs_uv)
        cam = np.concatenate([np.full(n_tracks, i, np.int32) for i in range(k)])
        lm_idx = np.concatenate(self.obs_lm)
        valid = np.concatenate(self.obs_valid)

        if essential_init and k >= 2:
            pr0, pt0 = self._essential_initial_poses()
        else:
            pr0 = np.tile(np.eye(3, dtype=np.float32)[None], (k, 1, 1))
            pt0 = np.zeros((k, 3), np.float32)

        # Each landmark's first observation back-projected at init_depth
        # through the initial pose of the keyframe that spawned it.
        first = self.lm_first_uv
        n_lm = self.n_landmarks
        kf_ord = {g: i for i, g in enumerate(self.keyframes)}
        spawn_ord = np.asarray([kf_ord.get(int(g), 0) for g in self.lm_first_kf], np.int32)
        ray = np.stack(
            [
                (first[:, 0] - cx) / fx * self.init_depth,
                (first[:, 1] - cy) / fy * self.init_depth,
                np.full(n_lm, self.init_depth, np.float32),
            ],
            axis=1,
        ).astype(np.float32)
        landmarks = np.einsum("mij,mi->mj", pr0[spawn_ord], ray - pt0[spawn_ord]).astype(
            np.float32
        )

        def dev(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        init_r, init_t = dev(pr0), dev(pt0)
        intr = dev(self.intrinsics, torch.float32)
        obs_uv, obs_cam = dev(uv, torch.float32), dev(cam)
        obs_lm, obs_valid = dev(lm_idx), dev(valid)
        lm0 = dev(landmarks)
        if essential_init and k >= 2:
            lm0 = epipolar.triangulate_landmarks(
                init_r, init_t, obs_uv, obs_cam, obs_lm, obs_valid, intr,
                n_landmarks=n_lm, fallback=lm0,
            )
        problem = ba.BAProblem(
            poses_r=init_r, poses_t=init_t, landmarks=lm0,
            obs_uv=obs_uv, obs_cam=obs_cam, obs_lm=obs_lm, obs_valid=obs_valid,
            intrinsics=intr,
        )
        fixed = tuple(range(k - window)) if window is not None and k > window else (0,)
        solved = ba.solve(problem, iterations=ba_iterations, fixed_cams=fixed)
        err = ba.reprojection_errors(solved).cpu().numpy()
        mean_err = float(err[valid].mean()) if valid.any() else 0.0

        return OdometryResult(
            poses_r=solved.poses_r.cpu().numpy(),
            poses_t=solved.poses_t.cpu().numpy(),
            landmarks=solved.landmarks.cpu().numpy(),
            keyframe_indices=list(self.keyframes),
            track_count=int(self._dev.alive.sum()),
            mean_reprojection_error=mean_err,
            track_loss_frames=list(self.track_loss_frames),
        )


def run_odometry(
    frames: Sequence[np.ndarray],
    intrinsics: Sequence[float],
    keyframe_stride: int = 1,
    grid_step: int = 16,
    init_depth: float = 5.0,
    ba_iterations: int = 8,
    backend: str = "torch",
    fb_check_threshold: float | None = None,
    pyramid_config: str = "default",
    *,
    device: torch.device | str | None = None,
) -> OdometryResult:
    """Track through ``frames`` (grayscale float32, one shape) and
    bundle-adjust the keyframe poses. intrinsics: (fx, fy, cx, cy)."""
    session = OdometrySession(
        intrinsics,
        keyframe_stride=keyframe_stride,
        grid_step=grid_step,
        init_depth=init_depth,
        backend=backend,
        fb_check_threshold=fb_check_threshold,
        pyramid_config=pyramid_config,
        device=device,
    )
    for frame in frames:
        session.process_frame(frame)
    return session.solve(ba_iterations=ba_iterations)
