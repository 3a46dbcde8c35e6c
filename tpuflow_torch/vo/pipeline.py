"""Visual odometry: frames -> dense flow -> feature tracks -> keyframe
observations -> bundle-adjusted trajectory.

Counterpart of ``tpuflow.vo.pipeline``:

- ``OdometrySession``: the incremental path (``start``, ``process_frame``,
  ``process_frames``, ``solve``), bounded-memory marginalization
  (``compact``: a frozen trajectory prefix, anchored window poses and
  carried landmark positions, which ``solve`` then reads) and its
  resumable state (``state_dict`` / ``meta_dict`` / ``from_state``, saved
  by ``vo.checkpoint``);
- ``run_odometry``: one session over a frame sequence;
- ``run_odometry_chunked``: local bundle adjustment in overlapping chunks
  fused by a global pose graph (``vo.pose_graph``), with appearance loop
  closure (``vo.loop_closure``), gyro rotation edges and metric scale from
  an IMU (``vo.imu``), and tightly coupled visual-inertial refinement
  (``vo.vi_graph``).

Monocular: the trajectory is recovered up to the 7-DOF gauge; landmarks
start at their first observation back-projected to ``init_depth``, and
camera 0 is pinned.

Everything runs on ``device``: the card unless the caller names another
(``device="cpu"``); without a card the default raises. The front end
(``device_loop.FrontEnd``) keeps its state there, and each keyframe's
observation record stays there until the back end needs it; ``_drain``
then brings every pending record to the host in one copy.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from tpuflow_torch.core.config import PYRAMID_CONFIGS
from tpuflow_torch.eval.timing import resolve_device
from tpuflow_torch.flow.pyramidal import lucas_kanade_pyramidal
from tpuflow_torch.vo import ba, device_loop, epipolar, imu as imu_mod, pose_graph, tracking
from tpuflow_torch.vo import loop_closure as lc
from tpuflow_torch.vo import vi_graph

# The JAX package's backend names -> this package's, for state saved there.
PORT_BACKEND = {"jnp": "torch", "pallas": "cuda"}


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
    # Metric scale of the monocular trajectory from the visual-inertial
    # alignment (``imu.estimate_scale_and_gravity``); None = unavailable or
    # rejected (|gravity| outside (8, 12)). With ``metric_poses`` False,
    # multiply translations by it for world units; with True (the tight
    # ``vi_graph`` refinement ran) the poses are already metric and it
    # records the factor applied.
    metric_scale: float | None = None
    metric_poses: bool = False


class OdometrySession:
    """Incremental VO: feed frames one at a time or in chunks, solve any
    time.

    ``backend``: ``"torch"`` (the reference's ``"jnp"``, parity) or
    ``"cuda"`` (its ``"pallas"``: the flow's kernels on a CUDA device,
    their plain versions on the CPU). ``mesh`` (tiled multi-GPU flow)
    raises: not ported yet (ROADMAP.md, queue 1 item 9).
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
        # Marginalization state (``compact``): the frozen trajectory
        # prefix, anchor poses of the kept window, and solved landmark
        # positions carried as the next solve's initialization.
        self.frozen_kf: list[int] = []
        self.frozen_r = np.zeros((0, 3, 3), np.float32)
        self.frozen_t = np.zeros((0, 3), np.float32)
        self.anchor_r: np.ndarray | None = None  # (K_window, 3, 3)
        self.anchor_t: np.ndarray | None = None  # (K_window, 3)
        self.lm_xyz: np.ndarray | None = None    # (n_landmarks_kept, 3)

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
        After ``compact`` the chain starts at the first anchored pose.
        """
        k = len(self.keyframes)
        intr = torch.as_tensor(self.intrinsics, dtype=torch.float32, device=self.device)
        pr = np.tile(np.eye(3, dtype=np.float32)[None], (k, 1, 1))
        pt = np.zeros((k, 3), np.float32)
        if self.anchor_r is not None and self.anchor_r.shape[0] > 0:
            # After compact(): the chain continues from the first anchored
            # window pose (gauge continuity with the frozen prefix).
            pr[:] = self.anchor_r[0]
            pt[:] = self.anchor_t[0]
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
        poses held fixed; landmarks stay free). Camera 0 is always pinned;
        after ``compact`` the first two anchored poses are, which pins the
        monocular gauge's scale too. ``essential_init``: start from the
        essential-matrix pose chain and multi-view triangulated landmarks
        instead of identity (or anchored) poses and flat-depth landmarks.
        The result leads with the frozen prefix.
        """
        fx, fy, cx, cy = self.intrinsics
        k = len(self.keyframes)
        n_tracks = self.obs_uv[0].shape[0]
        uv = np.concatenate(self.obs_uv)
        cam = np.concatenate([np.full(n_tracks, i, np.int32) for i in range(k)])
        lm_idx = np.concatenate(self.obs_lm)
        valid = np.concatenate(self.obs_valid)

        # Initial poses: essential chain > compaction anchors > identity.
        pr0 = np.tile(np.eye(3, dtype=np.float32)[None], (k, 1, 1))
        pt0 = np.zeros((k, 3), np.float32)
        if essential_init and k >= 2:
            pr0, pt0 = self._essential_initial_poses()
        elif self.anchor_r is not None:
            na = min(self.anchor_r.shape[0], k)
            pr0[:na] = self.anchor_r[:k]
            pt0[:na] = self.anchor_t[:k]
            # Keyframes recorded after the last compact() start at the last
            # anchored pose.
            for c in range(na, k):
                pr0[c] = pr0[c - 1]
                pt0[c] = pt0[c - 1]

        # Each landmark's first observation back-projected at init_depth
        # through the initial pose of the keyframe that spawned it;
        # landmarks carried through compact() reuse their solved positions.
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
        if self.lm_xyz is not None and self.lm_xyz.shape[0] > 0:
            nk = min(self.lm_xyz.shape[0], n_lm)
            landmarks[:nk] = self.lm_xyz[:nk]

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
        if window is not None and k > window:
            fixed = tuple(range(k - window))  # includes camera 0
        elif self.anchor_r is not None and self.anchor_r.shape[0] >= 2 and k >= 2:
            # After compact(): the first two anchored poses pin the 7-DOF
            # gauge (pose and scale), keeping the frozen prefix and the
            # refined window in one frame.
            fixed = (0, 1)
        else:
            fixed = (0,)
        solved = ba.solve(problem, iterations=ba_iterations, fixed_cams=fixed)
        err = ba.reprojection_errors(solved).cpu().numpy()
        mean_err = float(err[valid].mean()) if valid.any() else 0.0

        return OdometryResult(
            poses_r=np.concatenate([self.frozen_r, solved.poses_r.cpu().numpy()]),
            poses_t=np.concatenate([self.frozen_t, solved.poses_t.cpu().numpy()]),
            landmarks=solved.landmarks.cpu().numpy(),
            keyframe_indices=self.frozen_kf + list(self.keyframes),
            track_count=int(self._dev.alive.sum()),
            mean_reprojection_error=mean_err,
            track_loss_frames=list(self.track_loss_frames),
        )

    def compact(
        self,
        keep_last: int,
        ba_iterations: int = 8,
        essential_init: bool = False,
    ) -> None:
        """Marginalize keyframes older than the last ``keep_last``.

        Solve once over the window, then (1) freeze the solved poses of the
        keyframes leaving it into the trajectory prefix, (2) drop their
        observation records, (3) remap landmark ids so that only
        window-visible and live-track landmarks remain (the memory bound),
        and (4) anchor the kept poses and carry the solved landmark
        positions into the next solve. Marginalization by fixation (drop
        and anchor, the DSO-style approximation), not a dense Schur prior.
        The setters keep the device's landmark counter and slot -> id table
        in step.
        """
        k = len(self.keyframes)
        if k <= keep_last:
            return
        res = self.solve(ba_iterations=ba_iterations, essential_init=essential_init)
        nf = len(self.frozen_kf)
        win_r = res.poses_r[nf:]
        win_t = res.poses_t[nf:]
        ndrop = k - keep_last

        self.frozen_kf += self.keyframes[:ndrop]
        self.frozen_r = np.concatenate([self.frozen_r, win_r[:ndrop]])
        self.frozen_t = np.concatenate([self.frozen_t, win_t[:ndrop]])
        self.keyframes = self.keyframes[ndrop:]
        self.obs_uv = self.obs_uv[ndrop:]
        self.obs_lm = self.obs_lm[ndrop:]
        self.obs_valid = self.obs_valid[ndrop:]
        self.anchor_r = win_r[ndrop:].copy()
        self.anchor_t = win_t[ndrop:].copy()

        # Keep ids observed (validly) in the window or carried by a live
        # track slot; remap them to dense ids.
        used = [lm[v] for lm, v in zip(self.obs_lm, self.obs_valid)]
        track_lm = self.track_lm
        used.append(track_lm[self._dev.alive.cpu().numpy()])
        kept = np.unique(np.concatenate(used)).astype(np.int32)
        old2new = np.full(self.n_landmarks, -1, np.int32)
        old2new[kept] = np.arange(len(kept), dtype=np.int32)
        for i in range(len(self.obs_lm)):
            m = old2new[self.obs_lm[i]]
            self.obs_valid[i] = self.obs_valid[i] & (m >= 0)
            self.obs_lm[i] = np.where(m >= 0, m, 0).astype(np.int32)
        tm = old2new[track_lm]
        self.track_lm = np.where(tm >= 0, tm, 0).astype(np.int32)
        self.lm_first_uv = self.lm_first_uv[kept]
        self.lm_first_kf = self.lm_first_kf[kept]
        self.lm_xyz = res.landmarks[kept].astype(np.float32)
        self.n_landmarks = len(kept)

    # -- resumable state ---------------------------------------------------

    def state_dict(self) -> dict:
        """The full resumable state as numpy arrays, the reference's keys.
        Reads the device's front-end state to the host. An optional array
        (the loss log, the marginalization state) is omitted while empty;
        ``from_state`` defaults every absent key."""
        d = self._dev
        state = {
            "frame_index": np.int64(self.frame_index),
            "keyframes": np.asarray(self.keyframes, np.int64),
            "track_loss_frames": np.asarray(self.track_loss_frames, np.int64),
            "tracking_lost": np.int64(self._tracking_lost),
            "max_alive": np.int64(self._max_alive),
            "obs_uv": np.stack(self.obs_uv),          # (K, N, 2)
            "obs_lm": np.stack(self.obs_lm),          # (K, N)
            "obs_valid": np.stack(self.obs_valid),    # (K, N)
            "prev_frame": self._prev_frame.cpu().numpy(),
            "tracks_xy": d.xy.cpu().numpy(),
            "tracks_start_xy": d.start_xy.cpu().numpy(),
            "tracks_age": d.age.cpu().numpy(),
            "tracks_alive": d.alive.cpu().numpy(),
            "track_lm": self.track_lm,
            "lm_first_uv": np.asarray(self.lm_first_uv, np.float32),
            "lm_first_kf": np.asarray(self.lm_first_kf, np.int32),
            "n_landmarks": np.int64(self.n_landmarks),
            "frozen_kf": np.asarray(self.frozen_kf, np.int64),
            "frozen_r": self.frozen_r,
            "frozen_t": self.frozen_t,
            "anchor_r": self.anchor_r,
            "anchor_t": self.anchor_t,
            "lm_xyz": self.lm_xyz,
        }
        return {
            k: v for k, v in state.items()
            if v is not None and (not isinstance(v, np.ndarray) or v.size)
        }

    def meta_dict(self) -> dict:
        """The JSON-able static configuration (this package's backend name)."""
        return {
            "intrinsics": list(self.intrinsics),
            "keyframe_stride": self.keyframe_stride,
            "grid_step": self.grid_step,
            "init_depth": self.init_depth,
            "backend": self.backend,
            "fb_check_threshold": self.fb_check_threshold,
            "tiled": False,
            "pyramid_config": self.pyramid_config,
        }

    @classmethod
    def from_state(
        cls,
        meta: dict,
        state: dict,
        mesh=None,
        *,
        device: torch.device | str | None = None,
    ) -> "OdometrySession":
        """A session from ``meta_dict()`` and ``state_dict()`` (numpy arrays,
        or anything ``np.asarray`` takes), this package's or ``tpuflow``'s:
        the reference's backend names map to this package's. The front
        end's flow carry is rebuilt from the saved previous frame, a pure
        function of it, so a resumed session continues bit-identically on
        ``device`` (the card unless the caller names another). A tiled
        session, or a ``mesh``, raises: tiled flow is multi-GPU work, not
        ported yet (ROADMAP.md, queue 1 item 9)."""
        if mesh is not None or bool(meta.get("tiled", False)):
            raise NotImplementedError(
                "resuming a mesh-tiled session is multi-GPU work, not ported yet "
                "(ROADMAP.md, queue 1 item 9)"
            )
        sess = cls(
            intrinsics=meta["intrinsics"],
            keyframe_stride=meta["keyframe_stride"],
            grid_step=meta["grid_step"],
            init_depth=meta["init_depth"],
            backend=PORT_BACKEND.get(meta["backend"], meta["backend"]),
            fb_check_threshold=meta.get("fb_check_threshold"),
            pyramid_config=meta.get("pyramid_config", "default"),
            device=device,
        )
        sess.frame_index = int(state["frame_index"])
        sess.keyframes = [int(x) for x in np.asarray(state["keyframes"])]
        sess.obs_uv = [np.asarray(x, np.float32) for x in np.asarray(state["obs_uv"])]
        sess.obs_lm = [np.asarray(x, np.int32) for x in np.asarray(state["obs_lm"])]
        sess.obs_valid = [np.asarray(x, bool) for x in np.asarray(state["obs_valid"])]
        sess.lm_first_uv = np.asarray(state["lm_first_uv"], np.float32)
        sess.lm_first_kf = np.asarray(
            state.get("lm_first_kf", np.zeros(len(sess.lm_first_uv))), np.int32
        )
        sess._n_lm_drained = int(state["n_landmarks"])
        sess.frozen_kf = [int(x) for x in np.asarray(state.get("frozen_kf", []))]
        sess.frozen_r = np.asarray(state.get("frozen_r", np.zeros((0, 3, 3))), np.float32)
        sess.frozen_t = np.asarray(state.get("frozen_t", np.zeros((0, 3))), np.float32)
        anchor_r = np.asarray(state.get("anchor_r", np.zeros((0, 3, 3))), np.float32)
        anchor_t = np.asarray(state.get("anchor_t", np.zeros((0, 3))), np.float32)
        sess.anchor_r = anchor_r if anchor_r.shape[0] else None
        sess.anchor_t = anchor_t if anchor_t.shape[0] else None
        lm_xyz = np.asarray(state.get("lm_xyz", np.zeros((0, 3))), np.float32)
        sess.lm_xyz = lm_xyz if lm_xyz.shape[0] else None

        # The >= 0 filter also reads logs that encoded "empty" as a [-1]
        # sentinel instead of an omitted key.
        losses = [int(x) for x in np.asarray(state.get("track_loss_frames", [])) if int(x) >= 0]
        cap = device_loop.LOSS_LOG_CAP
        log = np.full((cap,), -1, np.int32)
        log[: min(len(losses), cap)] = losses[:cap]

        def on(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=sess.device)

        def scalar(value, dtype=torch.int32):
            return torch.tensor(value, dtype=dtype, device=sess.device)

        sess._dev = device_loop.FrontEndState(
            carry=sess._fe.carry_of_frame(on(state["prev_frame"], torch.float32)),
            xy=on(state["tracks_xy"], torch.float32),
            start_xy=on(state["tracks_start_xy"], torch.float32),
            age=on(state["tracks_age"], torch.int32),
            alive=on(np.asarray(state["tracks_alive"], bool), torch.bool),
            track_lm=on(state["track_lm"], torch.int32),
            n_landmarks=scalar(int(state["n_landmarks"])),
            frame_index=scalar(sess.frame_index),
            max_alive=scalar(int(state.get("max_alive", 0))),
            tracking_lost=scalar(bool(int(state.get("tracking_lost", 0))), torch.bool),
            loss_frames=on(log, torch.int32),
            loss_count=scalar(len(losses)),
        )
        return sess


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


def _relative(pr, pt, i: int, j: int) -> tuple[np.ndarray, np.ndarray]:
    """T_i^-1 T_j (the pose-graph edge convention), in float32."""
    ri_t = pr[i].T
    return ri_t @ pr[j], ri_t @ pt[j] + -(ri_t @ pt[i])


def run_odometry_chunked(
    frames: Sequence[np.ndarray],
    intrinsics: Sequence[float],
    chunk_size: int = 6,
    overlap: int = 2,
    grid_step: int = 16,
    init_depth: float = 5.0,
    ba_iterations: int = 8,
    pg_iterations: int = 15,
    backend: str = "torch",
    loop_closure: bool = False,
    loop_threshold: float = 0.95,
    loop_min_separation: int = 4,
    loop_weight: float = 5.0,
    motion_prior_weight: float = 0.0,
    fb_check_threshold: float | None = None,
    pyramid_config: str = "default",
    imu: tuple | None = None,
    frame_times: np.ndarray | None = None,
    imu_weight: float = 2.0,
    imu_r_cam: np.ndarray | None = None,
    imu_tight: bool = False,
    *,
    device: torch.device | str | None = None,
) -> OdometryResult:
    """Local bundle adjustment in chunks fused by a global pose graph (the
    classic SLAM split), on ``device``: the card unless the caller names
    another; raises without a card.

    Frames are processed in overlapping chunks: each runs flow -> tracks ->
    bundle adjustment (``run_odometry``) and gives relative poses between
    its consecutive keyframes. The chunks' monocular scales are chained
    through the shared overlap edge (``overlap`` >= 2), then every
    relative-pose constraint is fused by ``pose_graph.solve``.

    ``loop_closure``: revisits found by thumbnail descriptors (cosine >=
    ``loop_threshold``, at least ``loop_min_separation`` keyframes apart),
    each pair's relative pose measured by ``loop_closure.loop_edge`` with
    the ``default`` flow, added at information scale ``loop_weight``.

    ``motion_prior_weight`` > 0 appends soft constant-velocity edges.

    ``imu``: ``(times, gyro, accel)`` samples (``io.imu`` format) with
    ``frame_times``: gyro preintegrated between consecutive keyframes and
    added as rotation-only edges at ``imu_weight``; with accelerometer
    content the metric scale is recovered (``metric_scale``), and a chunk
    boundary where the shared edge nearly vanishes takes its scale from
    the IMU. ``imu_r_cam``: the camera-from-IMU rotation.

    ``imu_tight``: also run the tightly coupled refinement
    (``vi_graph.solve_vi``); the poses are then metric (``metric_poses``).
    Needs IMU coverage of every keyframe interval and a physical gravity;
    otherwise the loose scale report stands.
    """
    dev = resolve_device(device)
    if overlap < 2:
        raise ValueError("overlap must be >= 2 for scale chaining")
    n = len(frames)
    step = chunk_size - overlap + 1
    starts = list(range(0, max(n - chunk_size, 0) + 1, step - 1 if step > 1 else 1))
    if starts[-1] + chunk_size < n:
        starts.append(n - chunk_size)

    if imu is not None:
        if frame_times is None:
            raise ValueError("imu requires frame_times (per-frame timestamps)")
        frame_times = np.asarray(frame_times, np.float64)

    def chunk_metric_scale(res, kf_global):
        """A chunk's metric scale from the linear VI alignment, or None.

        The |t|-ratio chain divides by the shared edge's translation norm,
        near zero at a motion turning point; with an accelerometer each
        chunk's scale is observable directly, and chaining is the
        fallback."""
        if imu is None or len(kf_global) < 4:
            return None
        imu_t, imu_gyro, imu_accel = imu
        incs = imu_mod.preintegrate_segments(
            imu_t, imu_gyro, imu_accel, frame_times[np.asarray(kf_global)], device=dev
        )
        if any(int(inc.n_samples) == 0 for inc in incs):
            return None
        try:
            s_c, g_c, _v, _rms = imu_mod.estimate_scale_and_gravity(
                res.poses_r, res.poses_t, incs, r_cam_imu=imu_r_cam
            )
        except np.linalg.LinAlgError:
            return None
        if 8.0 < float(np.linalg.norm(g_c)) < 12.0 and s_c > 0:
            return float(s_c)
        return None

    edges = {}  # (gi, gj) -> (R, t)
    scale = 1.0
    prev_shared = None  # ((gi, gj), |t| in the previous chunk's scale)
    chunk0_metric = None  # chunk 0's units -> metric (the fallback's base)
    last_result = None
    # Loss frames come per chunk in local indices; collect them as global
    # indices, deduplicated across the overlaps.
    loss_frames: set[int] = set()
    for s in starts:
        res = run_odometry(
            frames[s : s + chunk_size], intrinsics,
            grid_step=grid_step, init_depth=init_depth,
            ba_iterations=ba_iterations, backend=backend,
            fb_check_threshold=fb_check_threshold,
            pyramid_config=pyramid_config, device=dev,
        )
        last_result = res
        loss_frames.update(s + f for f in res.track_loss_frames)
        kf = [s + i for i in res.keyframe_indices]
        rels = [(kf[i], kf[i + 1], _relative(res.poses_r, res.poses_t, i, i + 1))
                for i in range(len(kf) - 1)]
        if prev_shared is None:
            # Chunk 0 sets the working units; its metric scale lets a later
            # degenerate boundary re-express a chunk in chunk-0 units.
            chunk0_metric = chunk_metric_scale(res, kf)
        else:
            # |t|-ratio chaining through the shared overlap edge; where that
            # edge is tiny (a turning point), the chunk's IMU-anchored scale
            # over chunk 0's instead, when an accelerometer gives both.
            (gi, gj), prev_norm = prev_shared
            match = [r for r in rels if (r[0], r[1]) == (gi, gj)]
            tn = float(np.linalg.norm(match[0][2][1])) if match else 0.0
            typical = float(np.median([np.linalg.norm(t_) for _a, _b, (_r, t_) in rels]))
            metric_chunk_scale = None
            if tn <= 0.2 * typical and chunk0_metric is not None:
                s_c = chunk_metric_scale(res, kf)
                if s_c is not None:
                    metric_chunk_scale = s_c / chunk0_metric
            if metric_chunk_scale is not None:
                scale = metric_chunk_scale
            elif tn > 1e-9:
                scale *= prev_norm / tn
        for gi, gj, (rr, tt) in rels:
            if (gi, gj) not in edges:
                edges[(gi, gj)] = (rr, tt * scale)
        last_gi, last_gj, (rr, tt) = rels[-1]
        prev_shared = ((last_gi, last_gj), float(np.linalg.norm(tt)) * scale)

    # The global keyframe set.
    nodes = sorted({i for ij in edges for i in ij})
    idx = {g: k for k, g in enumerate(nodes)}
    k = len(nodes)

    # Loop closures: appearance retrieval over keyframe thumbnails, then a
    # measured relative-pose edge for each accepted pair.
    loop_edges: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    if loop_closure and k > loop_min_separation:
        descs = np.stack([lc.keyframe_descriptor(frames[g]) for g in nodes])
        pairs = lc.detect_loops(descs, min_separation=loop_min_separation,
                                threshold=loop_threshold)

        def flow_fn(p, c):
            return lucas_kanade_pyramidal(p, c, backend=backend)

        for i, j, _sim in pairs:
            gi, gj = nodes[i], nodes[j]
            if (gi, gj) in edges:
                continue
            measured = lc.loop_edge(frames[gi], frames[gj], intrinsics, flow_fn,
                                    depth=init_depth, grid_step=grid_step, device=dev)
            if measured is not None:
                loop_edges[(gi, gj)] = (measured[0], measured[1])

    # Sequential initialization by chaining the odometry edges.
    pr = np.tile(np.eye(3, dtype=np.float32)[None], (k, 1, 1))
    pt = np.zeros((k, 3), np.float32)
    for (gi, gj), (rr, tt) in sorted(edges.items()):
        i, j = idx[gi], idx[gj]
        pr[j] = pr[i] @ rr
        pt[j] = pr[i] @ tt + pt[i]

    all_edges = dict(edges)
    all_edges.update(loop_edges)
    weights = np.concatenate([np.ones(len(edges), np.float32),
                              np.full(len(loop_edges), loop_weight, np.float32)])

    def on(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    g = pose_graph.PoseGraph(
        poses_r=on(pr),
        poses_t=on(pt),
        edge_i=on([idx[a] for (a, _b) in all_edges], torch.int64),
        edge_j=on([idx[b] for (_a, b) in all_edges], torch.int64),
        edge_r=on(np.stack([e[0] for e in all_edges.values()])),
        edge_t=on(np.stack([e[1] for e in all_edges.values()])),
        edge_valid=torch.ones(len(all_edges), dtype=torch.bool, device=dev),
        edge_weight=on(weights),
    )
    imu_incs = None
    if imu is not None:
        imu_t, imu_gyro, imu_accel = imu
        node_times = frame_times[np.asarray(nodes)]
        imu_incs = imu_mod.preintegrate_segments(imu_t, imu_gyro, imu_accel, node_times,
                                                 device=dev)
        # An empty segment means no IMU coverage, not "no motion": an
        # identity increment would be a weight-2 zero-rotation edge bending
        # a rotating trajectory. Drop those edges, and refuse when nothing
        # overlaps (a clock time-base mismatch).
        covered = [(i, inc) for i, inc in enumerate(imu_incs) if inc.n_samples > 0]
        if not covered:
            raise ValueError(
                "no IMU samples overlap the frame window "
                f"[{node_times[0]:.3f}, {node_times[-1]:.3f}] s "
                f"(IMU spans [{imu_t[0]:.3f}, {imu_t[-1]:.3f}] s) — "
                "check that frame_times and the IMU stream share a time base"
            )
        if len(covered) < len(imu_incs):
            print(
                f"WARNING: {len(imu_incs) - len(covered)} of {len(imu_incs)} keyframe "
                "intervals have no IMU samples; skipping their gyro edges"
            )
        g = imu_mod.gyro_rotation_edges(
            g, [inc for _i, inc in covered], [(i, i + 1) for i, _inc in covered],
            weight=imu_weight, r_cam_imu=imu_r_cam,
        )
    if motion_prior_weight > 0.0:
        # Anchored to the odometry-chained initialization.
        g = pose_graph.constant_velocity_edges(g, motion_prior_weight)
    solved = pose_graph.solve(g, iterations=pg_iterations, device=dev)
    resid = float(pose_graph.residuals(solved).abs().max())

    # Visual-inertial alignment: with accelerometer content the solved
    # trajectory and the increments give the metric scale, accepted only
    # with a physical gravity magnitude.
    metric_scale = None
    metric_poses = False
    out_r = solved.poses_r.cpu().numpy()
    out_t = solved.poses_t.cpu().numpy()
    if imu_incs is not None and len(nodes) >= 4 and all(inc.n_samples > 0 for inc in imu_incs):
        try:
            s_hat, g_hat, v_hat, _rms = imu_mod.estimate_scale_and_gravity(
                out_r, out_t, imu_incs, r_cam_imu=imu_r_cam,
            )
            if 8.0 < float(np.linalg.norm(g_hat)) < 12.0 and s_hat > 0:
                metric_scale = s_hat
                if imu_tight:
                    sol = vi_graph.solve_vi(
                        out_r, out_t, imu_incs, g_hat, r_cam_imu=imu_r_cam,
                        init_scale=s_hat, init_velocities=v_hat, device=dev,
                    )
                    # A near-singular float32 solve returns garbage, not an
                    # exception: never adopt non-finite poses as metric.
                    finite = (
                        np.isfinite(sol.poses_r).all()
                        and np.isfinite(sol.poses_t).all()
                        and np.isfinite(sol.residual_rms)
                        and sol.scale > 0
                    )
                    if finite:
                        out_r, out_t = sol.poses_r, sol.poses_t
                        metric_scale = sol.scale
                        metric_poses = True
        except np.linalg.LinAlgError:
            pass
    return OdometryResult(
        poses_r=out_r,
        poses_t=out_t,
        landmarks=last_result.landmarks,
        keyframe_indices=nodes,
        track_count=last_result.track_count,
        mean_reprojection_error=resid,
        track_loss_frames=sorted(loss_frames),
        metric_scale=metric_scale,
        metric_poses=metric_poses,
    )
