"""Visual odometry: the port of ``tpuflow.vo``.

- ``se3``           SE(3) / SO(3) helpers.
- ``tracking``      Shi-Tomasi grid seeding and flow-driven track advance.
- ``device_loop``   the front end's step on the device (``FrontEnd``).
- ``ba``            bundle adjustment (Schur complement, Huber, LM).
- ``epipolar``      essential-matrix two-view initialization.
- ``pose_graph``    keyframe pose-graph Gauss-Newton.
- ``loop_closure``  thumbnail descriptors, revisit detection, loop edges.
- ``imu``           IMU preintegration, VI scale/gravity alignment and
                    gyro rotation edges.
- ``vi_graph``      tightly coupled visual-inertial refinement.
- ``pipeline``      ``OdometrySession`` (``compact``, ``state_dict`` /
                    ``meta_dict`` / ``from_state``), ``run_odometry`` and
                    ``run_odometry_chunked``.
- ``checkpoint``    ``save`` / ``load`` of a session (``torch.save``).

``python -m tpuflow_torch.vo`` is the CLI. Importing this package neither
builds a kernel nor imports triton.
"""

from tpuflow_torch.vo import (
    ba,
    checkpoint,
    device_loop,
    epipolar,
    imu,
    loop_closure,
    pipeline,
    pose_graph,
    se3,
    tracking,
    vi_graph,
)
from tpuflow_torch.vo.pipeline import (
    OdometryResult,
    OdometrySession,
    run_odometry,
    run_odometry_chunked,
)

__all__ = [
    "OdometryResult",
    "OdometrySession",
    "ba",
    "checkpoint",
    "device_loop",
    "epipolar",
    "imu",
    "loop_closure",
    "pipeline",
    "pose_graph",
    "run_odometry",
    "run_odometry_chunked",
    "se3",
    "tracking",
    "vi_graph",
]
