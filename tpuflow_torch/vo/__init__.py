"""Visual odometry: the incremental path of ``tpuflow.vo``.

- ``se3``          SE(3) / SO(3) helpers.
- ``tracking``     Shi-Tomasi grid seeding and flow-driven track advance.
- ``device_loop``  the front end's step on the device (``FrontEnd``).
- ``ba``           bundle adjustment (Schur complement, Huber, LM).
- ``epipolar``     essential-matrix two-view initialization.
- ``pipeline``     ``OdometrySession`` and ``run_odometry``.

Importing this package neither builds a kernel nor imports triton.
"""

from tpuflow_torch.vo import ba, device_loop, epipolar, pipeline, se3, tracking
from tpuflow_torch.vo.pipeline import OdometryResult, OdometrySession, run_odometry

__all__ = [
    "OdometryResult",
    "OdometrySession",
    "ba",
    "device_loop",
    "epipolar",
    "pipeline",
    "run_odometry",
    "se3",
    "tracking",
]
