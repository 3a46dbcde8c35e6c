"""IMU sample IO: a plain-text interchange format.

One sample per line, whitespace- or comma-separated:

    t  wx wy wz  ax ay az

``t`` in seconds (strictly increasing), angular velocity in rad/s and
specific force in m/s^2 (body frame, gravity not removed). Lines starting
with ``#`` are comments. A copy of ``tpuflow.io.imu``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_imu(path: str | Path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read an IMU text file -> (times (N,), gyro (N, 3), accel (N, 3))."""
    rows = []
    for line_no, line in enumerate(Path(path).read_text().splitlines(), 1):
        line = line.strip().replace(",", " ")
        if not line or line.startswith("#"):
            continue
        vals = line.split()
        if len(vals) != 7:
            raise ValueError(
                f"{path}:{line_no}: expected 7 columns (t wx wy wz ax ay az), got {len(vals)}"
            )
        rows.append([float(v) for v in vals])
    if not rows:
        raise ValueError(f"{path}: no IMU samples")
    arr = np.asarray(rows, np.float64)
    t = arr[:, 0]
    if not (np.diff(t) > 0).all():
        raise ValueError(f"{path}: timestamps must be strictly increasing")
    return t, arr[:, 1:4].astype(np.float32), arr[:, 4:7].astype(np.float32)


def save_imu(
    path: str | Path,
    times: np.ndarray,
    gyro: np.ndarray,
    accel: np.ndarray,
    header: str = "",
) -> None:
    """Write samples in the text format ``load_imu`` reads."""
    lines = ["# t wx wy wz ax ay az" + (f" | {header}" if header else "")]
    for t, w, a in zip(np.asarray(times), np.asarray(gyro), np.asarray(accel)):
        lines.append(
            f"{t:.9f} {w[0]:.9f} {w[1]:.9f} {w[2]:.9f} "
            f"{a[0]:.9f} {a[1]:.9f} {a[2]:.9f}"
        )
    Path(path).write_text("\n".join(lines) + "\n")
