"""Long IMU segments: the port's ``preintegrate`` (the plain loop on the
CPU) against ``tpuflow.vo.imu.preintegrate`` at ``swing_imu``'s 751
samples and at 4,000 samples from a seeded generator, with and without
bias Jacobians.

Each field is held to a share of its largest entry, set from the reading
(ROADMAP.md section 3, "Measured differences"):

- ``swing_imu`` (zero gyro, so r is the identity on both sides): r, v, p
  and the Jacobians equal; ``dt`` (a float32 sum of 751 steps) 3.2e-7 and
  ``j_p_ba`` 6.8e-8 of their largest entries. Held to 1e-6, three times
  the largest reading.
- 4,000 random samples: r 1.5e-5, v 1.2e-5, p 6.1e-6, the Jacobians
  6.0e-6 to 1.6e-5 (``j_p_bg``) of their largest entries; ``dt`` equal.
  The two float32 recursions round their 3x3 products in other orders,
  and 4,000 steps carry that. Held to 5e-5, three times the largest
  reading.
"""

import numpy as np
import pytest
import torch

from tpuflow.eval import vo_verifier as jax_vo_verifier
from tpuflow.vo import imu as jimu
from tpuflow_torch.vo import imu

torch.set_num_threads(1)

SWING_SHARE = 1e-6
RANDOM_SHARE = 5e-5


def _swing():
    ts, gyro, accel, _ = jax_vo_verifier._imu_swing(jax_vo_verifier.SEQUENCE_LENGTHS["swing_imu"])
    dts = np.append(np.diff(ts), np.median(np.diff(ts)))
    return gyro, accel, dts


def _random(n=4000, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.5, size=(n, 3)).astype(np.float32),
            rng.normal(scale=3.0, size=(n, 3)).astype(np.float32),
            rng.uniform(0.004, 0.006, n))


@pytest.mark.parametrize("jacobians", [False, True])
@pytest.mark.parametrize("case, samples, share", [("swing_imu", 751, SWING_SHARE),
                                                  ("random", 4000, RANDOM_SHARE)])
def test_long_segment_matches_the_reference(case, samples, share, jacobians):
    gyro, accel, dt = _swing() if case == "swing_imu" else _random()
    got = imu.preintegrate(gyro, accel, dt, bias_jacobians=jacobians, device="cpu")
    want = jimu.preintegrate(gyro, accel, dt, bias_jacobians=jacobians)
    assert got.n_samples == int(want.n_samples) == samples
    for name, a, b in zip(want._fields, got, want):
        if name == "n_samples" or b is None:
            assert (a is None) == (b is None), name
            continue
        b = np.asarray(b)
        assert np.all(np.isfinite(a.numpy())), name
        err = float(np.abs(a.numpy() - b).max())
        assert err <= share * float(np.abs(b).max()), (name, err, float(np.abs(b).max()))
