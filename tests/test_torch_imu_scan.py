"""IMU preintegration's recursion (``tpuflow_torch.kernels.imu``) against
``tpuflow.vo.imu.preintegrate`` on the CPU.

On CPU tensors the scan's wrapper runs its plain version, the loop over
samples; the CUDA kernel (``csrc/imu_scan.cu``) is held against that loop
on the card in ``tests/test_torch_gpu.py``. Limits: the wrapper's CPU route
is the plain loop bit for bit and launches nothing; ``preintegrate``
through it is within 5e-6 of the reference in every field, as
``tests/test_torch_vo_graph.py::test_preintegrate_matches`` holds, at
N = 1, 2 and 150 samples, scalar and per-sample ``dt``, with and without
biases and bias Jacobians.
"""

import numpy as np
import pytest
import torch

from tpuflow.vo import imu as jimu
from tpuflow_torch.kernels import imu as imu_kernel
from tpuflow_torch.kernels import launch_counts
from tpuflow_torch.vo import imu, se3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread, as tests/test_torch_vo.py does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(n, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.5, size=(n, 3)).astype(np.float32),
            rng.normal(scale=3.0, size=(n, 3)).astype(np.float32),
            rng.uniform(0.004, 0.006, n))


@pytest.mark.parametrize("n", [1, 2, 150])
@pytest.mark.parametrize("per_sample_dt", [False, True])
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("jacobians", [False, True])
def test_preintegrate_through_the_scan_matches(n, per_sample_dt, biased, jacobians):
    gyro, accel, dts = _samples(n)
    dt = dts if per_sample_dt else 0.005
    kw = dict(gyro_bias=[0.01, -0.02, 0.015], accel_bias=[0.05, -0.08, 0.03]) if biased else {}
    before = launch_counts()
    got = imu.preintegrate(gyro, accel, dt, bias_jacobians=jacobians, device="cpu", **kw)
    assert launch_counts() == before
    want = jimu.preintegrate(gyro, accel, dt, bias_jacobians=jacobians, **kw)
    assert got.n_samples == want.n_samples == n
    for name, a, b in zip(want._fields, got, want):
        if name == "n_samples" or b is None:
            assert (a is None) == (b is None), name
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=5e-6, err_msg=name)


@pytest.mark.parametrize("jacobians", [False, True])
def test_cpu_route_is_the_plain_loop(jacobians):
    gyro, accel, dts = _samples(40, seed=9)
    g, a, h = (torch.from_numpy(x.astype(np.float32)) for x in (gyro, accel, dts))
    wh = g * h[:, None]
    args = [se3.so3_exp(wh), a, h]
    if jacobians:
        args += [se3.so3_right_jacobian(wh), se3.hat(a)]
    got = imu_kernel.preintegrate_scan(*args)
    want = imu_kernel.preintegrate_scan_ref(*args)
    assert len(got) == (8 if jacobians else 3)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_scan_of_no_sample_is_the_identity():
    z = torch.zeros(0, 3)
    r, v, p = imu_kernel.preintegrate_scan(torch.zeros(0, 3, 3), z, torch.zeros(0))
    assert torch.equal(r, torch.eye(3)) and not v.any() and not p.any()


def test_scan_refuses_what_it_does_not_take():
    steps, accel, dts = torch.zeros(4, 3, 3), torch.zeros(4, 3), torch.zeros(4)
    with pytest.raises(ValueError):
        imu_kernel.preintegrate_scan(steps, accel, torch.zeros(5))
    with pytest.raises(ValueError):
        imu_kernel.preintegrate_scan(steps, accel.double(), dts)
    with pytest.raises(ValueError):
        imu_kernel.preintegrate_scan(steps, accel, dts, right=steps)  # a_hats missing
