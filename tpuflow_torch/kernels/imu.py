"""IMU preintegration's recursion: the CUDA scan kernel and its plain
PyTorch version.

Counterpart of the ``jax.lax.scan`` over samples in
``tpuflow.vo.imu.preintegrate`` (jnp in the reference; no Pallas kernel).
The per-sample terms that do not depend on the carry come in computed for
all samples at once (``vo.imu.preintegrate`` makes them): ``steps`` the
(N, 3, 3) rotation steps Exp(w h), ``accel`` the (N, 3) bias-corrected
specific force, ``dts`` the (N,) periods and, for the bias Jacobians,
``right`` the (N, 3, 3) right Jacobians J_r(w h) and ``a_hats`` the (N, 3,
3) hat(accel). Each sample then updates, in the reference's order:

    (bias Jacobians, with the pre-update r, j_r and j_v*)
    j_pg += j_vg h - 0.5 (r a^ j_r) h h;  j_pa += j_va h - 0.5 r h h
    j_vg -= (r a^ j_r) h;  j_va -= r h;  j_r = step^T j_r - J_r h
    a_world = r a;  p += v h + 0.5 a_world h h;  v += a_world h;  r = r step

``preintegrate_scan`` launches the CUDA kernel (``csrc/imu_scan.cu``, one
launch for all N samples) for CUDA tensors and runs
``preintegrate_scan_ref``, the loop over samples in float32, for CPU
tensors. Both return (r, v, p), or (r, v, p, j_r, j_v_bg, j_v_ba, j_p_bg,
j_p_ba) with the Jacobians' inputs given. The plain loop's matmuls run as
its caller set TF32 (``vo.imu.preintegrate`` turns it off).
"""

from __future__ import annotations

import torch

from tpuflow_torch.kernels import _build

# Kernel launches; incremented only where the kernel is launched.
launch_counts = {"imu_preintegrate": 0}


def preintegrate_scan_ref(
    steps: torch.Tensor,
    accel: torch.Tensor,
    dts: torch.Tensor,
    right: torch.Tensor | None = None,
    a_hats: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``preintegrate_scan``: a loop over the
    samples, a handful of small torch operations each, in the inputs' dtype
    (float32 as the kernel; float64 gives a reference for float32's
    rounding)."""
    dev, dtype = steps.device, steps.dtype
    r = torch.eye(3, dtype=dtype, device=dev)
    v = torch.zeros(3, dtype=dtype, device=dev)
    p = torch.zeros(3, dtype=dtype, device=dev)
    n = steps.shape[0]
    if right is None:
        for k in range(n):
            h = dts[k]
            a_world = r @ accel[k]
            p = p + v * h + 0.5 * a_world * h * h
            v = v + a_world * h
            r = r @ steps[k]
        return r, v, p

    j_r, j_vg, j_va, j_pg, j_pa = (torch.zeros((3, 3), dtype=dtype, device=dev)
                                   for _ in range(5))
    for k in range(n):
        h, a, step_r = dts[k], accel[k], steps[k]
        a_world = r @ a
        # The bias Jacobians use the pre-update r, j_r and j_v*.
        r_a_jr = r @ a_hats[k] @ j_r
        j_pg = j_pg + j_vg * h - 0.5 * r_a_jr * h * h
        j_pa = j_pa + j_va * h - 0.5 * r * h * h
        j_vg = j_vg - r_a_jr * h
        j_va = j_va - r * h
        j_r = step_r.T @ j_r - right[k] * h
        p = p + v * h + 0.5 * a_world * h * h
        v = v + a_world * h
        r = r @ step_r
    return r, v, p, j_r, j_vg, j_va, j_pg, j_pa


def _check(steps, accel, dts, right, a_hats) -> int:
    n = steps.shape[0]
    if (right is None) != (a_hats is None):
        raise ValueError("the bias Jacobians need both right and a_hats")
    shapes = [(steps, (n, 3, 3)), (accel, (n, 3)), (dts, (n,))]
    if right is not None:
        shapes += [(right, (n, 3, 3)), (a_hats, (n, 3, 3))]
    for t, shape in shapes:
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != steps.device:
            raise ValueError(f"expected float32 {shape} on {steps.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if steps.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {steps.device}")
    return n


def pack_samples(steps, accel, dts, right=None, a_hats=None) -> torch.Tensor:
    """The kernel's input rows: (N, 13) [Exp(w h) row-major, accel, dt], or
    (N, 31) with the right Jacobian and hat(accel) after them."""
    n = steps.shape[0]
    cols = [steps.reshape(n, 9), accel, dts[:, None]]
    if right is not None:
        cols += [right.reshape(n, 9), a_hats.reshape(n, 9)]
    return torch.cat(cols, dim=1).contiguous()


def preintegrate_scan(
    steps: torch.Tensor,
    accel: torch.Tensor,
    dts: torch.Tensor,
    right: torch.Tensor | None = None,
    a_hats: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """The recursion over all samples: one CUDA kernel launch for CUDA
    tensors, the plain loop for CPU tensors; a launch that fails raises."""
    n = _check(steps, accel, dts, right, a_hats)
    if steps.device.type == "cpu":
        return preintegrate_scan_ref(steps, accel, dts, right, a_hats)
    jac = right is not None
    samples = pack_samples(steps, accel, dts, right, a_hats)
    out = torch.empty(60 if jac else 15, dtype=torch.float32, device=steps.device)
    lib = _build.load()
    stream = torch.cuda.current_stream(steps.device).cuda_stream
    code = lib.tpuflow_imu_preintegrate(samples.data_ptr(), n, int(jac), out.data_ptr(), stream)
    _build.check(lib, code, "imu_preintegrate")
    launch_counts["imu_preintegrate"] += 1
    parts = [out[:9].view(3, 3), out[9:12], out[12:15]]
    if jac:
        parts += [out[15 + 9 * i: 24 + 9 * i].view(3, 3) for i in range(5)]
    return tuple(parts)
