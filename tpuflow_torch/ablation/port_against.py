"""The port's two kernels of the reference's device control flow, the grid
seed (``csrc/seed.cu``) and the IMU scan (``csrc/imu_scan.cu``), timed
against another version of the same two sources, in turns on one card.

Builds the other directory's ``seed.cu`` and ``imu_scan.cu`` alone with the
package's nvcc flags into ``build/tpuflow_torch/against/``, checks that both
versions give the plain versions' results (the seed bit for bit on the
natural 1080p frame and a textured one at grid 16, margins 0 and 13; the
scan bit for bit against the plain loop on ``swing_imu``'s 751 samples)
and that the two scans agree bit for bit on random samples (2 to 10,000,
printing each one's distance from the plain loop in r), then times the
other version, this one, this one, the other (``eval.timing.device_ms``):
the seed at 1080p, grid 16, margin 13, taken and with a false predicate,
and on the frame's first eighth of rows; the scan at 1, 128 and 751
samples, with and without bias Jacobians; an empty kernel's launch floor
before and after. Prints one line a case, ptxas's report of the other
build, and one JSON object; a difference found by the checks fails the run
after the timings. Needs a CUDA device. For
example, against the parent commit's sources unpacked under the gitignored
``build/``:

    git archive HEAD~1 tpuflow_torch/csrc | tar -x -C build/parent
    python -m tpuflow_torch.ablation.port_against build/parent/tpuflow_torch/csrc
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import numpy as np
import torch

from tpuflow_torch.kernels import _build
from tpuflow_torch.kernels import imu as imu_kernel
from tpuflow_torch.kernels import seed

ENTRIES = ("tpuflow_seed_grid", "tpuflow_imu_preintegrate")
SOURCES = ("seed.cu", "imu_scan.cu")
GRID, MARGINS = 16, (0, 13)
SCAN_SAMPLES = (1, 128, 751)
RANDOM_SAMPLES = (2, 3, 129, 751, 10_000)


def build_other(csrc: Path) -> tuple[ctypes.CDLL, str]:
    """The other directory's two sources built alone into a shared library,
    and ptxas's log."""
    lib_path = _build.BUILD_DIR / "against" / "libport_other.so"
    log = _build.build([csrc / name for name in SOURCES], lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = list(_build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib, log


def seed_call(lib, frame, margin, predicate=None):
    """One launch of a library's seed kernel; returns (xy, alive)."""
    h, w = frame.shape
    cells = (h // GRID) * (w // GRID)
    xy = torch.empty((cells, 2), dtype=torch.float32, device=frame.device)
    alive = torch.empty((cells,), dtype=torch.bool, device=frame.device)
    stream = torch.cuda.current_stream().cuda_stream
    pred = None if predicate is None else predicate.data_ptr()
    code = lib.tpuflow_seed_grid(frame.data_ptr(), pred, None, xy.data_ptr(), alive.data_ptr(),
                                 h, w, GRID, margin, 1.0, stream)
    _build.check(_build.load(), code, "seed_grid")
    return xy, alive


def scan_call(lib, samples, n, jac):
    out = torch.empty(60 if jac else 15, dtype=torch.float32, device=samples.device)
    code = lib.tpuflow_imu_preintegrate(samples.data_ptr(), n, int(jac), out.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(), code, "imu_preintegrate")
    return out


def scan_samples(dev, jac: bool):
    """``swing_imu``'s samples as the scan takes them, (751, 13) or (751,
    31), and the plain loop's inputs."""
    from tpuflow_torch.eval import vo_verifier
    from tpuflow_torch.vo import se3

    n = vo_verifier.SEQUENCE_LENGTHS["swing_imu"]
    ts, gyro, accel, _ = vo_verifier._imu_swing(n)
    dts = np.append(np.diff(ts), np.median(np.diff(ts)))
    g, acc, h = (torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in (gyro, accel, dts))
    wh = g * h[:, None]
    args = [se3.so3_exp(wh), acc, h]
    if jac:
        args += [se3.so3_right_jacobian(wh), se3.hat(acc)]
    return imu_kernel.pack_samples(*args), args


def random_samples(dev, n: int, jac: bool):
    """``n`` random samples (seeded by ``n``) packed as the scan takes them,
    and the plain loop's inputs: gyro N(0, 0.5) rad/s, accel N(0, 3) m/s^2,
    periods U(4, 6) ms."""
    from tpuflow_torch.vo import se3

    rng = np.random.default_rng(n)
    g, a = (torch.from_numpy(rng.normal(scale=s, size=(n, 3)).astype(np.float32)).to(dev)
            for s in (0.5, 3.0))
    h = torch.from_numpy(rng.uniform(0.004, 0.006, n).astype(np.float32)).to(dev)
    wh = g * h[:, None]
    args = [se3.so3_exp(wh), a, h]
    if jac:
        args += [se3.so3_right_jacobian(wh), se3.hat(a)]
    return imu_kernel.pack_samples(*args), args


def frames(dev):
    from scipy.ndimage import gaussian_filter

    from tpuflow_torch.eval import profile

    rng = np.random.default_rng(0)
    texture = np.round(gaussian_filter(rng.uniform(0.0, 255.0, (1080, 1920)), 2.0))
    return {"natural": profile.natural_pair(device=dev)[0].contiguous(),
            "texture": torch.from_numpy(texture.astype(np.float32)).to(dev)}


def main() -> None:
    from tpuflow_torch.eval.timing import card_label, device_ms, require_cuda

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="a csrc directory with seed.cu and imu_scan.cu")
    args = parser.parse_args()
    dev = require_cuda()
    this, (other, log) = _build.load(), build_other(args.other)
    print(f"seed and scan kernels on {card_label()}: this tree's against {args.other}")
    print("other build, ptxas: " + " | ".join(
        line.strip() for line in log.splitlines() if "registers" in line or "spill" in line))
    libs = {"this": this, "other": other}

    # Both versions against the plain versions; a difference fails the run
    # after the timings.
    failures = []
    fr = frames(dev)
    for name, frame in fr.items():
        for m in MARGINS:
            want = seed.seed_grid_ref(frame, GRID, margin=m)
            for label, lib in libs.items():
                got = seed_call(lib, frame, m)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    failures.append(f"seed, {name} frame, margin {m}: the {label} version "
                                    f"differs from the plain version")
    off = torch.zeros((), dtype=torch.bool, device=dev)
    for label, lib in libs.items():
        if bool(seed_call(lib, fr["natural"], 13, predicate=off)[1].any()):
            failures.append(f"the {label} seed left a cell alive under a false predicate")
    packed = {jac: scan_samples(dev, jac) for jac in (False, True)}
    for jac, (samples, plain_args) in packed.items():
        want = torch.cat([t.reshape(-1) for t in imu_kernel.preintegrate_scan_ref(*plain_args)])
        for label, lib in libs.items():
            got = scan_call(lib, samples, samples.shape[0], jac)
            if not torch.equal(got, want):
                failures.append(f"scan, bias_jacobians={jac}: the {label} version differs from "
                                f"the plain loop by {float((got - want).abs().max())}")
    print("against the plain versions (seed: 2 frames x margins 0, 13; scan: swing_imu, 751 "
          "samples, with and without bias Jacobians): " + ("; ".join(failures) or "bit-identical"))
    # The two scans against each other on random samples, and each one's
    # distance from the plain loop in r.
    for n in RANDOM_SAMPLES:
        for jac in (False, True):
            samples, plain_args = random_samples(dev, n, jac)
            got = {label: scan_call(lib, samples, n, jac) for label, lib in libs.items()}
            r_err = float((got["this"][:9] - imu_kernel.preintegrate_scan_ref(
                *plain_args)[0].reshape(-1)).abs().max())
            same = torch.equal(got["this"], got["other"])
            print(f"scan, {n} random samples, bias_jacobians={jac}: this and other "
                  f"{'bit-identical' if same else 'differ'}; max |dr| from the plain loop "
                  f"{r_err:.3g}")
            if not same:
                failures.append(f"scan, {n} random samples, bias_jacobians={jac}: this and other "
                                f"differ by {float((got['this'] - got['other']).abs().max())}")

    natural = fr["natural"]
    eighth = natural[: natural.shape[0] // 8].contiguous()
    cases = {
        "seed 1080p grid 16 margin 13": lambda lib: seed_call(lib, natural, 13),
        "seed predicate false": lambda lib: seed_call(lib, natural, 13, predicate=off),
        f"seed {eighth.shape[0]}x{eighth.shape[1]} (an eighth of the rows)":
            lambda lib: seed_call(lib, eighth, 13),
    }
    for jac, (samples, _) in packed.items():
        for n in SCAN_SAMPLES:
            cases[f"scan {n} samples{' bias Jacobians' if jac else ''}"] = (
                lambda lib, s=samples, n=n, jac=jac: scan_call(lib, s, n, jac))
    doc = {"card": card_label(), "floor_ms": [device_ms(_build.launch_empty, reps=200)]}
    for name, run in cases.items():
        times = {"other": [], "this": []}
        for label in ("other", "this", "this", "other"):
            times[label].append(device_ms(lambda lib=libs[label]: run(lib), reps=100))
        doc[name] = times
        print(f"{name}: other {times['other'][0]:.5f} / {times['other'][1]:.5f} ms, this "
              f"{times['this'][0]:.5f} / {times['this'][1]:.5f} ms", flush=True)

    doc["floor_ms"].append(device_ms(_build.launch_empty, reps=200))
    print(f"launch floor {doc['floor_ms'][0]:.5f} / {doc['floor_ms'][1]:.5f} ms")
    print(json.dumps(doc))
    if failures:
        raise SystemExit("; ".join(failures))


if __name__ == "__main__":
    main()
