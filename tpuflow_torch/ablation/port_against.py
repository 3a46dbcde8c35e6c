"""The port's kernels of the reference's device control flow, the grid seed
(``csrc/seed.cu``), the IMU scan (``csrc/imu_scan.cu``), K6's tile round
(``csrc/lk_fused.cu`` with its ``lk_tile.cuh``) and the banded warp's round
on the coarse planes (``csrc/warp.cu`` with its ``warp.cuh``), timed
against another version of the same sources, in turns on one card.

Builds the other directory's ``seed.cu``, ``imu_scan.cu``, ``lk_fused.cu``
and ``warp.cu`` (each with that directory's headers) alone with the
package's nvcc flags into ``build/tpuflow_torch/against/``, and this tree's
``warp.cu`` alone beside it for ptxas's report; checks that both versions
give the plain versions' results (the seed bit for bit on the natural 1080p
frame and a textured one at grid 16, margins 0 and 13; the scan bit for bit
against the plain loop on ``swing_imu``'s 751 samples; the tile round's u,
v and control bit for bit, running and skipped, at the 1080p world-1
extended tiles, window 5; the warp round bit for bit against
``warp.warp_round_ref``, running and skipped, at bands 2 / 3 / 8 for K2
(``u16``) and K4 (``exact``) at 540x960 and 270x480, and at one band index
a plane (0 / 2 / 1 / 2) on B=4 batches of both) and that the two
scans agree bit for bit on random samples (2 to 10,000, printing each
one's distance from the plain loop in r), then times the other version,
this one, this one, the other (``eval.timing.device_ms``): the seed at
1080p, grid 16, margin 13, taken and with a false predicate, and on the
frame's first eighth of rows; the scan at 1, 128 and 751 samples, with and
without bias Jacobians; the tile round running and skipped at each tile,
each version through its own C signature (one without a ``sums`` argument
is followed by ``torch.sum`` of its block partials, as its wrapper did);
the warp round's breakdown at each warp case (an empty kernel on that
version's grid, skipped, band 8 on zero and on random +-9 px flow, band 2,
the entry ``tpuflow_warp_banded``; the plain round once); an empty
kernel's launch floor before and after. Prints one line a case, ptxas's
report of both builds, and one JSON object; a difference found by the
checks fails the run after the timings. Needs a CUDA device. For example,
against the parent commit's sources unpacked under the gitignored
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

from tpuflow_torch.kernels import _build, warp
from tpuflow_torch.kernels import imu as imu_kernel
from tpuflow_torch.kernels import seed

ENTRIES = ("tpuflow_seed_grid", "tpuflow_imu_preintegrate", "tpuflow_lk_fused_tile_round",
           "tpuflow_warp_round", "tpuflow_warp_banded")
SOURCES = ("seed.cu", "imu_scan.cu", "lk_fused.cu", "warp.cu")
GRID, MARGINS = 16, (0, 13)
SCAN_SAMPLES = (1, 128, 751)
RANDOM_SAMPLES = (2, 3, 129, 751, 10_000)
# The tile round's extended tiles on the 1080p world-1 path (window 5).
TILE_SHAPES = ((1086, 1926), (546, 966), (276, 486))
TILE_WINDOW = 5
# A tile round entry without the sums argument (its wrapper summed the
# block partials with torch.sum after it).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
TILE_ROUND_PARTS_ONLY = (_P,) * 7 + (_I,) * 10 + (_F, _P)
# The warp round's cases: K2 and K4 at the 1080p pyramids' coarse planes,
# and a B=4 batch of each with one band index a plane.
WARP_SHAPES = ((540, 960), (270, 480), (4, 540, 960), (4, 270, 480))
WARP_PACKINGS = ("u16", "exact")
WARP_LADDER = (2, 3, 8)
WARP_MIXED = (0, 2, 1, 2)


def with_sums(lib) -> bool:
    """Whether a library's tile round finishes its own sums (its C entry
    takes a ``sums`` pointer; such a library exports its own block count)."""
    return hasattr(lib, "tpuflow_lk_tile_round_blocks")


def build_other(csrc: Path) -> tuple[ctypes.CDLL, str]:
    """The other directory's sources built alone into a shared library, and
    ptxas's log."""
    lib_path = _build.BUILD_DIR / "against" / "libport_other.so"
    log = _build.build([csrc / name for name in SOURCES], lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = list(_build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    lib.tpuflow_warp_geometry.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
    lib.tpuflow_warp_geometry.restype = None
    if with_sums(lib):
        lib.tpuflow_lk_tile_round_blocks.argtypes = [_I, _I, _I]
        lib.tpuflow_lk_tile_round_blocks.restype = _I
    else:
        lib.tpuflow_lk_fused_tile_round.argtypes = list(TILE_ROUND_PARTS_ONLY)
    return lib, log


def warp_ptxas() -> str:
    """ptxas's report of this tree's ``warp.cu`` built alone."""
    return _build.build([_build.CSRC / "warp.cu"],
                        _build.BUILD_DIR / "against" / "libport_this_warp.so")


def ptxas_lines(log: str) -> str:
    """Each kernel's registers and spill stores, by name and template
    arguments."""
    return "; ".join(f"{name} {regs} regs/{spill} B spilled"
                     for name, regs, spill in _build.ptxas_entries(log))


def warp_geometry(lib, height: int, width: int) -> dict:
    """A library's warp block at a plane (its entry writes 5 or 6 ints)."""
    out = (_I * 8)()
    lib.tpuflow_warp_geometry(height, width, 8, 8, out)
    return {"tile_w": out[1], "rows": out[2], "threads": out[3]}


def warp_round_call(lib, img, u, v, out, latch, band, packing, ladder=WARP_LADDER,
                    max_disp=8):
    """One library's warp round (the flow clamped) into out, through its C
    entry: ``warp.warp_round``'s call on another build."""
    h, w = img.shape[-2:]
    bands = (_I * len(ladder))(*ladder)
    code = lib.tpuflow_warp_round(
        img.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), latch.data_ptr(),
        None if band is None else band.data_ptr(), 0 if band is None else band.numel(), bands,
        len(ladder), img.shape[0] if img.ndim == 3 else 1, h, w, max_disp,
        warp.PACKINGS[packing], torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(), code, "warp round")
    return out


def warp_entry_call(lib, img, u, v, out, packing):
    """One library's warp entry at band 8, the flow clamped."""
    h, w = img.shape[-2:]
    code = lib.tpuflow_warp_banded(
        img.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
        img.shape[0] if img.ndim == 3 else 1, h, w, 8, 8, warp.PACKINGS[packing], 1,
        torch.cuda.current_stream().cuda_stream)
    _build.check(_build.load(), code, "warp entry")
    return out


def warp_inputs(dev, shape):
    """An 8-bit image, random +-9 px flow, zero flow and a fill (seeded by
    the shape)."""
    rng = np.random.default_rng(sum(shape))

    def rand(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)

    img = rand(0.0, 255.0).round()
    u, v = rand(-9.0, 9.0), rand(-9.0, 9.0)
    return img, u, v, torch.zeros_like(u), rand(-1.0, 1.0)


def warp_bands(dev, shape) -> list[torch.Tensor]:
    """The band indices a warp case is checked at: each rung for a plane,
    one a plane for a batch."""
    if len(shape) == 3:
        return [torch.tensor(WARP_MIXED[:shape[0]], dtype=torch.int32, device=dev)]
    return [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(len(WARP_LADDER))]


def check_warp(libs, cases) -> list[str]:
    """Each library's warp round against the plain version at each case,
    band and latch: bit for bit, and a skipped round leaves out as it was."""
    failures = []
    for (shape, packing), (img, u, v, _, fill) in cases.items():
        batch = shape[0] if len(shape) == 3 else 1
        for band in warp_bands(img.device, shape):
            for latch in (0, 1):
                flag = torch.full((batch,), latch, dtype=torch.int32, device=img.device)
                want = warp.warp_round_ref(img, u, v, fill.clone(), flag, max_disp=8,
                                           ladder=WARP_LADDER, band=band, packing=packing)
                for label, lib in libs.items():
                    got = warp_round_call(lib, img, u, v, fill.clone(), flag, band, packing)
                    if not (torch.equal(got, want) and (not latch or torch.equal(got, fill))):
                        failures.append(f"warp round {'x'.join(map(str, shape))} {packing}, "
                                        f"bands {band.tolist()}, latch {latch}: the {label} "
                                        f"version differs from the plain version")
    return failures


def warp_steps(dev, libs, shape, packing, img, u, v, zero) -> dict:
    """One warp case's breakdown as timed steps: step -> fn(lib)."""
    batch = shape[0] if len(shape) == 3 else 1
    dst = torch.empty_like(img)
    run = torch.zeros(batch, dtype=torch.int32, device=dev)
    skip = torch.ones(batch, dtype=torch.int32, device=dev)
    bands = warp_bands(dev, shape)
    b8, b2 = bands[-1], bands[0]
    grids = {id(lib): warp_geometry(lib, *shape[-2:]) for lib in libs.values()}
    steps = {
        "empty kernel on its grid": lambda lib: warp.launch_empty_on_grid(
            *shape[-2:], batch, grids[id(lib)]),
        "skipped": lambda lib: warp_round_call(lib, img, u, v, dst, skip, b8, packing),
        "band 8 zero flow": lambda lib: warp_round_call(lib, img, zero, zero, dst, run, b8,
                                                        packing),
        "band 8": lambda lib: warp_round_call(lib, img, u, v, dst, run, b8, packing),
        "band 2": lambda lib: warp_round_call(lib, img, u, v, dst, run, b2, packing),
        "entry": lambda lib: warp_entry_call(lib, img, u, v, dst, packing),
    }
    if batch > 1:  # one mixed band index a plane: no band 8 / band 2 split
        del steps["band 2"]
    return steps


def warp_timings(dev, libs, cases) -> dict:
    """The warp round's breakdown as timed cases: name -> fn(lib)."""
    out = {}
    for (shape, packing), (img, u, v, zero, _) in cases.items():
        label = f"warp round {'x'.join(map(str, shape))} {packing}"
        for step, fn in warp_steps(dev, libs, shape, packing, img, u, v, zero).items():
            out[f"{label} {step}"] = fn
    return out


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


def tile_inputs(dev, shape):
    """An extended tile's frames (a textured frame and it shifted by 1 px
    plus noise, seeded by the shape) and the crop's flow."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(shape[0])
    prev = np.round(gaussian_filter(rng.uniform(0.0, 255.0, shape), 2.0))
    warped = np.roll(prev, 1, axis=1) + rng.normal(0.0, 0.5, shape)
    ext = TILE_WINDOW // 2 + 1
    crop = (shape[0] - 2 * ext, shape[1] - 2 * ext)
    u, v = (rng.uniform(-3.0, 3.0, crop) for _ in range(2))
    return [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (prev, warped, u, v)]


class TileRound:
    """One library's tile round on one extended tile at the world-1 tile
    origin (the whole level), through the library's own C signature."""

    def __init__(self, lib, prev, warped):
        self.lib, self.prev, self.warped = lib, prev, warped
        self.shape = tuple(prev.shape)
        self.ext = TILE_WINDOW // 2 + 1
        this = _build.load()
        blocks = (lib.tpuflow_lk_tile_round_blocks if with_sums(lib)
                  else this.tpuflow_lk_refine_blocks)(*self.shape, TILE_WINDOW)
        self.parts = torch.empty((2, 1, blocks), dtype=torch.float32, device=prev.device)
        self.sums = torch.empty(2, dtype=torch.float32, device=prev.device)

    def __call__(self, u, v, ctrl):
        """One round on u, v in place; returns the sums (a skipped round's
        are stale)."""
        h, w = u.shape
        args = [self.prev.data_ptr(), self.warped.data_ptr(), u.data_ptr(), v.data_ptr(),
                ctrl.data_ptr(), self.parts[0].data_ptr(), self.parts[1].data_ptr()]
        if with_sums(self.lib):
            args.append(self.sums.data_ptr())
        code = self.lib.tpuflow_lk_fused_tile_round(
            *args, 1, *self.shape, self.ext, 0, 0, h, w, TILE_WINDOW, 0, 1e-4,
            torch.cuda.current_stream().cuda_stream)
        _build.check(_build.load(), code, "lk_fused_tile_round")
        return self.sums if with_sums(self.lib) else self.parts[:, 0].sum(dim=1)


def check_tile_round(libs, tiles) -> list[str]:
    """Each library's tile round against the plain version at each tile:
    u, v and the control bit for bit, running and skipped."""
    from tpuflow_torch.kernels import lk

    failures = []
    for shape, (prev, warped, u, v) in tiles.items():
        h, w = u.shape
        kw = dict(gy0=0, gx0=0, gh=h, gw=w, window_size=TILE_WINDOW)
        for latch in (0, 1):
            ctrl0 = torch.tensor([latch, 0, 2], dtype=torch.int32, device=u.device)
            want = [t.clone() for t in (u, v, ctrl0)]
            lk.fused_tile_round_ref(prev, warped, *want, **kw)
            for label, lib in libs.items():
                got = [t.clone() for t in (u, v, ctrl0)]
                TileRound(lib, prev, warped)(*got)
                if not all(torch.equal(g, x) for g, x in zip(got, want)):
                    failures.append(f"tile round {shape[0]}x{shape[1]}, latch {latch}: the "
                                    f"{label} version differs from the plain version")
    return failures


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
    parser.add_argument("other", type=Path,
                        help="a csrc directory with seed.cu, imu_scan.cu, lk_fused.cu, "
                             "lk_tile.cuh, warp.cu, warp.cuh")
    args = parser.parse_args()
    dev = require_cuda()
    this, (other, log) = _build.load(), build_other(args.other)
    print(f"seed, scan, tile round and warp round kernels on {card_label()}: this tree's "
          f"against {args.other}")
    print("other build, ptxas: " + ptxas_lines(log))
    print("this tree's warp.cu, ptxas: " + ptxas_lines(warp_ptxas()))
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
    tiles = {shape: tile_inputs(dev, shape) for shape in TILE_SHAPES}
    failures += check_tile_round(libs, tiles)
    warps = {(shape, packing): warp_inputs(dev, shape)
             for shape in WARP_SHAPES for packing in WARP_PACKINGS}
    failures += check_warp(libs, warps)
    print("against the plain versions (seed: 2 frames x margins 0, 13; scan: swing_imu, 751 "
          "samples, with and without bias Jacobians; tile round: the 1080p world-1 extended "
          "tiles, running and skipped; warp round: K2 and K4 at 540x960 and 270x480, bands "
          "2 / 3 / 8, and B=4 batches of both with mixed bands, running and skipped): "
          + ("; ".join(failures) or "bit-identical"))
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
    run = torch.zeros(3, dtype=torch.int32, device=dev)
    skip = torch.tensor([1, 0, 0], dtype=torch.int32, device=dev)
    for shape, (prev, warped, u, v) in tiles.items():
        rounds = {label: TileRound(lib, prev, warped) for label, lib in libs.items()}
        uw, vw = u.clone(), v.clone()  # the timed rounds add into these
        for what, ctrl in (("running", run), ("skipped", skip)):
            cases[f"tile round {shape[0]}x{shape[1]} {what}"] = (
                lambda lib, r=rounds, c=ctrl, uw=uw, vw=vw:
                r["this" if lib is this else "other"](uw, vw, c))
    cases.update(warp_timings(dev, libs, warps))
    doc = {"card": card_label(), "floor_ms": [device_ms(_build.launch_empty, reps=200)]}
    for (shape, packing), (img, u, v, _, _) in warps.items():
        batch = shape[0] if len(shape) == 3 else 1
        band, out = warp_bands(dev, shape)[-1], torch.empty_like(img)
        zero = torch.zeros(batch, dtype=torch.int32, device=dev)
        name = f"warp round {'x'.join(map(str, shape))} {packing} plain"
        doc[name] = device_ms(lambda: warp.warp_round_ref(
            img, u, v, out, zero, max_disp=8, ladder=WARP_LADDER, band=band, packing=packing))
        print(f"{name}: {doc[name]:.5f} ms", flush=True)
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
