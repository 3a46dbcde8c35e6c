"""The coarse planes' warp body at other block shapes and load orders.

The banded warp (``csrc/warp.cu``) gathers its corners through L1 on
planes under 2**20 pixels (K2 at the coarse pyramid levels, K4 there) with
``warp_gather_kernel`` (``csrc/warp.cuh``): each thread one, two or four
consecutive columns (the flow and output as 8- or 16-byte accesses where
the bases allow) of one or more rows, and under device control the latch,
the band index and the flow loaded in one memory round trip (the package
takes one column, one row below 2**18 pixels and four above). This module
builds that
kernel at every shape of ``VARIANTS`` (columns a thread, threads across and
down, rows a thread, and whether the flow leaves with the control words or
after the latch's test) alone with the package's nvcc flags into
``build/tpuflow_torch/warp_gather/`` and, as a device-controlled round (the
flow clamped, ladder 2/3/8), at 540x960 and 270x480 in packings ``u16``
(K2) and ``exact`` (K4), and on B=4 batches of both with one band index a
plane (0/2/1/2):

- checks each against ``warp.warp_round_ref`` bit for bit at every band,
  running and skipped (a skipped round leaves ``out`` as it was);
- times it (``eval.timing.device_ms``) at band 8 on random +-9 px flow, on
  zero flow, at band 2, skipped, and an empty kernel on its grid, beside
  the package's own kernel and the launch floor.

``--frames`` then times the graphed 1080p ``production`` and ``default``
streams (``flow.GraphedStream``, 1080p textured frames moving 2 px; with
``--batch N``, N such streams in one replay, their textures rolled apart)
with the coarse planes' rounds routed through the named variants, through
the package's kernel and (``--against DIR``) every round through another
directory's ``warp.cu`` built alone, in turns (each A, B, ..., then back),
CUDA events around ``FRAME_STEPS`` replays; a variant named with a ``p``
suffix is launched as a programmatic dependent launch
(``cudaLaunchKernelEx`` with programmatic stream serialization; the body's
``griddepcontrol.wait`` holds it until the kernel before has finished),
its flows held bit for bit against the package's. Prints one line a case,
ptxas's report of the variants and one JSON object; a difference fails
the run after the timings. Needs a CUDA device:

    python -m tpuflow_torch.ablation.warp_gather [--frames 11/18,11/4,11/18p] [--batch 4]
        [--against DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
from pathlib import Path

import numpy as np
import torch

from tpuflow_torch.ablation.port_against import WARP_LADDER as LADDER
from tpuflow_torch.ablation.port_against import WARP_MIXED as MIXED_BANDS
from tpuflow_torch.ablation.port_against import WARP_PACKINGS as PACKINGS
from tpuflow_torch.ablation.port_against import WARP_SHAPES as SHAPES
from tpuflow_torch.ablation.port_against import warp_inputs, warp_round_call
from tpuflow_torch.kernels import _build, warp

# (columns a thread, threads across, threads down, rows a thread, flow with
# the control words, blocks an SM the registers are capped for: 1 leaves
# them free).
VARIANTS = (
    (1, 32, 8, 2, False, 1),
    (1, 32, 8, 2, True, 1),
    (1, 32, 8, 1, True, 1),
    (2, 32, 8, 2, True, 1),
    (1, 32, 8, 2, True, 8),
    (1, 32, 16, 2, True, 4),
    (1, 32, 16, 1, True, 4),
    (1, 32, 32, 1, True, 2),
    (1, 32, 16, 2, False, 4),
    (2, 32, 8, 2, True, 8),
    (1, 32, 8, 4, True, 1),
    (1, 32, 8, 4, True, 8),
    (1, 32, 16, 1, True, 1),
    (1, 32, 32, 1, True, 1),
    (1, 32, 4, 2, True, 1),
    (1, 32, 16, 4, True, 4),
    (4, 32, 8, 1, True, 1),
    (1, 32, 8, 2, False, 8),
    (1, 32, 8, 1, True, 8),
    (1, 32, 8, 4, False, 8),
    (1, 32, 8, 1, False, 8),
)
# The package's own split (csrc/warp.cu kSmallPixels): planes under this
# many pixels take the small planes' block.
SMALL_PIXELS = 1 << 18
FRAME_STEPS = 64
FRAME_TURNS = 4
WORK = _build.BUILD_DIR / "warp_gather"

ENTRY = r"""
#include "{header}"
using namespace tpuflow_warp;
namespace {{
template <int kPacking, int kCols, int kTx, int kTy, int kPasses, bool kFirst, int kMin>
int run(const Args& a, int pdl, cudaStream_t s) {{
  const dim3 grid((a.width + kTx * kCols - 1) / (kTx * kCols),
                  (a.height + kTy * kPasses - 1) / (kTy * kPasses), a.batch);
  auto kernel = warp_gather_kernel<kPacking, true, kCols, kTx, kTy, kPasses, kFirst, kMin>;
  if (!pdl) {{
    kernel<<<grid, kTx * kTy, 0, s>>>(a.img, a.u, a.v, a.out, a.height, a.width, a.max_disp,
                                      a.widest, a.vec, a.ctl);
    return (int)cudaGetLastError();
  }}
  // Programmatic dependent launch: the grid may start while the kernel
  // before drains; the body waits for it (griddepcontrol.wait).
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {{}};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kTx * kTy);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a.img, a.u, a.v, a.out, a.height, a.width,
                                 a.max_disp, a.widest, a.vec, a.ctl);
}}
}}  // namespace
extern "C" int gather_round(int variant, int packing, int pdl, const float* img, const float* u,
                            const float* v, float* out, const int* latch, const int* band,
                            int n_band, const int* ladder, int n_ladder, int batch, int height,
                            int width, int max_disp, void* stream) {{
  Args a{{img, u, v, out, batch, height, width, max_disp, 0, copy_flags(img, u, v, width, out),
         Control{{latch, band, {{}}, n_ladder, n_band > 1 ? 1 : 0}}}};
  for (int i = 0; i < n_ladder && i < kMaxLadder; ++i) {{
    a.ctl.ladder[i] = ladder[i];
    if (ladder[i] > a.widest) a.widest = ladder[i];
  }}
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant * 2 + (packing == 16)) {{
{cases}
    default: return (int)cudaErrorInvalidValue;
  }}
}}
"""
ARGS = r"""
struct Args {
  const float* img;
  const float* u;
  const float* v;
  float* out;
  int batch, height, width, max_disp, widest, vec;
  Control ctl;
};
"""


def variant_name(variant: tuple) -> str:
    cols, tx, ty, passes, first, min_blocks = variant
    return (f"{cols} col{'s' if cols > 1 else ''} x {passes} row{'s' if passes > 1 else ''} a "
            f"thread, {tx}x{ty} threads ({tx * cols}x{ty * passes} block"
            + (f", {min_blocks} an SM" if min_blocks > 1 else "") + "), flow "
            f"{'with the control words' if first else 'after the latch'}")


def geometry(variant: tuple) -> dict:
    """A variant's block in ``warp.tile_geometry``'s keys."""
    cols, tx, ty, passes, _, _ = variant
    return {"staged": 0, "tile_w": tx * cols, "rows": ty * passes, "threads": tx * ty,
            "smem_bytes": 0, "cols": cols}


def build() -> tuple[ctypes.CDLL, str]:
    """Every variant in both packings, built alone; the library and
    ptxas's report."""
    WORK.mkdir(parents=True, exist_ok=True)
    cases = []
    for i, (cols, tx, ty, passes, first, min_blocks) in enumerate(VARIANTS):
        for packing, odd in ((0, 0), (16, 1)):
            cases.append(f"    case {2 * i + odd}: return run<{packing}, {cols}, {tx}, {ty}, "
                         f"{passes}, {'true' if first else 'false'}, {min_blocks}>(a, pdl, s);")
    header = (_build.CSRC / "warp.cuh").resolve()
    src = ENTRY.format(header=header, cases="\n".join(cases))
    src = src.replace("namespace {\n", "namespace {\n" + ARGS, 1)
    (WORK / "warp_gather.cu").write_text(src)
    path = WORK / "libwarp_gather.so"
    log = _build.build([WORK / "warp_gather.cu"], path)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gather_round.argtypes = [i, i, i] + [p] * 6 + [i, p] + [i] * 5 + [p]
    lib.gather_round.restype = i
    return lib, log


def build_other(csrc: Path) -> ctypes.CDLL:
    """Another directory's ``warp.cu`` (with its ``warp.cuh``) built alone."""
    path = WORK / "libwarp_other.so"
    _build.build([csrc / "warp.cu"], path)
    lib = ctypes.CDLL(str(path))
    lib.tpuflow_warp_round.argtypes = list(_build._SIGNATURES["tpuflow_warp_round"])
    lib.tpuflow_warp_round.restype = ctypes.c_int
    return lib


def gather_round(lib, variant: int, image, flow_u, flow_v, out, latch, *, max_disp: int,
                 ladder: tuple, band=None, packing: str = "exact", pdl: bool = False):
    """``warp.warp_round``'s call through one variant (CUDA tensors); with
    ``pdl`` launched as a programmatic dependent launch."""
    h, w = image.shape[-2:]
    bands = (ctypes.c_int * len(ladder))(*ladder)
    code = lib.gather_round(
        variant, warp.PACKINGS[packing], int(pdl), image.data_ptr(), flow_u.data_ptr(),
        flow_v.data_ptr(), out.data_ptr(), latch.data_ptr(),
        None if band is None else band.data_ptr(), 0 if band is None else band.numel(), bands,
        len(ladder),
        image.shape[0] if image.ndim == 3 else 1, h, w, max_disp,
        torch.cuda.current_stream(image.device).cuda_stream)
    _build.check(_build.load(), code, f"gather variant {variant}")
    return out


def check(call, img, u, v, fill, batch: int, packing: str) -> list[str]:
    """One round form against the plain version at each band (a batch at
    its mixed bands), running and skipped; the failures."""
    dev = img.device
    failures = []
    bands = [[i] for i in range(len(LADDER))] if batch == 1 else [list(MIXED_BANDS[:batch])]
    for idx in bands:
        band = torch.tensor(idx, dtype=torch.int32, device=dev)
        for latch in (0, 1):
            flag = torch.full((batch,), latch, dtype=torch.int32, device=dev)
            kw = dict(max_disp=8, ladder=LADDER, band=band, packing=packing)
            got = call(img, u, v, fill.clone(), flag, **kw)
            want = warp.warp_round_ref(img, u, v, fill.clone(), flag, **kw)
            if not torch.equal(got, want) or (latch and not torch.equal(got, fill)):
                failures.append(f"band index {idx}, latch {latch}")
    return failures


def readings(call, img, u, v, zero, batch: int, packing: str, geo: dict) -> dict:
    """Device ms of one round form: band 8 on random and on zero flow, band
    2, skipped, and an empty kernel on its grid."""
    from tpuflow_torch.eval.timing import device_ms

    dev = img.device
    out = torch.empty_like(img)
    run = torch.zeros(batch, dtype=torch.int32, device=dev)
    skip = torch.ones(batch, dtype=torch.int32, device=dev)

    def band(i):
        return torch.tensor([i] if batch == 1 else MIXED_BANDS[:batch], dtype=torch.int32,
                            device=dev)

    kw = dict(max_disp=8, ladder=LADDER, packing=packing)
    b8, b2 = band(2), band(0)
    h, w = img.shape[-2:]
    return {
        "band_8_ms": device_ms(lambda: call(img, u, v, out, run, band=b8, **kw)),
        "zero_flow_ms": device_ms(lambda: call(img, zero, zero, out, run, band=b8, **kw)),
        "band_2_ms": device_ms(lambda: call(img, u, v, out, run, band=b2, **kw)),
        "skipped_ms": device_ms(lambda: call(img, u, v, out, skip, band=b8, **kw)),
        "empty_grid_ms": device_ms(lambda: warp.launch_empty_on_grid(h, w, batch, geo)),
    }


_ROUTED: dict = {}


@contextlib.contextmanager
def routed(libs: dict, variant):
    """``warp.warp_round`` through one variant: None, the package's kernel;
    "other", another build's warp (``--against``) on every plane; (large,
    small, programmatic dependent launch), those indices into VARIANTS on
    the gathered planes of SMALL_PIXELS and more and on the smaller ones,
    and the package's kernel on the staged planes. One wrapper a variant,
    so a graph captured under it finds it bound again."""
    if variant is None:
        yield
        return
    real = warp.warp_round
    if variant not in _ROUTED:
        def warp_round(image, flow_u, flow_v, out, latch, **kw):
            if variant != "other" and warp.tile_geometry(*image.shape[-2:], 8, 8)["staged"]:
                return real(image, flow_u, flow_v, out, latch, **kw)
            warp.launch_counts[warp._COUNTER[kw.get("packing", "exact")]] += 1
            if variant == "other":
                return warp_round_call(libs["other"], image, flow_u, flow_v, out, latch,
                                       kw.get("band"), kw.get("packing", "exact"),
                                       kw["ladder"], kw["max_disp"])
            large, small, pdl = variant
            pick = small if image.shape[-2] * image.shape[-1] < SMALL_PIXELS else large
            return gather_round(libs["variants"], pick, image, flow_u, flow_v, out, latch,
                                pdl=pdl, **kw)

        _ROUTED[variant] = warp_round
    warp.warp_round = _ROUTED[variant]
    try:
        yield
    finally:
        warp.warp_round = real


def parse_variants(spec: str, against: bool) -> list:
    """``--frames``' list: an index into VARIANTS for every gathered plane,
    or two, ``large/small``, split as the package splits them; a ``p``
    suffix for a programmatic dependent launch. The package's kernel first,
    and the other build's warp where ``--against`` names one."""
    out = [None] + (["other"] if against else [])
    for item in filter(None, spec.split(",")):
        pdl = item.endswith("p")
        large, _, small = item.rstrip("p").partition("/")
        out.append((int(large), int(small or large), pdl))
    return out


def variant_label(variant) -> str:
    if variant is None:
        return "package"
    if variant == "other":
        return "other build"
    large, small, pdl = variant
    return (f"variant {large}{f'/{small}' if small != large else ''}"
            f"{' with dependent launch' if pdl else ''}")


def frame_ms(dev, libs: dict, variants: list, config: str, batch: int = 1) -> dict:
    """Graphed 1080p ms a step of ``config`` with each variant (None: the
    package's kernel), in turns: each one's readings over FRAME_TURNS
    passes, forward then backward. ``batch`` > 1: that many streams in one
    replay, element i's texture rolled 7 i columns."""
    from scipy.ndimage import gaussian_filter, shift

    from tpuflow_torch import PYRAMID_CONFIGS
    from tpuflow_torch.flow import GraphedStream

    rng = np.random.default_rng(0)
    a = np.round(gaussian_filter(rng.uniform(0.0, 255.0, (1080, 1920)), 2.0))
    pairs = [(x, shift(x, (0.0, 2.0), order=1, mode="constant", cval=128.0))
             for x in (np.roll(a, 7 * i, axis=1) for i in range(batch))]
    frames = [torch.from_numpy(np.stack([p[k] for p in pairs]).astype(np.float32)).to(dev)
              for k in (0, 1)]
    if batch == 1:
        frames = [f[0] for f in frames]
    cfg = PYRAMID_CONFIGS[config]
    flows, streams = {}, {}
    for var in variants:
        with routed(libs, var):
            s = GraphedStream(frames[0], cfg)
            flows[var] = [tuple(t.clone() for t in s.step(frames[1 - i % 2])) for i in range(4)]
            streams[var] = s
    base = flows[variants[0]]
    same = all(torch.equal(x, y) for var in variants for fx, fy in zip(flows[var], base)
               for x, y in zip(fx, fy))
    times: dict = {var: [] for var in variants}
    order = variants + variants[::-1]
    for _ in range(FRAME_TURNS):
        for var in order:
            with routed(libs, var):
                s = streams[var]
                s.step(frames[0])
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for i in range(FRAME_STEPS):
                    s.step(frames[1 - i % 2])
                end.record()
                end.synchronize()
                times[var].append(start.elapsed_time(end) / FRAME_STEPS)
    return {"bit_identical": same,
            "ms": {variant_label(v): t for v, t in times.items()}}


def main() -> None:
    from tpuflow_torch.eval.timing import card_label, device_ms, require_cuda

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", default=None,
                        help="comma-separated variant indices, or large/small pairs (a 'p' "
                             "suffix: a programmatic dependent launch), to time in graphed "
                             "1080p frames")
    parser.add_argument("--batch", type=int, default=1,
                        help="streams in one replay for the graphed frames (1080p each)")
    parser.add_argument("--against", type=Path, default=None,
                        help="a csrc directory whose warp.cu (with its warp.cuh) the graphed "
                             "frames also run, on every plane")
    args = parser.parse_args()
    dev = require_cuda()
    lib, log = build()
    print(f"coarse-plane warp body by shape on {card_label()}; ptxas (packing, clamp, cols, "
          "threads across, down, rows, flow first, blocks an SM): " + "; ".join(
              f"{name} {regs} regs/{spill} B spilled"
              for name, regs, spill in _build.ptxas_entries(log, "warp_gather_kernel")))
    doc = {"card": card_label(), "floor_ms": [device_ms(_build.launch_empty, reps=200)],
           "variants": [list(v) for v in VARIANTS], "cases": {}}
    failures = []
    for shape in SHAPES:
        batch = shape[0] if len(shape) == 3 else 1
        img, u, v, zero, fill = warp_inputs(dev, shape)
        for packing in PACKINGS:
            forms = {"package": (warp.warp_round, warp.tile_geometry(*shape[-2:], 8, 8))}
            for i, var in enumerate(VARIANTS):
                forms[f"variant {i}"] = (
                    lambda *a, i=i, **kw: gather_round(lib, i, *a, **kw), geometry(var))
            label = "x".join(map(str, shape)) + f" {packing}"
            for name, (call, geo) in forms.items():
                bad = check(call, img, u, v, fill, batch, packing)
                failures += [f"{label} {name}: {f}" for f in bad]
                r = readings(call, img, u, v, zero, batch, packing, geo)
                doc["cases"][f"{label} {name}"] = r
                what = (f"{geo['cols']} cols, {geo['tile_w']}x{geo['rows']} block"
                        if name == "package" else variant_name(VARIANTS[int(name[8:])]))
                print(f"{label} {name} ({what}): band 8 {r['band_8_ms']:.5f} ms, zero flow "
                      f"{r['zero_flow_ms']:.5f}, band 2 {r['band_2_ms']:.5f}, skipped "
                      f"{r['skipped_ms']:.5f}, empty grid {r['empty_grid_ms']:.5f}"
                      + (f"; DIFFERS: {bad}" if bad else ""), flush=True)
    doc["floor_ms"].append(device_ms(_build.launch_empty, reps=200))
    print(f"launch floor {doc['floor_ms'][0]:.5f} / {doc['floor_ms'][1]:.5f} ms")
    if args.frames is not None:
        libs = {"variants": lib}
        if args.against is not None:
            libs["other"] = build_other(args.against)
        variants = parse_variants(args.frames, args.against is not None)
        for config in ("production", "default"):
            r = frame_ms(dev, libs, variants, config, args.batch)
            doc[f"frames {config} B={args.batch}"] = r
            print(f"graphed 1080p {config} B={args.batch} ms a step ({FRAME_STEPS} replays a "
                  f"reading, "
                  f"bit-identical across variants: {r['bit_identical']}): " + "; ".join(
                      f"{k} " + "/".join(f"{t:.4f}" for t in ts) for k, ts in r["ms"].items()),
                  flush=True)
            if not r["bit_identical"]:
                failures.append(f"graphed {config} flows differ across variants")
    print(json.dumps(doc))
    if failures:
        raise SystemExit("; ".join(failures))


if __name__ == "__main__":
    main()
