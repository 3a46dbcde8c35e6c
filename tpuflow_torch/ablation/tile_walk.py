"""K6's tile round at other walk shapes: rows a block and ring slots.

Writes a variant of ``csrc/lk_tile.cuh`` whose column-walk kernel takes its
ring depth as a template argument, and a source with one entry that
launches the tile round (window 5, exact order, as the tiled path runs it)
at a given number of output rows a block and ring slots; builds it alone
with the package's nvcc flags into ``build/tpuflow_torch/tile_walk/``.
Then, at the 1080p world-1 extended tiles, for 2, 4, 8, 16 and 32 rows and
2, 4 and 8 slots: checks u, v and the control bit for bit against the
plain version, and times the round running and skipped beside an empty
kernel on the same grid (``eval.timing.device_ms``). Prints one line a
case, which rows the tile round's rule (``tile_round_rows``) and the
refine's (``walk_rows``) take, and one JSON object; a difference fails the
run after the timings. Needs a CUDA device:

    python -m tpuflow_torch.ablation.tile_walk
"""

from __future__ import annotations

import ctypes
import json
import re

import torch

from tpuflow_torch.ablation.port_against import TILE_SHAPES, TILE_WINDOW, tile_inputs
from tpuflow_torch.kernels import _build, lk

ROWS = (2, 4, 8, 16, 32)
RINGS = (2, 4, 8)
WORK = _build.BUILD_DIR / "tile_walk"

ENTRY = r"""
#include "lk_tile.cuh"
using namespace tpuflow_lk;
namespace {
__global__ void __launch_bounds__(kWalkThreads) empty_walk() {}
template <int kRing>
int round_at(const LkArgs& a, int rows, cudaStream_t s) {
  const dim3 grid = walk_grid(a.height, a.width, 5, rows, 1);
  lk_walk_kernel<5, false, kUniform, kTileRound, kRing><<<grid, kWalkThreads, 0, s>>>(a, rows);
  return (int)cudaGetLastError();
}
}  // namespace
extern "C" int tile_walk_blocks(int height, int width, int rows) {
  const dim3 g = walk_grid(height, width, 5, rows, 1);
  return (int)(g.x * g.y);
}
extern "C" int tile_walk_refine_rows(int height, int width) {
  return walk_rows(height, width, 5);
}
extern "C" int tile_walk_empty(int height, int width, int rows, void* stream) {
  empty_walk<<<walk_grid(height, width, 5, rows, 1), kWalkThreads, 0,
               static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
extern "C" int tile_walk_round(const float* prev_ext, const float* warped_ext, float* u, float* v,
                               int* ctrl, float* part_du, float* part_dv, float* sums,
                               int height, int width, int rows, int ring, void* stream) {
  LkArgs a{};
  const int crop = 5 / 2 + 1;
  a.prev = prev_ext;
  a.curr = warped_ext;
  a.u_out = u;
  a.v_out = v;
  a.ctrl = ctrl;
  a.part_du = part_du;
  a.part_dv = part_dv;
  a.sums = sums;
  a.height = height;
  a.width = width;
  a.det_threshold = 1e-4f;
  a.crop = crop;
  a.tile_h = height - 2 * crop;
  a.tile_w = width - 2 * crop;
  a.gh = a.tile_h;
  a.gw = a.tile_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ring) {
    case 2: return round_at<2>(a, rows, s);
    case 4: return round_at<4>(a, rows, s);
    case 8: return round_at<8>(a, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""


def variant_header() -> str:
    """lk_tile.cuh with the walk kernel's ring depth a template argument
    (default the header's own ``kStages``)."""
    src = (_build.CSRC / "lk_tile.cuh").read_text()
    head = "template <int kWindow, bool kRelaxed, int kSum, int kMode>\n__global__"
    start = src.index(head)
    end = src.index("// Output rows a block walks")
    body = re.sub(r"\bkStages\b", "kRing", src[start:end])
    body = body.replace(head, "template <int kWindow, bool kRelaxed, int kSum, int kMode, "
                              "int kRing = kStages>\n__global__", 1)
    return src[:start] + body + src[end:]


def build() -> tuple[ctypes.CDLL, str]:
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "lk_tile.cuh").write_text(variant_header())
    (WORK / "tile_walk.cu").write_text(ENTRY)
    path = WORK / "libtile_walk.so"
    log = _build.build([WORK / "tile_walk.cu"], path)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("tile_walk_blocks", [i, i, i]), ("tile_walk_refine_rows", [i, i]),
                       ("tile_walk_empty", [i, i, i, p]),
                       ("tile_walk_round", [p] * 8 + [i] * 4 + [p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib, log


def main() -> None:
    from tpuflow_torch.eval.timing import card_label, device_ms, require_cuda

    dev = require_cuda()
    this = _build.load()
    lib, log = build()
    print(f"K6's tile round by walk shape on {card_label()}; variant ptxas: " + " | ".join(
        line.strip() for line in log.splitlines() if "registers" in line or "spill" in line))
    stream = torch.cuda.current_stream().cuda_stream
    doc = {"card": card_label(), "floor_ms": device_ms(_build.launch_empty), "shapes": {}}
    failures = []
    for shape in TILE_SHAPES:
        prev, warped, u, v = tile_inputs(dev, shape)
        want = [t.clone() for t in (u, v, torch.zeros(3, dtype=torch.int32, device=dev))]
        lk.fused_tile_round_ref(prev, warped, *want, gy0=0, gx0=0, gh=u.shape[0],
                                gw=u.shape[1], window_size=TILE_WINDOW)
        sums = torch.empty(2, dtype=torch.float32, device=dev)
        run = torch.zeros(3, dtype=torch.int32, device=dev)
        skip = torch.tensor([1, 0, 0], dtype=torch.int32, device=dev)
        rule = this.tpuflow_lk_tile_round_rows(*shape, TILE_WINDOW)
        out = {"rule_rows": rule, "refine_rule_rows": lib.tile_walk_refine_rows(*shape)}
        for rows in ROWS:
            blocks = lib.tile_walk_blocks(*shape, rows)
            parts = torch.empty((2, blocks), dtype=torch.float32, device=dev)
            empty_ms = device_ms(lambda rows=rows: _build.check(
                this, lib.tile_walk_empty(*shape, rows, stream), "empty walk"))
            for ring in RINGS:
                def call(uu, vv, ctrl, rows=rows, ring=ring):
                    _build.check(this, lib.tile_walk_round(
                        prev.data_ptr(), warped.data_ptr(), uu.data_ptr(), vv.data_ptr(),
                        ctrl.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
                        sums.data_ptr(), *shape, rows, ring, stream), "tile walk round")

                got = [u.clone(), v.clone(), torch.zeros(3, dtype=torch.int32, device=dev)]
                call(*got)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    failures.append(f"{shape[0]}x{shape[1]}, {rows} rows, {ring} slots: differs "
                                    f"from the plain version")
                uw, vw = u.clone(), v.clone()  # the timed rounds add into these
                ms = device_ms(lambda: call(uw, vw, run))
                skip_ms = device_ms(lambda: call(uw, vw, skip))
                out[f"{rows}/{ring}"] = {"blocks": blocks, "ms": ms, "skipped_ms": skip_ms,
                                         "empty_grid_ms": empty_ms}
                print(f"{shape[0]}x{shape[1]}, {rows} rows a block ({blocks} blocks), {ring} "
                      f"ring slots: {ms:.5f} ms, skipped {skip_ms:.5f}, an empty kernel on the "
                      f"grid {empty_ms:.5f}", flush=True)
        print(f"{shape[0]}x{shape[1]}: the tile round's rule takes {rule} rows, the refine's "
              f"{out['refine_rule_rows']}")
        doc["shapes"][f"{shape[0]}x{shape[1]}"] = out
    print(f"launch floor {doc['floor_ms']:.5f} ms; against the plain version: "
          + ("; ".join(failures) or "every case bit-identical"))
    print(json.dumps(doc))
    if failures:
        raise SystemExit("; ".join(failures))


if __name__ == "__main__":
    main()
