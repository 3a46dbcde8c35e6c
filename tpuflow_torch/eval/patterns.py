"""The 13-pattern verification suite and its generator, without PIL or
OpenCV.

``MotionParameters``, ``TEST_PATTERNS`` and ``dense_ground_truth`` are
copies of ``tpuflow.eval.patterns`` (numpy only). The generator is the
reference's at any size:

- ``load_base_texture``: the mountain texture, committed as its grayscale
  u8 array (``data/mountain_texture_gray.npz``, the JPEG's
  ``convert("L")``), resized as Pillow's ``BILINEAR`` filter resizes it,
  in the same integer arithmetic: a horizontal pass, then a vertical one,
  each with float64 coefficients normalized to 22-bit fixed point, rounded
  at ``1 << 21`` and clipped to u8 between the passes. Bit for bit PIL's.
- ``apply_motion``: the semantics of ``cv2.warpAffine`` with
  ``getRotationMatrix2D`` about the center, ``dx`` / ``dy`` added to the
  matrix's last column, bilinear, constant 128 border, in torch on the
  device (the card unless the caller names another). The inverse matrix
  is computed in float64 as OpenCV computes it and cast to float32; the
  row term ``M01*y + M02`` is float32, rounded after each operation; the
  column term is one fused multiply-add, ``fma(M00, x, row)`` (the exact
  product in float64, rounded once); then ``floor``, the float32 lerps
  ``p00 + a*(p01 - p00)`` across and then down (no other contraction),
  and round-half-even. This equals OpenCV 5.0.0's output on every pattern
  at 320x240 and 640x480; elsewhere a few pixels differ by one level
  (ROADMAP.md section 3, divergence o).
- ``generate_test_pattern``, ``generate_full_suite`` and ``main``
  (``python -m tpuflow_torch.eval.patterns``): the reference's flags and
  on-disk layout (``suite_index.json``, and per pattern
  ``frame_00/01.bin``, ``frame_00/01.mem`` and ``metadata.json``).

The committed fixture ``data/suite_320x240.npz`` holds the 320x240 base
frame (``base``) and each pattern's second frame under its name, made by
``tpuflow.eval.patterns``; the generator reproduces it bit for bit. The
verifier's gate reads it (``load_suite``), and ``write_suite`` writes it
in the generator's layout: the verifier's ``--suite-dir``.
``load_test_pattern`` reads one pattern of that layout.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tpuflow_torch.eval.timing import resolve_device

DATA_DIR = Path(__file__).parent / "data"
SUITE_FIXTURE = DATA_DIR / "suite_320x240.npz"
TEXTURE = DATA_DIR / "mountain_texture_gray.npz"
DEFAULT_SUITE_DIR = Path(__file__).resolve().parents[2] / "test_suite"
BORDER = 128.0  # the warp's constant border
PRECISION_BITS = 22  # Pillow's fixed-point coefficients for 8-bit images


@dataclasses.dataclass
class MotionParameters:
    """Ground-truth motion for one pattern (reference:
    generate_test_suite.py:40-53)."""

    name: str
    dx: float = 0.0
    dy: float = 0.0
    rotation: float = 0.0  # degrees CCW
    scale: float = 1.0
    description: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# The 13 patterns of the reference suite (generate_test_suite.py:57-137).
TEST_PATTERNS: Dict[str, MotionParameters] = {
    "translate_small": MotionParameters(
        "translate_small", dx=0.5, dy=0.5,
        description="Half-pixel shift exercising sub-pixel precision"),
    "translate_medium": MotionParameters(
        "translate_medium", dx=2.0,
        description="2 px horizontal shift, the canonical in-window case"),
    "translate_large": MotionParameters(
        "translate_large", dx=15.0,
        description="15 px shift, beyond single-scale LK's window reach"),
    "translate_vertical": MotionParameters(
        "translate_vertical", dy=10.0,
        description="Pure 10 px vertical shift"),
    "translate_diagonal": MotionParameters(
        "translate_diagonal", dx=10.0, dy=10.0,
        description="Equal 10 px shift on both axes"),
    "rotate_small": MotionParameters(
        "rotate_small", rotation=2.0,
        description="2 deg rotation, mildly breaking brightness constancy"),
    "rotate_medium": MotionParameters(
        "rotate_medium", rotation=5.0,
        description="5 deg rotation probing the algorithm's envelope"),
    "rotate_large": MotionParameters(
        "rotate_large", rotation=15.0,
        description="15 deg rotation, a documented LK failure mode"),
    "zoom_in": MotionParameters(
        "zoom_in", scale=1.1,
        description="Radial expansion by 10%"),
    "zoom_out": MotionParameters(
        "zoom_out", scale=0.9,
        description="Radial contraction by 10%"),
    "translate_rotate": MotionParameters(
        "translate_rotate", dx=5.0, dy=5.0, rotation=3.0,
        description="5 px shift composed with a 3 deg rotation"),
    "no_motion": MotionParameters(
        "no_motion",
        description="Identical frames; the flow must be exactly zero"),
    "translate_extreme": MotionParameters(
        "translate_extreme", dx=30.0, dy=20.0,
        description="30/20 px shift, far outside every pyramid budget"),
}


def dense_ground_truth(
    params: MotionParameters, width: int = 320, height: int = 240
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-pixel analytic ground-truth flow for an affine pattern.

    The suite's scalar (dx, dy) ground truth is only exact for pure
    translations; rotation/zoom/combined patterns have spatially varying
    flow (which is why the reference scores them on a center crop,
    optical_flow_verifier.py:96-138). This computes the exact field:
    content at source pixel p lands at M(p) in the second frame
    (cv2.warpAffine maps ``dst(M(p)) = src(p)`` for the forward matrix),
    so ``flow(p) = M(p) - p`` with the same center-pivot matrix
    construction as :func:`apply_motion` (getRotationMatrix2D semantics:
    alpha = s*cos(a), beta = s*sin(a), computed directly in NumPy).

    Returns (u, v, visible): visible marks source pixels whose
    destination stays inside the frame (content observable in frame 1).
    """
    a = np.deg2rad(params.rotation)
    alpha = params.scale * np.cos(a)
    beta = params.scale * np.sin(a)
    cx, cy = width / 2.0, height / 2.0
    m02 = (1.0 - alpha) * cx - beta * cy + params.dx
    m12 = beta * cx + (1.0 - alpha) * cy + params.dy
    x = np.arange(width, dtype=np.float64)[None, :]
    y = np.arange(height, dtype=np.float64)[:, None]
    xd = alpha * x + beta * y + m02
    yd = -beta * x + alpha * y + m12
    u = (xd - x).astype(np.float32)
    v = (yd - y).astype(np.float32)
    visible = (
        (xd >= 0.0) & (xd <= width - 1.0)
        & (yd >= 0.0) & (yd <= height - 1.0)
    )
    return u, v, visible


def load_suite(path: Path = SUITE_FIXTURE) -> Dict[str, Dict[str, Any]]:
    """Every pattern of the fixture, in ``TEST_PATTERNS`` order: name ->
    float32 ``frame_prev`` / ``frame_curr`` and the metadata, as
    ``tpuflow.eval.patterns.load_test_pattern`` returns them."""
    with np.load(path) as data:
        base = data["base"]
        height, width = base.shape
        return {
            name: {
                "frame_prev": base.astype(np.float32),
                "frame_curr": data[name].astype(np.float32),
                "metadata": {
                    "pattern_name": name,
                    "resolution": {"width": width, "height": height},
                    "motion_parameters": params.to_dict(),
                },
            }
            for name, params in TEST_PATTERNS.items()
        }


def _resample_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's bilinear ``precompute_coeffs`` and ``normalize_coeffs_8bpc``
    for one axis: each output's first input index and its fixed-point
    weights (int64, ``ksize`` a row, zero past the window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # the bilinear filter's support, 1, scaled
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    first = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    count = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - first
    ss = 1.0 / filterscale
    weights = np.zeros((out_size, ksize), np.float64)
    total = np.zeros(out_size, np.float64)
    for x in range(ksize):  # summed in Pillow's order
        t = np.abs(((x + first).astype(np.float64) - center + 0.5) * ss)
        w = np.where((t < 1.0) & (x < count), 1.0 - t, 0.0)
        weights[:, x] = w
        total = total + w
    weights = np.where(total[:, None] != 0.0, weights / np.where(total == 0.0, 1.0, total)[:, None],
                       weights)
    fixed = np.trunc(0.5 + weights * (1 << PRECISION_BITS)).astype(np.int64)  # weights >= 0
    return first, fixed


def _resample_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One of Pillow's 8-bit passes along ``axis`` of an int64 image."""
    first, fixed = _resample_coeffs(img.shape[axis], out_size)
    idx = np.minimum(first[:, None] + np.arange(fixed.shape[1]), img.shape[axis] - 1)
    if axis == 1:
        acc = (img[:, idx] * fixed[None]).sum(-1)
    else:
        acc = (img[idx, :] * fixed[:, :, None]).sum(1)
    return np.clip((acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS, 0, 255)


def load_base_texture(width: int = 320, height: int = 240) -> np.ndarray:
    """The suite's uint8 (height, width) base frame: the mountain texture
    resized as ``PIL.Image.resize(..., BILINEAR)`` resizes it, bit for bit
    (``tpuflow.eval.patterns.load_base_texture``). Integer arithmetic on
    the host, the same on every machine."""
    with np.load(TEXTURE) as data:
        img = data["texture"].astype(np.int64)
    if width != img.shape[1]:
        img = _resample_pass(img, width, axis=1)
    if height != img.shape[0]:
        img = _resample_pass(img, height, axis=0)
    return img.astype(np.uint8)


def rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the float64 2x3 matrix rotating by
    ``angle`` degrees counter-clockwise about ``center`` and scaling."""
    a = angle * (math.pi / 180.0)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    cx, cy = (float(np.float32(c)) for c in center)  # OpenCV takes a Point2f
    return np.array([[alpha, beta, (1.0 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1.0 - alpha) * cy]], np.float64)


def invert_affine_transform(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64."""
    m = np.asarray(m, np.float64).ravel()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0.0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, -m[1] * d, -m[3] * d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float64)


def apply_motion(frame, params: MotionParameters,
                 device: torch.device | str | None = None) -> np.ndarray:
    """The pattern's second frame: ``frame`` (u8 (H, W), numpy or torch)
    warped as ``tpuflow.eval.patterns.apply_motion`` warps it with
    OpenCV, computed in torch on ``device`` (the card unless the caller
    names another; raises where there is none). Returns uint8 numpy."""
    dev = resolve_device(device)
    src = torch.as_tensor(np.asarray(frame) if not isinstance(frame, torch.Tensor) else frame)
    src = src.to(dev, torch.float32)
    height, width = src.shape
    m = rotation_matrix_2d((width / 2.0, height / 2.0), params.rotation, params.scale)
    m[0, 2] += params.dx
    m[1, 2] += params.dy
    inv = torch.tensor(invert_affine_transform(m), dtype=torch.float32, device=dev)
    x = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(height, dtype=torch.float32, device=dev)[:, None]

    def source(r: int) -> torch.Tensor:
        row = inv[r, 1] * y + inv[r, 2]  # float32, each operation rounded
        # fma(M_r0, x, row): the product is exact in float64, one rounding.
        return (inv[r, 0].double() * x.double() + row.double()).float()

    sx, sy = source(0), source(1)
    fx, fy = torch.floor(sx), torch.floor(sy)
    a, b = sx - fx, sy - fy
    x0, y0 = fx.long(), fy.long()
    flat = src.reshape(-1)
    border = torch.tensor(BORDER, dtype=torch.float32, device=dev)

    def pixel(yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
        inside = (yy >= 0) & (yy < height) & (xx >= 0) & (xx < width)
        idx = yy.clamp(0, height - 1) * width + xx.clamp(0, width - 1)
        return torch.where(inside, flat[idx], border)

    p00, p01 = pixel(y0, x0), pixel(y0, x0 + 1)
    p10, p11 = pixel(y0 + 1, x0), pixel(y0 + 1, x0 + 1)
    top = p00 + a * (p01 - p00)
    bottom = p10 + a * (p11 - p10)
    out = torch.round(top + b * (bottom - top)).clamp(0, 255).to(torch.uint8)
    return out.cpu().numpy()


def _metadata(params: MotionParameters, width: int, height: int) -> Dict[str, Any]:
    pure = params.rotation == 0 and params.scale == 1.0
    return {
        "pattern_name": params.name,
        "description": params.description,
        "resolution": {"width": width, "height": height},
        "motion_parameters": params.to_dict(),
        "expected_flow": {
            "u_mean": params.dx if pure else "variable",
            "v_mean": params.dy if pure else "variable",
            "note": "For rotation/zoom, flow varies spatially. Use test regions.",
        },
    }


def _write_pattern(out: Path, params: MotionParameters, frame_0: np.ndarray,
                   frame_1: np.ndarray, save_mem: bool = True, save_bin: bool = True,
                   save_png: bool = False) -> None:
    """One pattern's directory in the reference generator's layout."""
    from tpuflow_torch.io.frames import save_frame_mem

    height, width = frame_0.shape
    pattern_dir = Path(out) / params.name
    pattern_dir.mkdir(parents=True, exist_ok=True)
    (pattern_dir / "metadata.json").write_text(
        json.dumps(_metadata(params, width, height), indent=2))
    frames = (("frame_00", frame_0), ("frame_01", frame_1))
    for stem, frame in frames:
        if save_bin:
            frame.tofile(pattern_dir / f"{stem}.bin")
        if save_mem:
            save_frame_mem(pattern_dir / f"{stem}.mem", frame)
    if save_png:
        from PIL import Image

        for stem, frame in frames:
            Image.fromarray(frame).save(pattern_dir / f"{stem}.png")


def _write_index(out: Path, width: int, height: int) -> None:
    index = {
        "suite_name": "Optical Flow Verification Suite",
        "resolution": {"width": width, "height": height},
        "num_patterns": len(TEST_PATTERNS),
        "patterns": {n: p.to_dict() for n, p in TEST_PATTERNS.items()},
    }
    (Path(out) / "suite_index.json").write_text(json.dumps(index, indent=2))


def generate_test_pattern(
    params: MotionParameters,
    width: int = 320,
    height: int = 240,
    output_dir: Optional[Path] = None,
    save_mem: bool = True,
    save_bin: bool = True,
    save_png: bool = False,
    device: torch.device | str | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One u8 frame pair, the base frame and it moved by ``params`` (the
    warp on ``device``, the card unless the caller names another), and
    where ``output_dir`` is given its files in the reference's layout:
    ``frame_00/01.bin`` (raw u8), ``frame_00/01.mem`` (``$readmemh``
    hex), ``metadata.json``, and with ``save_png`` PNGs (Pillow)."""
    frame_0 = load_base_texture(width, height)
    frame_1 = apply_motion(frame_0, params, device)
    if output_dir is not None:
        _write_pattern(Path(output_dir), params, frame_0, frame_1, save_mem, save_bin, save_png)
    return frame_0, frame_1


def generate_full_suite(
    width: int = 320,
    height: int = 240,
    output_dir: Optional[Path] = None,
    save_png: bool = False,
    device: torch.device | str | None = None,
) -> Path:
    """All 13 patterns and the ``suite_index.json`` manifest, written to
    ``output_dir`` (``test_suite/`` at the repository root by default),
    the warps on ``device``. Returns the suite directory."""
    out = Path(output_dir) if output_dir else DEFAULT_SUITE_DIR
    out.mkdir(parents=True, exist_ok=True)
    base = load_base_texture(width, height)
    for params in TEST_PATTERNS.values():
        _write_pattern(out, params, base, apply_motion(base, params, device), save_png=save_png)
    _write_index(out, width, height)
    return out


def write_suite(output_dir: Path) -> Path:
    """Write the committed 320x240 suite (the fixture the gate reads) in
    ``generate_full_suite``'s layout; the generator at 320x240 writes the
    same files. Returns the suite directory."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with np.load(SUITE_FIXTURE) as data:
        base = data["base"]
        for params in TEST_PATTERNS.values():
            _write_pattern(out, params, base, data[params.name])
    _write_index(out, base.shape[1], base.shape[0])
    return out


def load_test_pattern(pattern_dir: Path) -> Dict[str, Any]:
    """One pattern of a suite directory: float32 ``frame_prev`` /
    ``frame_curr`` from the ``.bin`` frames and the ``metadata.json``."""
    pattern_dir = Path(pattern_dir)
    metadata = json.loads((pattern_dir / "metadata.json").read_text())
    width = metadata["resolution"]["width"]
    height = metadata["resolution"]["height"]
    prev = np.fromfile(pattern_dir / "frame_00.bin", dtype=np.uint8)
    curr = np.fromfile(pattern_dir / "frame_01.bin", dtype=np.uint8)
    return {
        "frame_prev": prev.reshape((height, width)).astype(np.float32),
        "frame_curr": curr.reshape((height, width)).astype(np.float32),
        "metadata": metadata,
    }


def main(argv: list[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Generate optical flow test patterns with known ground truth"
    )
    parser.add_argument("--pattern", type=str, default="all",
                        help='"all", a pattern name, or "custom"')
    parser.add_argument("--list", action="store_true", help="List available patterns")
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--output-dir", type=str, default=None)
    parser.add_argument("--png", action="store_true", help="Also save PNGs")
    parser.add_argument("--dx", type=float, default=0.0)
    parser.add_argument("--dy", type=float, default=0.0)
    parser.add_argument("--rotation", type=float, default=0.0)
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="where the warps run: the card (default; fails without one) "
                        "or the CPU")
    args = parser.parse_args(argv)

    if args.list:
        for name, p in TEST_PATTERNS.items():
            print(f"{name:25s} - {p.description}")
        return

    out = Path(args.output_dir) if args.output_dir else DEFAULT_SUITE_DIR
    size = (args.width, args.height)
    if args.pattern == "all":
        suite = generate_full_suite(*size, out, save_png=args.png, device=args.device)
        print(f"Generated {len(TEST_PATTERNS)} patterns -> {suite}")
    elif args.pattern == "custom":
        params = MotionParameters(
            "custom", dx=args.dx, dy=args.dy, rotation=args.rotation, scale=args.scale,
            description=f"Custom: dx={args.dx}, dy={args.dy}, rot={args.rotation}°",
        )
        generate_test_pattern(params, *size, out, save_png=args.png, device=args.device)
        print(f"Saved to: {out / 'custom'}")
    elif args.pattern in TEST_PATTERNS:
        generate_test_pattern(TEST_PATTERNS[args.pattern], *size, out, save_png=args.png,
                              device=args.device)
        print(f"Saved to: {out / args.pattern}")
    else:
        raise SystemExit(f"Unknown pattern '{args.pattern}' (use --list)")


if __name__ == "__main__":
    main()
