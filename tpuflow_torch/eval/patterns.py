"""The 13-pattern verification suite, without PIL or OpenCV.

``MotionParameters``, ``TEST_PATTERNS`` and ``dense_ground_truth`` are
copies of ``tpuflow.eval.patterns`` (numpy only). The frames come from a
committed fixture, ``data/suite_320x240.npz``: the 320x240 u8 base frame
(``base``) once and each pattern's second frame under its name, made by
``tpuflow.eval.patterns.generate_test_pattern`` (the reference suite's
OpenCV affine warp of the mountain texture). A machine without PIL or
OpenCV, such as the GPU host, reads the suite from it.

``write_suite`` writes the fixture out in the reference generator's
on-disk layout (``suite_index.json``, and per pattern ``frame_00/01.bin``,
``frame_00/01.mem`` and ``metadata.json``), and ``load_test_pattern``
reads one pattern of that layout, as ``tpuflow.eval.patterns`` does: the
verifier's ``--suite-dir``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

SUITE_FIXTURE = Path(__file__).parent / "data" / "suite_320x240.npz"


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


def load_base_texture(width: int = 320, height: int = 240) -> np.ndarray:
    """The suite's uint8 base frame, ``tpuflow.eval.patterns.
    load_base_texture(320, 240)`` (the mountain texture, bilinear-resized
    by PIL), from the committed fixture: the one size it holds."""
    with np.load(SUITE_FIXTURE) as data:
        base = data["base"]
    if base.shape != (height, width):
        raise ValueError(
            f"the fixture holds the {base.shape[1]}x{base.shape[0]} base frame, "
            f"not {width}x{height}"
        )
    return base


def write_suite(output_dir: Path) -> Path:
    """Write the committed suite in the layout of
    ``tpuflow.eval.patterns.generate_full_suite``: every pattern's frames
    as ``.bin`` (raw u8) and ``.mem`` (``$readmemh`` hex), its
    ``metadata.json``, and the ``suite_index.json`` manifest. Returns the
    suite directory."""
    from tpuflow_torch.io.frames import save_frame_bin, save_frame_mem

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with np.load(SUITE_FIXTURE) as data:
        base = data["base"]
        second = {name: data[name] for name in TEST_PATTERNS}
    height, width = base.shape
    for name, params in TEST_PATTERNS.items():
        pattern_dir = out / name
        pattern_dir.mkdir(parents=True, exist_ok=True)
        pure = params.rotation == 0 and params.scale == 1.0
        metadata = {
            "pattern_name": name,
            "description": params.description,
            "resolution": {"width": width, "height": height},
            "motion_parameters": params.to_dict(),
            "expected_flow": {
                "u_mean": params.dx if pure else "variable",
                "v_mean": params.dy if pure else "variable",
                "note": "For rotation/zoom, flow varies spatially. Use test regions.",
            },
        }
        (pattern_dir / "metadata.json").write_text(json.dumps(metadata, indent=2))
        for stem, frame in (("frame_00", base), ("frame_01", second[name])):
            save_frame_bin(pattern_dir / f"{stem}.bin", frame)
            save_frame_mem(pattern_dir / f"{stem}.mem", frame)
    index = {
        "suite_name": "Optical Flow Verification Suite",
        "resolution": {"width": width, "height": height},
        "num_patterns": len(TEST_PATTERNS),
        "patterns": {n: p.to_dict() for n, p in TEST_PATTERNS.items()},
    }
    (out / "suite_index.json").write_text(json.dumps(index, indent=2))
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
