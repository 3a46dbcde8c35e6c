"""Natural-texture frame-pair generator (single pair, sub-pixel motion).

A numpy/scipy copy of ``tpuflow.eval.natural``: the mountain texture
(``tpuflow/eval/data/mountain_texture.jpg``, read by path) resized with
PIL's default (bicubic) resampling, or a sinusoid-sum synthetic texture,
shifted sub-pixel with ``scipy.ndimage.shift`` (order 1, gray-128 fill).
These are the S8.7 RTL mode's test frames.

PIL is imported only to resize the texture. The 320x240 base frame, and
its 2 px pair, are committed as ``data/natural_320x240.npz`` (written by
this module's ``generate_pair``), so a machine without PIL, such as the
GPU host, still has the RTL testbench's frames; any other size needs PIL.

Run: ``python -m tpuflow_torch.eval.natural --output-dir DIR``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

TEXTURE = Path(__file__).resolve().parents[2] / "tpuflow" / "eval" / "data" / "mountain_texture.jpg"
NATURAL_320 = Path(__file__).resolve().parent / "data" / "natural_320x240.npz"
COMMITTED_SIZE = (320, 240)  # (width, height) of the committed base frame


def generate_natural_pattern(width: int = 320, height: int = 240) -> np.ndarray:
    """Grayscale u8 base frame: the mountain texture resized with PIL's
    default resampling. Without PIL, the committed 320x240 frame."""
    try:
        from PIL import Image
    except ImportError:
        if (width, height) != COMMITTED_SIZE:
            raise ImportError(
                f"a {width}x{height} natural frame needs Pillow (PIL) to resize the "
                f"texture; without it only the committed "
                f"{COMMITTED_SIZE[0]}x{COMMITTED_SIZE[1]} frame is available"
            ) from None
        with np.load(NATURAL_320) as data:
            return data["frame_00"]
    img = Image.open(TEXTURE).convert("L")
    img = Image.fromarray(np.array(img, dtype=np.uint8)).resize((width, height))
    return np.array(img, dtype=np.uint8)


def generate_smooth_synthetic(width: int, height: int) -> np.ndarray:
    """Sum-of-sinusoids texture (the reference generator's fallback)."""
    x = np.linspace(0, 4 * np.pi, width)
    y = np.linspace(0, 3 * np.pi, height)
    xx, yy = np.meshgrid(x, y)
    pattern = (
        128
        + 50 * np.sin(xx) * np.cos(yy)
        + 30 * np.cos(2 * xx + 0.5) * np.sin(1.5 * yy)
        + 20 * np.sin(3 * xx - 0.3) * np.cos(2.5 * yy + 0.7)
    )
    return np.clip(pattern, 0, 255).astype(np.uint8)


def apply_motion(frame: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """Sub-pixel shift, bilinear, gray-128 fill."""
    from scipy.ndimage import shift

    return shift(frame, (dy, dx), order=1, mode="constant", cval=128).astype(np.uint8)


def generate_pair(
    width: int = 320,
    height: int = 240,
    dx: float = 2.0,
    dy: float = 0.0,
    synthetic: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    base = (
        generate_smooth_synthetic(width, height)
        if synthetic
        else generate_natural_pattern(width, height)
    )
    return base, apply_motion(base, dx, dy)


def committed_pair() -> tuple[np.ndarray, np.ndarray]:
    """The committed 320x240 u8 pair, 2 px to the right."""
    with np.load(NATURAL_320) as data:
        return data["frame_00"], data["frame_01"]


def main(argv: list[str] | None = None) -> None:
    import argparse

    from tpuflow_torch.io.frames import save_frame_bin, save_frame_mem

    parser = argparse.ArgumentParser(description="Generate a natural frame pair")
    parser.add_argument("--displacement-x", type=float, default=2.0)
    parser.add_argument("--displacement-y", type=float, default=0.0)
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--output-dir", type=str, default="test_frames")
    parser.add_argument("--use-synthetic", action="store_true")
    args = parser.parse_args(argv)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    f0, f1 = generate_pair(
        args.width, args.height, args.displacement_x, args.displacement_y,
        synthetic=args.use_synthetic,
    )
    save_frame_bin(out / "frame_00.bin", f0)
    save_frame_bin(out / "frame_01.bin", f1)
    save_frame_mem(out / "frame_00.mem", f0)
    save_frame_mem(out / "frame_01.mem", f1)
    print(f"Saved frame pair -> {out} (motion {args.displacement_x}, "
          f"{args.displacement_y})")


if __name__ == "__main__":
    main()
