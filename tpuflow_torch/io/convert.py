"""Frame format conversion CLI (.mem / .bin -> PNG).

A numpy copy of ``tpuflow.io.convert``, for inspecting RTL testbench
inputs. Pillow writes the PNG and is imported only then.

Run: ``python -m tpuflow_torch.io.convert frame_00.mem [frame_01.bin ...]
--width 320 --height 240``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tpuflow_torch.io.frames import load_frame_bin, load_frame_mem


def convert(path: Path, width: int, height: int, output: Path | None) -> Path:
    if path.suffix == ".mem":
        frame = load_frame_mem(path, width, height)
    elif path.suffix == ".bin":
        frame = load_frame_bin(path, width, height)
    else:
        raise SystemExit(f"unsupported input format: {path.suffix}")
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("writing a PNG needs Pillow (PIL)") from exc

    out = output or path.with_suffix(".png")
    Image.fromarray(np.asarray(frame).astype(np.uint8)).save(out)
    return out


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Convert .mem/.bin frames to PNG")
    parser.add_argument("inputs", nargs="+", type=str)
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--output", type=str, default=None,
                        help="Output path (single input only)")
    args = parser.parse_args(argv)
    if args.output and len(args.inputs) > 1:
        raise SystemExit("--output only valid with a single input")
    for p in args.inputs:
        path = Path(p)
        if not path.exists():
            raise SystemExit(f"not found: {path}")
        out = convert(path, args.width, args.height,
                      Path(args.output) if args.output else None)
        print(f"{path} -> {out}")


if __name__ == "__main__":
    main()
