"""Video-container frame source (host-side decode, optional).

Decodes a video file (whatever the local OpenCV build's ffmpeg reads) into
the grayscale float32 frames the ``.bin`` / ``.mem`` loaders give, so the
VO CLI can read footage directly. A copy of ``tpuflow.io.video``. OpenCV
is imported when a video is opened, with a clear error where it is
missing: everything else works without it.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(
            "video ingestion needs opencv-python (cv2); install it or extract the "
            "frames to .bin and use the directory loaders"
        ) from exc
    return cv2


class VideoFrameStream:
    """Iterate grayscale float32 frames from a video file.

    ``size``: optional (width, height) to resize each frame to (area
    interpolation). ``max_frames`` bounds ingestion for long clips.
    """

    def __init__(
        self,
        path: str,
        size: Optional[Tuple[int, int]] = None,
        max_frames: Optional[int] = None,
    ) -> None:
        self.path = str(path)
        self.size = size
        self.max_frames = max_frames
        cv2 = _cv2()
        cap = cv2.VideoCapture(self.path)
        if not cap.isOpened():
            raise IOError(f"cannot open video: {self.path}")
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        # Some containers report 0 or negative counts: None then.
        self.frame_count = n if n > 0 else None
        fps = float(cap.get(cv2.CAP_PROP_FPS))
        self.fps = fps if fps > 0 else None
        cap.release()

    def __iter__(self) -> Iterator[np.ndarray]:
        cv2 = _cv2()
        cap = cv2.VideoCapture(self.path)
        try:
            n = 0
            while self.max_frames is None or n < self.max_frames:
                ret, frame = cap.read()
                if not ret:
                    break
                if frame.ndim == 3:
                    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                if self.size is not None:
                    frame = cv2.resize(frame, self.size, interpolation=cv2.INTER_AREA)
                yield frame.astype(np.float32)
                n += 1
        finally:
            cap.release()

    def pairs(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        prev = None
        for frame in self:
            if prev is not None:
                yield prev, frame
            prev = frame

    def read_all(self) -> list[np.ndarray]:
        return list(self)
