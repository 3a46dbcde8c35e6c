"""Host-side IO, numpy only: frames and flow dumps in the reference's
interchange formats (``frames``), IMU sample text (``imu``), video decode
(``video``, OpenCV imported when a video is opened), ``.mem``/``.bin`` to
PNG (``convert``, Pillow imported then), the frame stream with its
read-ahead thread and uploads to the card (``stream``), and the native
frame IO under the ``.bin`` / ``.mem`` functions and the stream
(``fastio``, built from ``native/fastio.cpp`` with the host's C++
compiler at first use).

This package keeps its own copies of ``tpuflow.io``'s modules; it imports
nothing of ``tpuflow``, and its native IO is its own, not the JAX
package's extension.
"""

from tpuflow_torch.io.frames import (
    load_flow_text,
    load_frame_bin,
    load_frame_mem,
    save_flow_text,
    save_frame_bin,
    save_frame_mem,
)

__all__ = [
    "load_frame_bin",
    "save_frame_bin",
    "load_frame_mem",
    "save_frame_mem",
    "load_flow_text",
    "save_flow_text",
]
