"""Host-side IO, numpy only: frames and flow dumps in the reference's
interchange formats (``frames``), IMU sample text (``imu``) and video
decode (``video``, OpenCV imported when a video is opened).

This package keeps its own copies of ``tpuflow.io``'s modules; it imports
nothing of ``tpuflow`` (nor its optional native extension).
"""
