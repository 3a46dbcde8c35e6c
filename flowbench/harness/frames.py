"""The traffic: 8-bit camera frames made from the seed, and the sources
that hand them to the program's input path.

Each stream (camera) is its own band-limited noise texture: a random
spectrum under a smooth envelope, cut off above ``cutoff`` cycles a pixel,
so a sub-pixel shift is exact (the phase ramp of the shift theorem) and
the wrap at the frame's edges moves with the content. Frame k of a stream
shows the texture moved by p_k = d_0 + ... + d_(k-1); the flow from frame
k to k + 1 is d_k. A ring of ``ring`` frames a stream is made once on the
device, rounded to 8 bits, and copied into host memory; the sources read
it in ping-pong order (0, 1, ..., ring - 1, ring - 2, ..., 1, 0, 1, ...),
so every pair moves, the way back by -d.

Motion: the moving streams' |dx| and |dy| are the midpoints of
``moving_streams`` (law ``constant``: one velocity a stream) or of
``ring - 1`` (law ``per_step``: one a step of the ring) equal parts of the
traffic's ranges, dealt out in an order drawn from the seed, with signs
drawn from it. So every seed gets the same set of velocities: the seed
changes the textures, the order and the signs, not the amount of work.
Still streams (``still_share`` of them) do not move. Sensor noise:
Gaussian with ``noise_sigma`` gray levels, drawn anew for every frame
before the rounding.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator

import numpy as np
import torch

GRAY_MEAN = 128.0


def ring_index(step: int, ring: int) -> int:
    """The ring frame of global step ``step`` in ping-pong order."""
    period = 2 * (ring - 1)
    i = step % period
    return i if i < ring else period - i


def _midpoints(lo: float, hi: float, n: int) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def displacements(traffic: dict, rng: np.random.Generator) -> np.ndarray:
    """(streams, ring - 1, 2) float64 (dx, dy) of every stream's ring steps."""
    b, ring = traffic["streams"], traffic["ring"]
    n_still = int(round(traffic["still_share"] * b))
    moving = np.sort(rng.permutation(b)[n_still:])
    d = np.zeros((b, ring - 1, 2))
    if len(moving) == 0:
        return d
    per_step = traffic["law"] == "per_step"
    n = (ring - 1) if per_step else len(moving)
    for axis, key in ((0, "dx"), (1, "dy")):
        values = _midpoints(*traffic[key], n)
        if per_step:
            for s in moving:
                signs = rng.choice((-1.0, 1.0), size=n)
                d[s, :, axis] = rng.permutation(values) * signs
        else:
            signs = rng.choice((-1.0, 1.0), size=n)
            d[moving, :, axis] = (rng.permutation(values) * signs)[:, None]
    return d


def _texture_spectrum(height: int, width: int, traffic: dict, gen: torch.Generator,
                      device: torch.device) -> torch.Tensor:
    fy = torch.fft.fftfreq(height, device=device)[:, None]
    fx = torch.fft.rfftfreq(width, device=device)[None, :]
    f = torch.sqrt(fy * fy + fx * fx)
    envelope = torch.where(f < traffic["cutoff"], 1.0 / (1.0 + (f / traffic["corner"]) ** 2),
                           torch.zeros_like(f))
    envelope[0, 0] = 0.0
    re = torch.randn(height, width // 2 + 1, generator=gen, device=device)
    im = torch.randn(height, width // 2 + 1, generator=gen, device=device)
    return torch.complex(re, im) * envelope


def make_ring(traffic: dict, height: int, width: int, seed: int,
              device: torch.device) -> np.ndarray:
    """The host ring, (ring, streams, H, W) uint8, made on ``device`` from
    ``seed``."""
    rng = np.random.default_rng([seed % 2**64, 0x7F10])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    d = displacements(traffic, rng)
    b, ring = traffic["streams"], traffic["ring"]
    host = np.empty((ring, b, height, width), dtype=np.uint8)
    fy = torch.fft.fftfreq(height, device=device, dtype=torch.float64)[None, :, None]
    fx = torch.fft.rfftfreq(width, device=device, dtype=torch.float64)[None, None, :]
    for s in range(b):
        spectrum = _texture_spectrum(height, width, traffic, gen, device)
        pos = np.concatenate([np.zeros((1, 2)), np.cumsum(d[s], axis=0)])
        px = torch.tensor(pos[:, 0], dtype=torch.float64, device=device)[:, None, None]
        py = torch.tensor(pos[:, 1], dtype=torch.float64, device=device)[:, None, None]
        ramp = torch.polar(torch.ones((), dtype=torch.float64, device=device),
                           -2.0 * np.pi * (fx * px + fy * py)).to(torch.complex64)
        frames = torch.fft.irfft2(spectrum[None] * ramp, s=(height, width))
        # A periodic shift keeps the spread, so frame 0's scales them all.
        frames = frames * (traffic["contrast"] / frames[0].std()) + GRAY_MEAN
        if traffic["noise_sigma"] > 0:
            frames = frames + traffic["noise_sigma"] * torch.randn(
                frames.shape, generator=gen, device=device)
        host[:, s] = frames.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    return host


class Source:
    """Hands frame batches over to the input path and stamps each handover
    on the host clock. ``recorded``: as the input path asks. ``live``: a
    camera; batch k only once step k - 1's end event has completed
    (``wait_for(k)`` blocks until then; its seconds go to ``waited``)."""

    def __init__(self, ring: np.ndarray, first_step: int,
                 wait_for: Callable[[int], None] | None = None):
        self.ring = ring
        self.step = first_step
        self.wait_for = wait_for
        self.handed: dict[int, float] = {}
        self.waited: dict[int, float] = {}
        # One camera hands (H, W) frames over; B cameras a (B, H, W) batch.
        self.one = ring.shape[1] == 1

    def __iter__(self) -> Iterator[np.ndarray]:
        n = self.ring.shape[0]
        while True:
            k = self.step
            if self.wait_for is not None:
                t = time.perf_counter()
                self.wait_for(k)
                self.waited[k] = time.perf_counter() - t
            self.handed[k] = time.perf_counter()
            self.step += 1
            batch = self.ring[ring_index(k, n)]
            yield batch[0] if self.one else batch
