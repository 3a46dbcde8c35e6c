"""The plain reference of the benchmark's flow: pyramidal Lucas-Kanade on
one (H, W) frame pair, in plain PyTorch, float32 with TF32 off.

A frozen copy of the equations that the served fast path computes, written
from them and sharing no code with the program under test:

- the Gaussian pyramid: each step blurs with scipy.ndimage's Gaussian
  (sigma = 1 / scale, radius int(4 sigma + 0.5), symmetric boundary with
  the edge included) and resamples bilinearly onto ``np.linspace(0, n - 1,
  int(n * scale))``, the two composed per axis in float64 into one
  operator, applied as two dense float32 matmuls (rows, then columns);
- the flow upsample: the same linspace resample of u and v to the finer
  level's shape, u scaled by fine_w / coarse_w and v by fine_h / coarse_h;
- the vertical band (where the config has a ladder): at each finer level
  the narrowest band b of the ladder such that at most ``adaptive_v_frac``
  of the upsampled |v| inside a margin of 2 (max_disp + window) exceeds
  b - 1; the coarsest level takes ``max_disp_v`` (or ``max_disp``);
- up to ``iterations`` rounds a level, each: the banded bilinear backward
  warp of the current level with the flow clamped to (max_disp, band), the
  source column clamped to the band, rows outside the band and the image
  reading 0; corners as float32 ("exact"), whole gray levels ("u8", the
  finest level where ``warp_packed_u8``) or 8.8 fixed point ("u16", the
  other levels where ``warp_packed_u16``); then the LK solve between the
  previous level and the warped one: Sobel / 8 of the averaged frames
  (separable in relaxed order, direct otherwise), the temporal
  difference, 5x5 window sums (pairwise doubling in relaxed order,
  sequential otherwise), the Cramer solve in reciprocal form gated on
  |det| > det_threshold, zero outside the interior; the clamped flow plus
  (du, dv); the level latches once mean |du| and mean |dv| both fall under
  ``convergence_threshold`` and runs no further round.

``control=True`` computes the pyramid and upsample matmuls in TF32 (the
next precision below the stated float32): on the card with cuBLAS's TF32
path, on the CPU by rounding each matmul operand to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


# Decisions this near their thresholds are taken both ways (``flows``): a
# level's mean |du| or |dv| against the latch's 0.01 px (the program's
# sums differ from these by float32 rounding, ~1e-7 px), and a band's count
# of pixels against its share of the interior (a pixel's |v| within
# rounding of a band's edge, ~1e-5 px, is one of ~20 in 2 M).
LATCH_NEAR = 2e-5
BAND_NEAR_PX = 64
MOST_CANDIDATES = 8


def gaussian_taps(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return phi / phi.sum()


@functools.lru_cache(maxsize=16)
def resample_operator(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) bilinear weights onto the linspace grid, float64."""
    coords = np.linspace(0.0, float(n_src - 1), n_dst)
    c0 = np.clip(np.floor(coords).astype(np.int64), 0, n_src - 1)
    c1 = np.clip(c0 + 1, 0, n_src - 1)
    frac = coords - np.floor(coords)
    m = np.zeros((n_dst, n_src))
    np.add.at(m, (np.arange(n_dst), c0), 1.0 - frac)
    np.add.at(m, (np.arange(n_dst), c1), frac)
    return m


@functools.lru_cache(maxsize=16)
def downsample_operator(n_src: int, n_dst: int, sigma: float) -> np.ndarray:
    """(n_dst, n_src) resample-after-blur operator, float64."""
    taps = gaussian_taps(sigma)
    r = len(taps) // 2
    blur = np.zeros((n_src, n_src))
    rows = np.arange(n_src)
    for k, t in enumerate(taps):
        p = rows - r + k
        p = np.where(p < 0, -1 - p, p)
        p = np.where(p >= n_src, 2 * n_src - 1 - p, p)
        np.add.at(blur, (rows, p), t)
    return resample_operator(n_src, n_dst) @ blur


def _to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), nearest even."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return rounded.view(torch.float32)


class Matmul:
    """Dense float32 matmuls of the float64 operators, TF32 off, or TF32
    for the control."""

    def __init__(self, device: torch.device, control: bool = False):
        self.device = device
        self.control = control

    def operator(self, d: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(d, np.float32)).to(self.device)

    @contextlib.contextmanager
    def _mode(self):
        if self.device.type != "cuda":
            yield
            return
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.control
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.control and self.device.type != "cuda":
            a, b = _to_tf32(a), _to_tf32(b)
        with self._mode():
            return a @ b

    def apply(self, left: np.ndarray, x: torch.Tensor, right: np.ndarray) -> torch.Tensor:
        """``left @ x @ right.T``, rows first."""
        return self(self(self.operator(left), x), self.operator(right).T)


def pyramid(frame: torch.Tensor, levels: int, scale: float, mm: Matmul) -> list[torch.Tensor]:
    """Coarsest level first."""
    out = [frame]
    for _ in range(levels - 1):
        h, w = out[-1].shape
        nh, nw = int(h * scale), int(w * scale)
        sigma = 1.0 / scale
        out.append(mm.apply(downsample_operator(h, nh, sigma), out[-1],
                            downsample_operator(w, nw, sigma)))
    return out[::-1]


def upsample(u: torch.Tensor, v: torch.Tensor, shape: tuple[int, int], mm: Matmul):
    (ch, cw), (th, tw) = u.shape, shape
    rh, rw = resample_operator(ch, th), resample_operator(cw, tw)
    return mm.apply(rh, u, rw) * (tw / cw), mm.apply(rh, v, rw) * (th / ch)


def band_index(v: torch.Tensor, bands: tuple[int, ...], frac: float,
               margin: int) -> tuple[int, list[int]]:
    """The band's index in the ladder, and the other indices that a count
    within ``BAND_NEAR_PX`` of its threshold could give instead."""
    h, w = v.shape
    my, mx = min(margin, max((h - 1) // 2, 0)), min(margin, max((w - 1) // 2, 0))
    inner = v[my : h - my, mx : w - mx].abs()
    idx, flips = 0, []
    for b in bands[:-1]:
        count = (inner > (b - 1.0)).to(torch.float32).sum()
        over = int(count / inner.numel() > frac)
        idx += over
        if abs(float(count) - frac * inner.numel()) <= BAND_NEAR_PX:
            flips.append(-1 if over else 1)
    return idx, [idx + f for f in flips]


def warp(image: torch.Tensor, u: torch.Tensor, v: torch.Tensor, max_disp: int, band: int,
         packing: str) -> torch.Tensor:
    """out(x, y) = image(x + u, y + v) within the band, flow clamped."""
    h, w = image.shape
    dev = image.device
    u = u.clamp(-float(max_disp), float(max_disp))
    v = v.clamp(-float(band), float(band))
    xi = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    yi = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xf, yf = xi.to(torch.float32) + u, yi.to(torch.float32) + v
    x0f, y0f = torch.floor(xf), torch.floor(yf)
    fx, fy = xf - x0f, yf - y0f
    ix0 = x0f.to(torch.int32)
    x0 = torch.minimum(torch.maximum(ix0, xi - (max_disp + 1)), xi + max_disp).clamp(0, w - 1)
    if packing == "exact":
        x1 = torch.minimum(torch.maximum(ix0 + 1, xi - (max_disp + 1)), xi + max_disp + 1)
        x1 = x1.clamp(0, w - 1)
    else:
        x1 = x0 + 1  # column w reads the zero column
    y0 = y0f.to(torch.int32)
    f = y0 - yi
    if packing == "u8":
        dec = image.to(torch.int32).to(torch.float32)
    elif packing == "u16":
        dec = ((image * 256.0 + 0.5).to(torch.int32) & 0xFFFF).to(torch.float32)
    else:
        dec = image
    flat = torch.nn.functional.pad(dec, (0, 1)).flatten()
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def row(r):
        inside = (r >= 0) & (r < h)
        base = r.clamp(0, h - 1).to(torch.int64) * (w + 1)
        c0 = torch.where(inside, flat[base + x0.to(torch.int64)], zero)
        c1 = torch.where(inside, flat[base + x1.to(torch.int64)], zero)
        return c0 * (1.0 - fx) + c1 * fx

    top = torch.where((f >= -band) & (f <= band + 1), row(y0), zero)
    bottom = torch.where((f >= -band) & (f <= band), row(y0 + 1), zero)
    out = top * (1.0 - fy) + bottom * fy
    if packing == "u16":
        out = out * (1.0 / 256.0)
    valid = (xf >= 0.0) & (xf <= float(w - 1)) & (yf >= 0.0) & (yf <= float(h - 1))
    return torch.where(valid, out, zero)


def _window_sum(a: torch.Tensor, n: int, out_h: int, out_w: int, tree: bool) -> torch.Tensor:
    """Sliding n-tap sums down the rows, then across the columns."""

    def along(x: torch.Tensor, axis: int, length: int) -> torch.Tensor:
        if not tree:
            out = x.narrow(axis, 0, length)
            for d in range(1, n):
                out = out + x.narrow(axis, d, length)
            return out
        runs, c = {1: x}, 1
        while 2 * c <= n:
            r = runs[c]
            k = x.shape[axis] - 2 * c + 1
            runs[2 * c] = r.narrow(axis, 0, k) + r.narrow(axis, c, k)
            c *= 2
        out, off, rest = None, 0, n
        for size in sorted(runs, reverse=True):
            while rest >= size:
                piece = runs[size].narrow(axis, off, length)
                out = piece if out is None else out + piece
                off, rest = off + size, rest - size
        return out

    return along(along(a, 0, out_h), 1, out_w)


def lk_delta(prev: torch.Tensor, warped: torch.Tensor, window: int, det_threshold: float,
             relaxed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(du, dv) of one LK solve, zero outside the interior."""
    h, w = prev.shape
    half = window // 2

    def pad(x):
        x = torch.cat([x[:1], x, x[-1:]], dim=0)
        x = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
        return torch.nn.functional.pad(x, (half, half, half, half))

    p, c = pad(prev), pad(warped)
    gh, gw = h + 2 * half, w + 2 * half
    avg = (p + c) * 0.5
    if relaxed:
        sv = avg[0:gh] + 2.0 * avg[1 : gh + 1] + avg[2 : gh + 2]
        dv = avg[0:gh] - avg[2 : gh + 2]
        ix = (sv[:, 0:gw] - sv[:, 2 : gw + 2]) * 0.125
        iy = (dv[:, 0:gw] + 2.0 * dv[:, 1 : gw + 1] + dv[:, 2 : gw + 2]) * 0.125
    else:
        def at(dy, dx):
            return avg[1 + dy : 1 + dy + gh, 1 + dx : 1 + dx + gw]

        ix = ((at(-1, -1) - at(-1, 1)) + 2.0 * (at(0, -1) - at(0, 1))
              + (at(1, -1) - at(1, 1))) * 0.125
        iy = ((at(-1, -1) - at(1, -1)) + 2.0 * (at(-1, 0) - at(1, 0))
              + (at(-1, 1) - at(1, 1))) * 0.125
    it = p[1 : gh + 1, 1 : gw + 1] - c[1 : gh + 1, 1 : gw + 1]

    def wsum(a):
        return _window_sum(a, window, h, w, relaxed)

    sxx, syy, sxy = wsum(ix * ix), wsum(iy * iy), wsum(ix * iy)
    b0, b1 = -wsum(ix * it), -wsum(iy * it)
    det = sxx * syy - sxy * sxy
    ok = det.abs() > det_threshold
    one, zero = torch.ones_like(det), torch.zeros_like(det)
    inv = torch.where(ok, one / torch.where(ok, det, one), zero)
    du = (syy * b0 - sxy * b1) * inv
    dv = (sxx * b1 - sxy * b0) * inv
    rows = torch.arange(h, device=det.device)[:, None]
    cols = torch.arange(w, device=det.device)[None, :]
    inner = (rows >= half) & (rows < h - half) & (cols >= half) & (cols < w - half)
    return torch.where(inner, du, zero), torch.where(inner, dv, zero)


def flows(prev: torch.Tensor, curr: torch.Tensor, pyr: dict, control: bool = False,
          most: int = MOST_CANDIDATES) -> list:
    """The flow from ``prev`` to ``curr`` ((H, W) float32 frames of 8-bit
    values) under the config's ``pyr`` settings (``PyramidConfig``'s field
    names), as ``(u, v, info)``: ``info`` holds what the control flow chose,
    coarsest level first (the rounds each level ran, its band) and how many
    decisions took their other side (``near``).

    The latch and the band are decisions on sums of rounded numbers. Where
    a level's mean |du| or |dv| lies within ``LATCH_NEAR`` of the latch's
    threshold, or a band's count within ``BAND_NEAR_PX`` of its own, float32
    rounding elsewhere may take the other side; both sides are followed and
    every answer is returned, the nominal one first, at most ``most``."""
    mm = Matmul(prev.device, control)
    levels, scale = pyr["levels"], pyr["scale_factor"]
    window, max_disp = pyr["window_size"], pyr["max_disp"]
    iterations, thr = pyr["iterations"], pyr["convergence_threshold"]
    static_band = pyr["max_disp_v"] if pyr["max_disp_v"] is not None else max_disp
    ladder = tuple(pyr["adaptive_v_bands"] or ())
    p_prev = pyramid(prev, levels, scale, mm)
    p_curr = pyramid(curr, levels, scale, mm)
    out: list = []

    def one_round(level, u, v, band):
        packing = ("u8" if pyr["warp_packed_u8"] and level == levels - 1
                   else "u16" if pyr["warp_packed_u16"] else "exact")
        warped = warp(p_curr[level], u, v, max_disp, band, packing)
        du, dv = lk_delta(p_prev[level], warped, window, pyr["det_threshold"],
                          pyr["relaxed_order"])
        u = u.clamp(-float(max_disp), float(max_disp)) + du
        v = v.clamp(-float(band), float(band)) + dv
        px = du.numel()
        return u, v, (float(du.abs().sum() / px), float(dv.abs().sum() / px))

    def ran(info, n, band, flipped=0):
        return dict(info, rounds=info["rounds"] + [n], bands=info["bands"] + [band],
                    near=info["near"] + flipped)

    def enter(level, u, v, info):
        if len(out) >= most:
            return
        if level == levels:
            out.append((u, v, info))
            return
        bands = [static_band]
        if level > 0:
            u, v = upsample(u, v, tuple(p_prev[level].shape), mm)
            if ladder:
                idx, others = band_index(v, ladder, pyr["adaptive_v_frac"],
                                         2 * (max_disp + window))
                bands = [ladder[i] for i in dict.fromkeys([idx, *others])
                         if 0 <= i < len(ladder)]
        for i, band in enumerate(bands):
            rounds(level, u, v, band, 0, dict(info, near=info["near"] + (i > 0)))

    def rounds(level, u, v, band, done, info):
        """Rounds ``done + 1`` on of ``level``, then the next level."""
        n = done
        for n in range(done + 1, iterations + 1):
            u, v, means = one_round(level, u, v, band)
            stop = means[0] < thr and means[1] < thr
            near = (n < iterations and all(m < thr + LATCH_NEAR for m in means)
                    and any(abs(m - thr) <= LATCH_NEAR for m in means))
            if near and stop:  # stop; then the rounds that a clear latch runs
                enter(level + 1, u, v, ran(info, n, band))
                rounds(level, u, v, band, n, dict(info, near=info["near"] + 1))
                return
            if near:  # go on; then stop here, as a set latch would
                rounds(level, u, v, band, n, info)
                enter(level + 1, u, v, ran(info, n, band, flipped=1))
                return
            if stop:
                break
        enter(level + 1, u, v, ran(info, n, band))

    enter(0, torch.zeros_like(p_prev[0]), torch.zeros_like(p_prev[0]),
          {"rounds": [], "bands": [], "near": 0})
    return out


def flow(prev: torch.Tensor, curr: torch.Tensor, pyr: dict, control: bool = False):
    """The nominal answer of ``flows``: every decision on its own side."""
    return flows(prev, curr, pyr, control, most=1)[0]
