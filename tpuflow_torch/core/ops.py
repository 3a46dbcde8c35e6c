"""SciPy-parity numerics in PyTorch.

Counterpart of ``tpuflow.core.ops``: the same symmetric-boundary
convolution, Gaussian smoothing, bilinear ``map_coordinates`` sampling and
linspace resampling, in the same f32 expression order. Small-kernel
correlations are unrolled shifted multiply-adds; the pyramid resample and
blur are banded f32 matmuls built from the same f64 numpy operators.

Matmuls run in true f32: on a CUDA tensor the banded products first pin
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False (TF32 keeps about three
decimal digits, far outside the pyramid's tolerance).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def pin_f32_matmul() -> None:
    """Keep f32 matmuls and convolutions in true f32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _corr2d_valid(x: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """VALID-mode 2-D correlation via unrolled static shifts."""
    k = np.asarray(k)
    kh, kw = k.shape
    oh, ow = x.shape[0] - kh + 1, x.shape[1] - kw + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            w = float(k[i, j])
            if w == 0.0:
                continue
            term = w * x[i : i + oh, j : j + ow]
            out = term if out is None else out + term
    assert out is not None
    return out


def _corr1d_valid(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """VALID-mode 1-D correlation along ``axis`` via unrolled shifts."""
    n = len(taps)
    length = x.shape[axis] - n + 1
    out = float(taps[0]) * x.narrow(axis, 0, length)
    for i in range(1, n):
        out = out + float(taps[i]) * x.narrow(axis, i, length)
    return out


@functools.lru_cache(maxsize=None)
def _symmetric_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """The gather index of a symmetric pad, on ``device``. Memoised: a copy
    to the card waits for its queue, and the VO step pads every frame."""
    return torch.from_numpy(np.pad(np.arange(n), pad, mode="symmetric")).to(device)


def _pad_symmetric(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """``np.pad(x, ((ph, ph), (pw, pw)), mode="symmetric")`` (edge included)."""
    h, w = x.shape
    if ph:
        x = x[_symmetric_index(h, ph, x.device)]
    if pw:
        x = x[:, _symmetric_index(w, pw, x.device)]
    return x


def conv2d_symm(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """``scipy.signal.convolve2d(img, kernel, mode="same", boundary="symm")``
    for odd kernels: correlation with the flipped kernel."""
    kh, kw = kernel.shape
    assert kh % 2 == 1 and kw % 2 == 1, "odd kernels only"
    flipped = np.ascontiguousarray(kernel[::-1, ::-1])
    return _corr2d_valid(_pad_symmetric(img, kh // 2, kw // 2), flipped)


@functools.lru_cache(maxsize=None)
def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage's 1-D Gaussian taps (radius ``int(truncate*sigma+0.5)``,
    normalized to sum 1, float64)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    phi /= phi.sum()
    return phi


def gaussian_filter(img: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter(img, sigma)``: separable, 'reflect'
    (symmetric) boundary, rows then columns."""
    taps = gaussian_kernel1d(sigma, truncate).astype(np.float32)
    r = len(taps) // 2
    out = _corr1d_valid(_pad_symmetric(img, r, 0), taps, axis=0)
    return _corr1d_valid(_pad_symmetric(out, 0, r), taps, axis=1)


def map_coordinates_bilinear(
    img: torch.Tensor, y: torch.Tensor, x: torch.Tensor, cval: float = 0.0
) -> torch.Tensor:
    """``scipy.ndimage.map_coordinates(img, [y, x], order=1,
    mode="constant", cval=cval)``: any coordinate outside ``[0, N-1]``
    reads ``cval``; corners are clamped into the array."""
    h, w = img.shape
    y0f = torch.floor(y)
    x0f = torch.floor(x)
    fy = (y - y0f).to(img.dtype)
    fx = (x - x0f).to(img.dtype)
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)

    def corner(yi, xi):
        return img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)

    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    val = top * (1.0 - fy) + bot * fy

    inside = (y >= 0) & (y <= h - 1) & (x >= 0) & (x <= w - 1)
    return torch.where(inside, val, torch.full_like(val, cval))


def linspace_grid(n_src: int, n_dst: int) -> np.ndarray:
    """``np.linspace(0, n_src - 1, n_dst)`` in float64: the pyramid's
    resampling grid."""
    return np.linspace(0.0, float(n_src - 1), n_dst)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resample to (out_h, out_w) on the linspace grid as two banded
    matmuls against the two-tap interpolation operators."""
    h, w = img.shape
    out = _banded_left(_resample_matrix_np, (h, out_h), img)
    return _banded_right(out, _resample_matrix_np, (w, out_w))


def downsample_fused(
    img: torch.Tensor, out_h: int, out_w: int, sigma: float
) -> torch.Tensor:
    """Gaussian smooth + linspace bilinear resample, composed per axis in
    f64 into one operator ``D = R @ G`` and applied as two f32 matmuls."""
    h, w = img.shape
    out = _banded_left(_downsample_matrix_np, (h, out_h, sigma), img)
    return _banded_right(out, _downsample_matrix_np, (w, out_w, sigma))


# Output-block size of the banded matmuls: above this many output rows the
# operator is split into row blocks, each multiplied only against its
# exact nonzero column range (the operators are banded around the scaled
# diagonal, so the dropped tails are exact zeros).
_BAND_BLOCK = 256


def _banded_blocks(d_np: np.ndarray, block: int):
    """Static (row0, row1, col0, col1) block decomposition of a banded
    operator, from its exact f64 zero pattern."""
    m, n = d_np.shape
    out = []
    for b0 in range(0, m, block):
        b1 = min(b0 + block, m)
        nz = np.nonzero(np.abs(d_np[b0:b1]).sum(axis=0) > 0.0)[0]
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        out.append((b0, b1, lo, hi))
    return out


@functools.lru_cache(maxsize=None)
def _operator_blocks(builder, args: tuple, device: torch.device):
    """f32 copies of an operator's blocks on ``device``: the dense operator
    up to ``_BAND_BLOCK`` output rows, else ``(b0, b1, lo, hi, block)``
    per row block. Memoised: the operators are constants of the shapes,
    like the numpy builders they come from."""
    d_np = builder(*args)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    if d_np.shape[0] <= _BAND_BLOCK:
        return dev(d_np)
    return tuple(
        (b0, b1, lo, hi, dev(d_np[b0:b1, lo:hi]))
        for b0, b1, lo, hi in _banded_blocks(d_np, _BAND_BLOCK)
    )


def _banded_left(builder, args: tuple, img: torch.Tensor) -> torch.Tensor:
    """``D @ img`` exploiting D's band structure (see ``_BAND_BLOCK``)."""
    if img.is_cuda:
        pin_f32_matmul()
    blocks = _operator_blocks(builder, args, img.device)
    if isinstance(blocks, torch.Tensor):
        return blocks @ img
    outs = [d @ img[lo:hi] for _, _, lo, hi, d in blocks]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _banded_right(img: torch.Tensor, builder, args: tuple) -> torch.Tensor:
    """``img @ D.T`` exploiting D's band structure (column blocks)."""
    if img.is_cuda:
        pin_f32_matmul()
    blocks = _operator_blocks(builder, args, img.device)
    if isinstance(blocks, torch.Tensor):
        return img @ blocks.T
    outs = [img[:, lo:hi] @ d.T for _, _, lo, hi, d in blocks]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


@functools.lru_cache(maxsize=None)
def _downsample_matrix_np(
    n_src: int, n_dst: int, sigma: float, truncate: float = 4.0
) -> np.ndarray:
    """(n_dst, n_src) composed resample-after-blur operator, f64."""
    taps = gaussian_kernel1d(sigma, truncate)
    r = len(taps) // 2
    g = np.zeros((n_src, n_src), np.float64)
    rows = np.arange(n_src)
    for k, t in enumerate(taps):
        p = rows - r + k
        # numpy/scipy 'symmetric'/'reflect' boundary: edge included.
        p = np.where(p < 0, -1 - p, p)
        p = np.where(p >= n_src, 2 * n_src - 1 - p, p)
        np.add.at(g, (rows, p), t)
    return _resample_matrix_np(n_src, n_dst) @ g


@functools.lru_cache(maxsize=None)
def _resample_matrix_np(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) bilinear interpolation matrix for the linspace
    grid; two nonzero weights per row, computed in f64."""
    coords = linspace_grid(n_src, n_dst)
    c0 = np.clip(np.floor(coords).astype(np.int64), 0, n_src - 1)
    c1 = np.clip(c0 + 1, 0, n_src - 1)
    frac = coords - np.floor(coords)
    m = np.zeros((n_dst, n_src), np.float64)
    rows = np.arange(n_dst)
    np.add.at(m, (rows, c0), 1.0 - frac)
    np.add.at(m, (rows, c1), frac)
    return m


def uniform_window_sum_valid(img: torch.Tensor, window: int) -> torch.Tensor:
    """Sum over every fully-interior ``window x window`` patch ('valid'),
    rows then columns, taps added in sequential order."""
    ones = np.ones((window,), np.float32)
    return _corr1d_valid(_corr1d_valid(img, ones, axis=0), ones, axis=1)


def gaussian_window_kernel(window: int, sigma: float) -> np.ndarray:
    """Separable Gaussian window weights (opt-in weighted accumulation)."""
    r = window // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    k2 = np.outer(phi, phi)
    k2 /= k2.sum()
    return k2.astype(np.float32)


def weighted_window_sum_valid(img: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """'valid' weighted window sum with a static 2-D weight kernel."""
    return _corr2d_valid(img, weights)
