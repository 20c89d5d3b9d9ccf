"""Dense Farneback optical flow in torch ops, on any device (the flow that
tools/motion_level.py::compute_flow of the JAX package reaches through
OpenCV: cv2.calcOpticalFlowFarneback(prev, curr, None, 0.5, 3, 15, 3, 5,
1.2, 0), whose parameters are fixed here).

It follows OpenCV's algorithm (modules/video/src/optflowgf.cpp), step for
step, so that its flow agrees with OpenCV's to a few thousandths of a
pixel:

  * levels: the pyramid has up to LEVELS + 1 levels, fewer where a side
    of the scaled image would fall below MIN_SIZE; level k is at scale
    PYR_SCALE^k and size round(W * scale) x round(H * scale);
  * each image, as f32, is Gaussian-blurred with sigma (1/scale - 1) / 2
    and a kernel of max(round(5 sigma) | 1, 3) taps (sigma 0 takes
    OpenCV's fixed 3-tap [1/4, 1/2, 1/4]), border reflect-101, then
    resized bilinearly (half-pixel centres, no antialias);
  * the coarser level's flow is resized bilinearly and scaled by
    1 / PYR_SCALE (zero flow at the coarsest level);
  * the polynomial expansion (POLY_N 5, sigma 1.2): separable Gaussian-
    weighted sums, rows in f32 and columns in f64, borders replicated;
  * the matrices: A the mean of R0's and R1's quadratic terms, R1 sampled
    bilinearly at x + flow (R0's alone where that point leaves the image),
    the pixels within 5 of an edge weighted by OpenCV's border weights;
  * ITERATIONS flow updates from the 15 x 15 box means (f64, borders
    replicated) of the matrices, the last without updating them.

The two images go through each step together, as one batch of two.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PYR_SCALE = 0.5
LEVELS = 3
WINSIZE = 15
ITERATIONS = 3
POLY_N = 5
POLY_SIGMA = 1.2
MIN_SIZE = 32
BORDER = (0.14, 0.14, 0.4472, 0.4472, 0.4472)
# OpenCV's fixed kernels for sigma <= 0 and an odd size up to 7
_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25],
                   5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875,
                       0.109375, 0.03125]}


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(n, sigma) as f32 taps."""
    if sigma <= 0 and n in _SMALL_GAUSSIAN:
        return np.array(_SMALL_GAUSSIAN[n], np.float32)
    if sigma <= 0:
        sigma = ((n - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    g = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (g / g.sum()).astype(np.float32)


def pyramid(height: int, width: int):
    """[((h, w), sigma, taps)] of the levels, coarsest first."""
    levels, scale = 0, 1.0
    for levels in range(LEVELS):
        scale *= PYR_SCALE
        if width * scale < MIN_SIZE or height * scale < MIN_SIZE:
            break
    else:
        levels = LEVELS
    out = []
    for k in range(levels, -1, -1):
        scale = PYR_SCALE ** k
        sigma = (1.0 / scale - 1) * 0.5
        taps = max(round(sigma * 5) | 1, 3)
        out.append(((round(height * scale), round(width * scale)), sigma,
                    taps))
    return out


def _sep_sum(x: torch.Tensor, kernel, dim: int) -> torch.Tensor:
    """sum_i kernel[i] * x shifted by i - n//2 along `dim` of an already
    padded x (the output n - 1 shorter there)."""
    n = len(kernel)
    size = x.shape[dim] - n + 1
    out = x.narrow(dim, 0, size) * float(kernel[0])
    for i in range(1, n):
        out = out + x.narrow(dim, i, size) * float(kernel[i])
    return out


def gaussian_blur(imgs: torch.Tensor, taps: int, sigma: float):
    """cv2.GaussianBlur(img, (taps, taps), sigma, sigma) of each (H, W)
    image of imgs (N, H, W), f32, border reflect-101: rows, then
    columns."""
    k = gaussian_kernel(taps, sigma)
    r = taps // 2
    x = F.pad(imgs[:, None], (r, r, 0, 0), mode="reflect")[:, 0]
    x = _sep_sum(x, k, 2)
    x = F.pad(x[:, None], (0, 0, r, r), mode="reflect")[:, 0]
    return _sep_sum(x, k, 1)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """cv2.resize(..., INTER_LINEAR) of (N, C, H, W) to `size` (h, w)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=False)


def _poly_tables(n: int, sigma: float):
    """(g, xg, xxg) f32 taps for offsets 0..n and OpenCV's (ig11, ig03,
    ig33, ig55), the entries of the inverse of the 6 x 6 Gram matrix
    (FarnebackPrepareGaussian)."""
    xs = np.arange(-n, n + 1)
    g = np.exp(-(xs * xs) / (2 * sigma * sigma)).astype(np.float32)
    g = (g.astype(np.float64) * (1.0 / g.astype(np.float64).sum())).astype(
        np.float32)
    xg = (xs * g).astype(np.float32)
    xxg = (xs * xs * g).astype(np.float32)
    G = np.zeros((6, 6))
    for y in range(-n, n + 1):
        for x in range(-n, n + 1):
            gg = np.float32(g[y + n] * g[x + n])
            G[0, 0] += gg
            G[1, 1] += np.float32(gg * x * x)
            G[3, 3] += np.float32(gg * x * x * x * x)
            G[5, 5] += np.float32(gg * x * x * y * y)
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return (g[n:], xg[n:], xxg[n:],
            (inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5]))


def poly_exp(imgs: torch.Tensor, n: int = POLY_N,
             sigma: float = POLY_SIGMA) -> torch.Tensor:
    """FarnebackPolyExp of each image of imgs (N, H, W) f32: (N, 5, H, W)
    f32 coefficients [r_y, r_x, r_yy, r_xx, r_xy] (OpenCV's order),
    borders replicated."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_tables(n, sigma)
    H, W = imgs.shape[-2:]
    pad = F.pad(imgs[:, None], (0, 0, n, n), mode="replicate")[:, 0]
    # vertical part, f32: row sums at offsets +-k paired as OpenCV pairs them
    r0 = imgs * float(g[0])
    r1 = torch.zeros_like(imgs)
    r2 = torch.zeros_like(imgs)
    for k in range(1, n + 1):
        up = pad[:, n - k:n - k + H]
        down = pad[:, n + k:n + k + H]
        p = up + down
        r0 = r0 + float(g[k]) * p
        r1 = r1 + float(xg[k]) * (down - up)
        r2 = r2 + float(xxg[k]) * p
    rows = torch.stack([r0, r1, r2], 1).double()
    rows = F.pad(rows, (n, n, 0, 0), mode="replicate")
    # horizontal part, f64
    c = rows[..., n:n + W]
    b1, b3, b5 = c[:, 0] * float(g[0]), c[:, 1] * float(g[0]), \
        c[:, 2] * float(g[0])
    b2 = torch.zeros_like(b1)
    b4 = torch.zeros_like(b1)
    b6 = torch.zeros_like(b1)
    for k in range(1, n + 1):
        right = rows[..., n + k:n + k + W]
        left = rows[..., n - k:n - k + W]
        tg = right[:, 0] + left[:, 0]
        b1 = b1 + tg * float(g[k])
        b4 = b4 + tg * float(xxg[k])
        b2 = b2 + (right[:, 0] - left[:, 0]) * float(xg[k])
        b3 = b3 + (right[:, 1] + left[:, 1]) * float(g[k])
        b6 = b6 + (right[:, 1] - left[:, 1]) * float(xg[k])
        b5 = b5 + (right[:, 2] + left[:, 2]) * float(g[k])
    out = torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                       b1 * ig03 + b4 * ig33, b6 * ig55], 1)
    return out.float()


_BORDER_CACHE: dict = {}


def _border_weights(size: int, device) -> torch.Tensor:
    """Per index along one side: OpenCV's border weight from the low end
    times the one from the high end (1 inside), f32 on `device`, made once
    a size and device (no host copy inside a flow)."""
    key = (size, str(device))
    if key not in _BORDER_CACHE:
        lo = torch.ones(size, dtype=torch.float32)
        hi = torch.ones(size, dtype=torch.float32)
        for i, w in enumerate(BORDER[:size]):
            lo[i] = w
            hi[size - 1 - i] = w
        _BORDER_CACHE[key] = (lo * hi).to(device)
    return _BORDER_CACHE[key]


def update_matrices(R0: torch.Tensor, R1: torch.Tensor,
                    flow: torch.Tensor) -> torch.Tensor:
    """FarnebackUpdateMatrices: (5, H, W) f32 [G11, G12, G22, h1, h2] from
    R0, R1 (5, H, W) and flow (2, H, W) [dx, dy]."""
    _, H, W = R0.shape
    dev = R0.device
    dx, dy = flow[0], flow[1]
    xs = torch.arange(W, device=dev, dtype=torch.float32)
    ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    fx, fy = xs + dx, ys + dy
    x1, y1 = torch.floor(fx), torch.floor(fy)
    fx, fy = fx - x1, fy - y1
    x1, y1 = x1.long(), y1.long()
    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    x1 = torch.where(inside, x1, 0)
    y1 = torch.where(inside, y1, 0)
    flat = R1.reshape(5, H * W)
    base = y1 * W + x1

    def at(offset):
        return flat[:, (base + offset).reshape(-1)].reshape(5, H, W)

    a00, a01 = (1.0 - fx) * (1.0 - fy), fx * (1.0 - fy)
    a10, a11 = (1.0 - fx) * fy, fx * fy
    r = a00 * at(0) + a01 * at(1) + a10 * at(W) + a11 * at(W + 1)
    zero = torch.zeros_like(dx)
    r2 = torch.where(inside, r[0], zero)
    r3 = torch.where(inside, r[1], zero)
    r4 = torch.where(inside, (R0[2] + r[2]) * 0.5, R0[2])
    r5 = torch.where(inside, (R0[3] + r[3]) * 0.5, R0[3])
    r6 = torch.where(inside, (R0[4] + r[4]) * 0.25, R0[4] * 0.5)
    r2 = (R0[0] - r2) * 0.5
    r3 = (R0[1] - r3) * 0.5
    r2 = r2 + (r4 * dy + r6 * dx)
    r3 = r3 + (r6 * dy + r5 * dx)
    scale = (_border_weights(W, dev)[None, :]
             * _border_weights(H, dev)[:, None])
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3])


def box_mean(M: torch.Tensor, size: int = WINSIZE) -> torch.Tensor:
    """The size x size mean of each (H, W) plane of M (C, H, W), borders
    replicated, in f64 (FarnebackUpdateFlow_Blur's running sums)."""
    m = size // 2
    x = F.pad(M[None].double(), (m, m, m, m), mode="replicate")[0]
    x = torch.cumsum(F.pad(x, (0, 0, 1, 0)), 1)
    x = x[:, size:] - x[:, :-size]
    x = torch.cumsum(F.pad(x, (1, 0)), 2)
    x = x[..., size:] - x[..., :-size]
    return x * (1.0 / (size * size))


def update_flow(M: torch.Tensor) -> torch.Tensor:
    """FarnebackUpdateFlow_Blur's flow (2, H, W) f32 from the box means of
    M."""
    g11, g12, g22, h1, h2 = box_mean(M)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet]).float()


def farneback_flow(prev, curr, device="cuda") -> torch.Tensor:
    """Dense flow (H, W, 2) f32 [dx, dy] from image prev to image curr
    (each (H, W), uint8 or float, numpy or torch), computed on `device`:
    cv2.calcOpticalFlowFarneback(prev, curr, None, 0.5, 3, 15, 3, 5, 1.2,
    0)."""
    dev = torch.device(device)
    imgs = torch.stack([torch.as_tensor(np.asarray(v) if not
                                        isinstance(v, torch.Tensor) else v)
                        for v in (prev, curr)]).to(dev, torch.float32)
    H, W = imgs.shape[-2:]
    flow = None
    for size, sigma, taps in pyramid(H, W):
        if flow is None:
            flow = torch.zeros((2, *size), dtype=torch.float32, device=dev)
        else:
            flow = resize_bilinear(flow[None], size)[0] * (1.0 / PYR_SCALE)
        level = resize_bilinear(gaussian_blur(imgs, taps, sigma)[:, None],
                                size)[:, 0]
        R0, R1 = poly_exp(level)
        M = update_matrices(R0, R1, flow)
        for i in range(ITERATIONS):
            flow = update_flow(M)
            if i < ITERATIONS - 1:
                M = update_matrices(R0, R1, flow)
    return flow.permute(1, 2, 0).contiguous()


__all__ = ["farneback_flow", "pyramid", "gaussian_kernel", "poly_exp",
           "update_matrices", "update_flow", "box_mean"]
