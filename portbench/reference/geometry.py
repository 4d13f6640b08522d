"""Plain geometry of the reference: real spherical harmonics, per-edge frames,
Wigner-D blocks, the (l, m) layouts and the S2 grid tables.

Written for the benchmark in plain torch and numpy; it imports nothing of the
program.  Conventions (those of the published EquiformerV2 and of the model
under test):

* real spherical harmonics ordered ``m = -l..l`` within each degree (sine
  components at negative m), no Condon-Shortley phase in the real functions;
* each edge is rotated onto the z axis by a frame whose in-plane axes come
  from the cardinal axis least aligned with the edge;
* ``D_l(R)`` is the matrix with ``Y_l(R x) = D_l(R) Y_l(x)``.  It is found here
  by least squares on a fixed set of points (``Y_l(R P) = Y_l(P) D_l^T``),
  in float64, and not by Euler angles.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["real_sph_harm", "edge_frame", "wigner_blocks", "Layout", "grid_tables"]


def real_sph_harm(lmax: int, vec: torch.Tensor, normalization: str = "integral") -> torch.Tensor:
    """Real spherical harmonics of unit vectors [..., 3] -> [..., (lmax+1)^2],
    index ``l^2 + l + m``; ``"norm"`` scales degree l by sqrt(4 pi / (2l+1))."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    cos_m, sin_m = [torch.ones_like(x)], [torch.zeros_like(x)]
    for m in range(1, lmax + 1):   # u^m cos(m phi), u^m sin(m phi)
        cos_m.append(x * cos_m[-1] - y * sin_m[-1])
        sin_m.append(x * sin_m[-1] + y * cos_m[-2])
    # associated Legendre P_l^m(z) / u^m by the upward recurrence in l
    q = {}
    for m in range(lmax + 1):
        first = torch.full_like(z, float(np.prod(np.arange(1, 2 * m, 2))) if m else 1.0)
        col = [first]
        if m + 1 <= lmax:
            col.append((2 * m + 1) * z * first)
        for l in range(m + 2, lmax + 1):
            col.append(((2 * l - 1) * z * col[-1] - (l + m - 1) * col[-2]) / (l - m))
        q[m] = col
    out = []
    for l in range(lmax + 1):
        f = 1.0 if normalization == "integral" else math.sqrt(4 * math.pi / (2 * l + 1))
        row = {}
        for m in range(l + 1):
            k = math.sqrt((2 * l + 1) / (4 * math.pi) * math.factorial(l - m)
                          / math.factorial(l + m))
            if m == 0:
                row[0] = k * q[0][l]
            else:
                row[m] = math.sqrt(2.0) * k * q[m][l - m] * cos_m[m]
                row[-m] = math.sqrt(2.0) * k * q[m][l - m] * sin_m[m]
        out += [row[m] * f for m in range(-l, l + 1)]
    return torch.stack(out, dim=-1)


def edge_frame(vec: torch.Tensor) -> torch.Tensor:
    """Rows (a, b, v_hat) of each edge's frame, [E, 3, 3], so that R v_hat = z."""
    v = vec.detach()
    vhat = v / torch.clamp(v.norm(dim=-1, keepdim=True), min=1e-8)
    ref = torch.eye(3, dtype=v.dtype, device=v.device)[torch.argmin(vhat.abs(), dim=-1)]
    b = torch.linalg.cross(vhat, ref)
    b = b / torch.clamp(b.norm(dim=-1, keepdim=True), min=1e-8)
    a = torch.linalg.cross(b, vhat)
    return torch.stack([a, b, vhat], dim=-2)


@functools.lru_cache(maxsize=None)
def _probe_points(lmax: int) -> np.ndarray:
    """A fixed Fibonacci set of points on the sphere, enough for degree lmax."""
    n = 4 * (2 * lmax + 1) + 8
    i = np.arange(n) + 0.5
    z = 1 - 2 * i / n
    phi = math.pi * (1 + 5 ** 0.5) * i
    r = np.sqrt(1 - z * z)
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)


def wigner_blocks(lmax: int, vec: torch.Tensor) -> list[torch.Tensor]:
    """D_l of each edge's frame rotation, [E, 2l+1, 2l+1] per degree, float32
    (worked out in float64, detached)."""
    rot = edge_frame(vec.detach().double())
    pts = torch.as_tensor(_probe_points(lmax), dtype=torch.float64, device=vec.device)
    y_p = real_sph_harm(lmax, pts)                                 # [P, K]
    y_rp = real_sph_harm(lmax, torch.einsum("eij,pj->epi", rot, pts))   # [E, P, K]
    out = []
    for l in range(lmax + 1):
        sl = slice(l * l, (l + 1) ** 2)
        dt = torch.linalg.pinv(y_p[:, sl]) @ y_rp[:, :, sl]        # D^T [E, d, d]
        out.append(dt.transpose(1, 2).float().contiguous())
    return out


class Layout:
    """Index tables of the reduced (|m| <= mmax) l-primary layout and its
    m-primary order (m = 0 for every l; then +m and -m for l = m..lmax)."""

    def __init__(self, lmax: int, mmax: int):
        self.lmax, self.mmax = lmax, mmax
        lm = [(l, m) for l in range(lmax + 1) for m in range(-min(l, mmax), min(l, mmax) + 1)]
        self.lm = lm
        self.K = len(lm)
        pos = {p: i for i, p in enumerate(lm)}
        order = [pos[(l, 0)] for l in range(lmax + 1)]
        for m in range(1, mmax + 1):
            order += [pos[(l, m)] for l in range(m, lmax + 1)]
            order += [pos[(l, -m)] for l in range(m, lmax + 1)]
        self.to_m = order
        self.from_m = list(np.argsort(order))
        self.m0_rows = [pos[(l, 0)] for l in range(lmax + 1)]
        self.full_index = [l * l + l + m for l, m in lm]

    def kept_rows(self, l: int) -> list[int]:
        """Rows of the degree-l block with |m| <= mmax."""
        mm = min(l, self.mmax)
        return list(range(l - mm, l + mm + 1))


@functools.lru_cache(maxsize=None)
def grid_tables(lmax: int, mmax: int, resolution):
    """(to_grid [P, K_red], from_grid [P, K_red]) float64 numpy tables of the
    S2 point-sample activation: Gauss-Legendre latitudes in cos(beta),
    uniform longitudes, f(x) = sum_i c_i Y_i(x) sqrt(4 pi) / (lmax + 1), the
    exact quadrature inverse, and sqrt((2l+1)/(2 mmax+1)) on l > mmax."""
    if resolution is not None:
        nb = na = int(resolution)
    else:
        nb, na = 2 * (lmax + 1), 2 * mmax + 1 + (2 if lmax == mmax else 0)
    zs, zw = np.polynomial.legendre.leggauss(nb)
    al = 2 * math.pi * np.arange(na) / na
    zz, aa = np.repeat(zs, na), np.tile(al, nb)
    ss = np.sqrt(np.maximum(0.0, 1 - zz * zz))
    pts = np.stack([ss * np.cos(aa), ss * np.sin(aa), zz], -1)
    y = real_sph_harm(lmax, torch.as_tensor(pts, dtype=torch.float64)).numpy()
    s = math.sqrt(4 * math.pi) / (lmax + 1)
    w = np.repeat(zw, na)[:, None] * (2 * math.pi / na)
    to_g, from_g = y * s, y * w / s
    for l in range(mmax + 1, lmax + 1):
        f = math.sqrt((2 * l + 1) / (2 * mmax + 1))
        to_g[:, l * l:(l + 1) ** 2] *= f
        from_g[:, l * l:(l + 1) ** 2] *= f
    keep = Layout(lmax, mmax).full_index
    return to_g[:, keep], from_g[:, keep]
