"""Per-edge rotations: frame, Euler angles, Wigner-D, rotate dispatch.

Port of the JAX package's ops/rotation.py:

* each edge is aligned with the **z axis** by a deterministic cardinal-axis
  frame;
* Wigner-D is ``Xz(a) @ J @ Xz(b) @ J @ Xz(g)`` with the J matrices of
  ops/wigner_np.py.  Two representations reach the rotates:
  - dense (``WignerDense``, ops/cuda/rotate_dense.py): the per-degree
    blocks (``WignerBlocks``) multiplied out and packed into the pairs form
    of kernel K1;
  - factored (``WignerFactors``): only the per-edge cos / sin tables of the
    three z-rotations; each rotate applies the five factors in one pass of
    kernel K4 (ops/cuda/rotate.py);
* all geometry is detached, as the reference detaches frames and Wigner
  matrices: gradients flow through distances, never through the frame.

``rotate_*`` dispatch on the Wigner type.  Geometry runs in float32 with TF32
off (the serving and training entry points turn it off for each forward,
``utils/precision.py``), since reduced-precision products cost ~1e-3 in
every Wigner matrix.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .irreps import IrrepsLayout
from .wigner_np import J_matrices

__all__ = [
    "edge_frame",
    "frame_to_zyz_angles",
    "WignerBlocks",
    "WignerFactors",
    "compute_wigner",
    "compute_wigner_blocks",
    "rotate_to_edge",
    "rotate_to_edge_m0",
    "rotate_from_edge",
]


def edge_frame(edge_vec: torch.Tensor) -> torch.Tensor:
    """Deterministic orthonormal frame per edge: rows (a, b, v_hat).

    ``R @ v_hat = z_hat``; the in-plane axes come from the cardinal axis least
    aligned with the edge.  edge_vec [E, 3] -> [E, 3, 3] (detached).
    """
    v = edge_vec.detach()
    dist = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    vhat = v / torch.clamp(dist, min=1e-8)
    best = torch.argmin(torch.abs(vhat), dim=-1)
    ref = torch.eye(3, dtype=vhat.dtype, device=vhat.device)[best]
    b = torch.linalg.cross(vhat, ref)
    b = b / torch.clamp(torch.sqrt(torch.sum(b * b, dim=-1, keepdim=True)), min=1e-8)
    a = torch.linalg.cross(b, vhat)
    return torch.stack([a, b, vhat], dim=-2)


def frame_to_zyz_angles(rot: torch.Tensor):
    """ZYZ Euler angles (alpha, beta, gamma) of ``R = Rz(a) Ry(b) Rz(g)``.

    Robust at the poles: (phi, theta) come from the third row of R, gamma
    from the exact residual z-rotation.  Each output is [E].
    """
    rot = rot.detach()
    v = rot[..., 2, :]
    theta = torch.atan2(torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2), v[..., 2])
    phi = torch.atan2(v[..., 1], v[..., 0])
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    zeros, ones = torch.zeros_like(ct), torch.ones_like(ct)
    ry = torch.stack(
        [
            torch.stack([ct, zeros, -st], -1),
            torch.stack([zeros, ones, zeros], -1),
            torch.stack([st, zeros, ct], -1),
        ],
        -2,
    )
    rz = torch.stack(
        [
            torch.stack([cp, sp, zeros], -1),
            torch.stack([-sp, cp, zeros], -1),
            torch.stack([zeros, zeros, ones], -1),
        ],
        -2,
    )
    # residual Rz(g0) = Ry(-theta) Rz(-phi) R^T
    m = ry @ rz @ rot.transpose(-1, -2)
    g0 = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    # R^T = Rz(phi) Ry(theta) Rz(g0)  =>  R = Rz(-g0) Ry(-theta) Rz(-phi)
    return -g0, -theta, -phi


def _z_rot(l: int, angle: torch.Tensor) -> torch.Tensor:
    """Real-basis Wigner-D of Rz(angle) for degree l: [..., 2l+1, 2l+1]."""
    m = torch.arange(-l, l + 1, dtype=angle.dtype, device=angle.device)
    c = torch.cos(m * angle[..., None])
    s = torch.sin(m * angle[..., None])
    eye = torch.eye(2 * l + 1, dtype=angle.dtype, device=angle.device)
    anti = torch.flip(eye, dims=(0,))  # 1 at [i, 2l - i]
    return c[..., :, None] * eye + (-s)[..., :, None] * anti


class WignerBlocks:
    """Per-degree Wigner-D blocks for a batch of edges (detached), one
    tensor attribute ``d<l>`` [E, 2l+1, 2l+1] per degree (so that
    parallel/pipeline.py ships them as it ships any Wigner's tensors)."""

    def __init__(self, blocks):
        blocks = list(blocks)
        self.num_degrees = len(blocks)
        for l, d in enumerate(blocks):
            setattr(self, f"d{l}", d)

    @property
    def blocks(self) -> list:
        return [getattr(self, f"d{l}") for l in range(self.num_degrees)]

    @property
    def lmax(self) -> int:
        return self.num_degrees - 1


def compute_wigner_blocks(lmax: int, edge_vec: torch.Tensor) -> WignerBlocks:
    """Wigner-D blocks of the edge-alignment rotation of each edge (float32)."""
    rot = edge_frame(edge_vec.to(torch.float32))
    alpha, beta, gamma = frame_to_zyz_angles(rot)
    blocks = [torch.ones(alpha.shape + (1, 1), dtype=torch.float32,
                         device=alpha.device)]
    for l, Jl in enumerate(J_matrices(lmax)):
        if l == 0:
            continue
        J = torch.as_tensor(Jl, dtype=torch.float32, device=alpha.device)
        xa, xb, xc = _z_rot(l, alpha), _z_rot(l, beta), _z_rot(l, gamma)
        blocks.append(xa @ (J @ (xb @ (J @ xc))))
    return WignerBlocks(blocks)


def _m_keep_rows(l: int, mmax: int) -> np.ndarray:
    """Row indices within a degree-l block for |m| <= mmax."""
    mm = min(l, mmax)
    return np.arange(l - mm, l + mm + 1)


# ── the factored representation ────────────────────────────────────────────


@functools.lru_cache(maxsize=None)
def _flip_index(lmax: int) -> np.ndarray:
    """Index of the (l, -m) coefficient for each (l, m), l-primary layout."""
    idx = np.zeros((lmax + 1) ** 2, dtype=np.int32)
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            idx[l * l + l + m] = l * l + l - m
    return idx


@functools.lru_cache(maxsize=None)
def _flip_index_reduced(lmax: int, mmax: int) -> np.ndarray:
    """Position of (l, -m) within the reduced (|m| <= mmax) layout."""
    from .irreps import layout as get_layout

    lay = get_layout(lmax, mmax)
    pos_of = {(int(l), int(m)): i for i, (l, m) in enumerate(zip(lay.l_harmonic,
                                                                 lay.m_complex))}
    return np.asarray([pos_of[(int(l), -int(m))]
                       for l, m in zip(lay.l_harmonic, lay.m_complex)], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _abs_m_index(lmax: int) -> np.ndarray:
    return np.concatenate([np.abs(np.arange(-l, l + 1))
                           for l in range(lmax + 1)]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _sign_m(lmax: int) -> np.ndarray:
    return np.concatenate([np.sign(np.arange(-l, l + 1))
                           for l in range(lmax + 1)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _J_dense(lmax: int) -> np.ndarray:
    """Block-diagonal J over the full (lmax+1)^2 coefficient axis."""
    K = (lmax + 1) ** 2
    J = np.zeros((K, K), dtype=np.float32)
    for l, Jl in enumerate(J_matrices(lmax)):
        J[l * l : l * l + 2 * l + 1, l * l : l * l + 2 * l + 1] = Jl
    return J


class WignerFactors:
    """Per-edge cos / sin(m t) tables of the three z-rotations, [E, lmax+1]
    each (per |m|, float32, detached).  The per-coefficient tables of kernel
    K4 are built from them once per forward and kept here
    (``tables``), so every rotate of a forward shares them."""

    def __init__(self, lmax, ca, sa, cb, sb, cg, sg):
        self.lmax = int(lmax)
        self.ca, self.sa = ca, sa
        self.cb, self.sb = cb, sb
        self.cg, self.sg = cg, sg
        self._tables = {}

    def tables(self, key, build):
        """The tables named ``key``, built by ``build(self)`` on first use."""
        if key not in self._tables:
            self._tables[key] = build(self)
        return self._tables[key]


def compute_wigner(lmax: int, edge_vec: torch.Tensor) -> WignerFactors:
    """Factored per-edge Wigner rotation (float32, detached geometry)."""
    rot = edge_frame(edge_vec.to(torch.float32))
    alpha, beta, gamma = frame_to_zyz_angles(rot)
    m = torch.arange(0, lmax + 1, dtype=torch.float32, device=alpha.device)

    def cs(angle):
        t = m * angle[:, None]
        return torch.cos(t), torch.sin(t)

    return WignerFactors(lmax, *cs(alpha), *cs(beta), *cs(gamma))


# ── the per-degree blocks representation ───────────────────────────────────
# (JAX ops/rotation.py:437-529): batched [E, d, d] x [E, d, C] products per
# degree, in float32, the result in the features' type


def _blocks_to_edge(w: WignerBlocks, x: torch.Tensor, layout: IrrepsLayout) -> torch.Tensor:
    out = []
    for l in range(layout.lmax + 1):
        wl = w.blocks[l]
        if layout.mmax < l:
            wl = wl[:, torch.as_tensor(_m_keep_rows(l, layout.mmax), device=wl.device), :]
        out.append(torch.matmul(wl, x[:, l * l : l * l + 2 * l + 1, :].float()))
    return torch.cat(out, dim=1).to(x.dtype)


def _blocks_from_edge(w: WignerBlocks, x: torch.Tensor, layout: IrrepsLayout) -> torch.Tensor:
    out, offset = [], 0
    for l in range(layout.lmax + 1):
        width = 2 * min(l, layout.mmax) + 1
        xl = x[:, offset : offset + width, :].float()
        offset += width
        winv = w.blocks[l].transpose(-1, -2)
        if layout.mmax < l:
            keep = torch.as_tensor(_m_keep_rows(l, layout.mmax), device=winv.device)
            winv = winv[:, :, keep] * float(layout.rescale[l * l])
        out.append(torch.matmul(winv, xl))
    return torch.cat(out, dim=1).to(x.dtype)


# ── dispatch ───────────────────────────────────────────────────────────────


def _check(wigner, layout: IrrepsLayout) -> None:
    if isinstance(wigner, (WignerFactors, WignerBlocks)):
        assert layout.lmax == wigner.lmax
    else:
        assert (layout.lmax, layout.mmax) == (wigner.lmax, wigner.mmax)


def rotate_to_edge(wigner, x: torch.Tensor, layout: IrrepsLayout) -> torch.Tensor:
    """Rotate [E, (lmax+1)**2, C] global-frame features into each edge frame,
    truncated to |m| <= mmax: -> [E, K_red, C] (l-primary reduced layout).
    ``WignerFactors`` go to kernel K4, ``WignerDense`` to kernel K1,
    ``WignerBlocks`` to batched matmuls."""
    _check(wigner, layout)
    if isinstance(wigner, WignerBlocks):
        return _blocks_to_edge(wigner, x, layout)
    if isinstance(wigner, WignerFactors):
        from .cuda.rotate import rotate_to_edge_fused

        return rotate_to_edge_fused(wigner, x, layout)
    from .cuda.rotate_dense import rotate_to_edge_dense

    return rotate_to_edge_dense(wigner, x)


def rotate_to_edge_m0(wigner, x: torch.Tensor, layout: IrrepsLayout) -> torch.Tensor:
    """rotate_to_edge returning only the m = 0 rows: [E, lmax+1, C]."""
    _check(wigner, layout)
    if isinstance(wigner, WignerBlocks):
        m0_rows = np.nonzero(np.asarray(layout.m_complex) == 0)[0]
        return _blocks_to_edge(wigner, x, layout)[:, torch.as_tensor(m0_rows), :]
    if isinstance(wigner, WignerFactors):
        from .cuda.rotate import rotate_to_edge_m0_fused

        return rotate_to_edge_m0_fused(wigner, x, layout)
    from .cuda.rotate_dense import rotate_to_edge_m0_dense

    return rotate_to_edge_m0_dense(wigner, x)


def rotate_from_edge(wigner, x: torch.Tensor, layout: IrrepsLayout) -> torch.Tensor:
    """Inverse rotation [E, K_red, C] -> [E, (lmax+1)**2, C], zero-filling the
    truncated orders and applying the sqrt((2l+1)/(2 mmax+1)) rescale."""
    _check(wigner, layout)
    if isinstance(wigner, WignerBlocks):
        return _blocks_from_edge(wigner, x, layout)
    if isinstance(wigner, WignerFactors):
        from .cuda.rotate import rotate_from_edge_fused

        return rotate_from_edge_fused(wigner, x, layout)
    from .cuda.rotate_dense import rotate_from_edge_dense

    return rotate_from_edge_dense(wigner, x)
