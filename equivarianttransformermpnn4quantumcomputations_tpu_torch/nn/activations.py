"""Equivariant activations: gate, S2 point-sample and separable S2.

Port of the JAX package's nn/activations.py.  The gate activation is plain
tensor ops (sigmoid gates per degree).  The S2 activation is
to-grid -> SiLU -> from-grid.  On a CUDA tensor it always runs the fused
wrapper (ops/cuda/s2act.py), which launches kernel K2 at any channel count
(the JAX package's 128-channel rule is a TPU tiling limit); on a CPU tensor
it runs the unfused tensor ops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.s2act import s2act_fused, s2act_reference
from ..ops.s2grid import S2Grid

__all__ = ["gate_activation", "s2_activation", "separable_s2_activation"]


def _gate_expand_index(lmax: int, mmax: int) -> np.ndarray:
    """Map each l>0 coefficient of the (lmax, mmax) reduced layout to l-1."""
    return np.concatenate([np.full(min(2 * l + 1, 2 * mmax + 1), l - 1)
                           for l in range(1, lmax + 1)])


def gate_activation(gating_scalars: torch.Tensor, x: torch.Tensor, lmax: int, mmax: int,
                    num_channels: int) -> torch.Tensor:
    """Sigmoid gates per degree on the l>0 components, SiLU on l=0
    (reference activation.py:107-150).

    gating_scalars: [N, lmax * C]; x: [N, K_red, C].
    """
    g = torch.sigmoid(gating_scalars).reshape(-1, lmax, num_channels)
    g = g[:, torch.as_tensor(_gate_expand_index(lmax, mmax), device=g.device), :]
    return torch.cat([F.silu(x[:, :1, :]), x[:, 1:, :] * g], dim=1)


def s2_activation(x: torch.Tensor, grid: S2Grid) -> torch.Tensor:
    """Point-sample S2 activation (reference activation.py:153-170).

    x: [N, K, C].
    """
    if x.is_cuda:
        return s2act_fused(x, grid)
    return s2act_reference(x, grid)


def separable_s2_activation(gating_scalars: torch.Tensor, x: torch.Tensor,
                            grid: S2Grid) -> torch.Tensor:
    """SiLU on the separate l=0 scalars; S2 activation on the full tensor,
    keeping its l>0 part (reference activation.py:173-192).

    gating_scalars: [N, C]; x: [N, K, C].
    """
    tensors = s2_activation(x, grid)
    return torch.cat([F.silu(gating_scalars)[:, None, :], tensors[:, 1:, :]], dim=1)
