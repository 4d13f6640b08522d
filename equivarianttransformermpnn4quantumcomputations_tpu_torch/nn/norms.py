"""Equivariant normalization over [N, (lmax+1)^2, C] features.

Port of the JAX package's nn/norms.py: 'layer_norm', 'layer_norm_sh' and
'rms_norm_sh' (the flagship's), ``get_normalization_layer`` and the
per-degree layer scale.  The norms always compute in float32, as the
reference forces with ``autocast(enabled=False)`` (layer_norm.py:63,155,230,
313), and return the input's type.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .layers import LayerNorm

__all__ = ["EquivariantLayerNorm", "EquivariantLayerNormSH", "EquivariantRMSNormSH",
           "EquivariantDegreeLayerScale", "get_normalization_layer", "NORM_TYPES"]

NORM_TYPES = ("layer_norm", "layer_norm_sh", "rms_norm_sh")


def _expand_index(lmax: int) -> np.ndarray:
    return np.concatenate([np.full(2 * l + 1, l) for l in range(lmax + 1)])


def _balance_weight(lmax: int, skip_l0: bool) -> np.ndarray:
    """Per-coefficient weight averaging component power uniformly per degree."""
    lmin = 1 if skip_l0 else 0
    w = np.concatenate([np.full(2 * l + 1, 1.0 / (2 * l + 1)) for l in range(lmin, lmax + 1)])
    return w / (lmax + 1 - lmin)


class _DegreeNorm(nn.Module):
    """Shared buffers: the degree of each coefficient and the balance weights."""

    def __init__(self, lmax: int, skip_l0: bool):
        super().__init__()
        self.lmax = lmax
        self.register_buffer("expand", torch.as_tensor(_expand_index(lmax)), persistent=False)
        self.register_buffer("balance", torch.as_tensor(_balance_weight(lmax, skip_l0),
                                                        dtype=torch.float32),
                             persistent=False)


class EquivariantLayerNorm(_DegreeNorm):
    """'layer_norm': per-degree layer norm (reference layer_norm.py:38-108)."""

    def __init__(self, lmax: int, num_channels: int, eps: float = 1e-5):
        super().__init__(lmax, False)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(lmax + 1, num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.float()
        out = []
        for l in range(self.lmax + 1):
            f = x[:, l * l : (l + 1) ** 2, :]
            if l == 0:
                f = f - f.mean(dim=2, keepdim=True)
            var = (f * f).mean(dim=(1, 2), keepdim=True)
            f = f * (var + self.eps) ** -0.5 * self.weight[l]
            out.append(f + self.bias if l == 0 else f)
        return torch.cat(out, dim=1).to(dtype)


class EquivariantLayerNormSH(_DegreeNorm):
    """'layer_norm_sh': layer norm on l = 0; one degree-balanced scale over
    l > 0 (reference layer_norm.py:112-201)."""

    def __init__(self, lmax: int, num_channels: int, eps: float = 1e-5):
        super().__init__(lmax, True)
        self.eps = eps
        self.l0_norm = LayerNorm(num_channels, eps=eps)
        self.weight = nn.Parameter(torch.ones(lmax, num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.float()
        l0 = self.l0_norm(x[:, :1, :])
        if self.lmax == 0:
            return l0.to(dtype)
        rest = x[:, 1:, :]
        norm = torch.einsum("nic,i->nc", rest * rest, self.balance).mean(dim=1)
        scale = (norm[:, None, None] + self.eps) ** -0.5 * self.weight[self.expand[1:] - 1]
        return torch.cat([l0, rest * scale], dim=1).to(dtype)


class EquivariantRMSNormSH(_DegreeNorm):
    """'rms_norm_sh': joint RMS over all degrees, centering on l=0,
    degree-balanced std, per-degree affine (reference layer_norm.py:265-351)."""

    def __init__(self, lmax: int, num_channels: int, eps: float = 1e-5):
        super().__init__(lmax, False)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(lmax + 1, num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.float()
        l0 = x[:, :1, :]
        x = torch.cat([l0 - l0.mean(dim=2, keepdim=True), x[:, 1:, :]], dim=1)
        norm = torch.einsum("nic,i->nc", x * x, self.balance)
        norm = norm.mean(dim=1)[:, None, None]
        scale = (norm + self.eps) ** -0.5 * self.weight[self.expand][None]
        out = x * scale
        out = torch.cat([out[:, :1, :] + self.bias, out[:, 1:, :]], dim=1)
        return out.to(dtype)


def get_normalization_layer(norm_type: str, lmax: int, num_channels: int) -> nn.Module:
    if norm_type == "layer_norm":
        return EquivariantLayerNorm(lmax, num_channels)
    if norm_type == "layer_norm_sh":
        return EquivariantLayerNormSH(lmax, num_channels)
    if norm_type == "rms_norm_sh":
        return EquivariantRMSNormSH(lmax, num_channels)
    raise ValueError(norm_type)


def degree_scale_init(lmax: int, num_channels: int, scale_factor: float) -> torch.Tensor:
    """1 for l = 0, 1/sqrt(scale_factor l) for l > 0."""
    w = torch.ones(lmax + 1, num_channels)
    for l in range(1, lmax + 1):
        w[l] /= float(np.sqrt(scale_factor * l))
    return w


class EquivariantDegreeLayerScale(nn.Module):
    """CaiT-style per-degree layer scale (reference layer_norm.py:354-380;
    unused by the reference's models, kept for parity)."""

    def __init__(self, lmax: int, num_channels: int, scale_factor: float = 2.0):
        super().__init__()
        self.lmax, self.scale_factor = lmax, scale_factor
        self.weight = nn.Parameter(degree_scale_init(lmax, num_channels, scale_factor))
        self.register_buffer("expand", torch.as_tensor(_expand_index(lmax)), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight[self.expand][None]
