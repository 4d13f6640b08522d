"""Basic layers: dense and layer-norm with the JAX package's dtype rules,
radial MLP, distance smearing, scalar activations.

Port of the JAX package's nn/layers.py (the parts the MatPES GATA-V2
serving and training paths use).  Under mixed precision every float
parameter arrives as a bfloat16 copy (train/trainer.py:cast_params), while
some inputs stay float32 (the geometry-fed edge embedding, the energy head
after the f32 final norm).  ``Linear`` therefore computes in the promoted
type of input and weight, as Flax's ``Dense`` does, and ``LayerNorm``
always computes in float32 and returns the input's type, as the JAX
package's norms do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .partition import declare, declare_tp

__all__ = ["Linear", "StackedLinear", "LayerNorm", "RadialMLP", "GaussianSmearing",
           "smooth_leaky_relu", "scaled_silu", "keep_mask"]

_SCALED_SILU = 1.6791767923989418


def scaled_silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) * _SCALED_SILU


def smooth_leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    a = negative_slope
    return ((1 + a) / 2.0) * x + ((1 - a) / 2.0) * x * (2.0 * torch.sigmoid(x) - 1.0)


def keep_mask(shape, keep: float, generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """Bernoulli(keep) booleans of ``shape`` on ``device``, drawn from
    ``generator`` (on its own device; the default generator when None)."""
    gdev = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, device=gdev)
    return (u < keep).to(device)


class Linear(nn.Linear):
    """``nn.Linear`` computing in the promoted type of input and weight.

    ``tp``: the tensor-parallel role (the JAX package's ``tp_dense``,
    nn/partition.py): ``"col"`` splits the output features, ``"row"`` the
    input features; ``out_chunks`` / ``in_chunks`` list the chunks that the
    split features concatenate.  Once ``parallel/sharding.py:shard_state``
    hands it a ``ModelGroup`` (``mp``), a column layer takes its replicated
    input through ``copy_to`` and returns its share of the outputs; a row
    layer takes its share of the inputs and returns the whole output
    (``reduce_from``, then the bias).  ``copied=True`` tells a column layer
    that its input already went through ``copy_to`` (one collective for
    the uses of a node tensor before it is gathered to the edges).
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 tp: str | None = None, out_chunks=None, in_chunks=None):
        super().__init__(in_features, out_features, bias=bias)
        declare_tp(self, tp, {"weight": (1, 0)}, "bias" if bias else None, out_chunks,
                   in_chunks)
        self.mp = None

    def forward(self, x: torch.Tensor, copied: bool = False) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        if self.mp is None or self.tp is None:
            return F.linear(x.to(dt), self.weight.to(dt), b)
        if self.tp == "col":
            x = x.to(dt) if copied else self.mp.copy_to(x.to(dt))
            return F.linear(x, self.weight.to(dt), b)
        y = self.mp.reduce_from(F.linear(x.to(dt), self.weight.to(dt)))
        return y if b is None else y + b


class StackedLinear(nn.Module):
    """T dense maps with weights on a leading axis: weight [T, out, in],
    bias [T, out] (or none); the JAX package's ``nn.vmap`` of a ``Dense``
    over stacked params.  Computes in the promoted type of input and
    weight, as ``Linear`` does.  ``ep=True``: the stacked axis is the MoE's
    expert axis, split over the ``model`` axis (nn/partition.py)."""

    def __init__(self, num: int, in_features: int, out_features: int, bias: bool = True,
                 ep: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(num, out_features)) if bias else None
        for leaf in ("weight", "bias") if ep else ():
            if getattr(self, leaf) is not None:
                declare(self, leaf, 0, axis="ep")

    def forward(self, x: torch.Tensor, shared: bool = False) -> torch.Tensor:
        """x [T, ..., in] -> [T, ..., out]; with ``shared`` x [..., in] goes
        through each of the T maps -> [T, ..., out]."""
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        x, w = x.to(dt), self.weight.to(dt)
        y = torch.einsum("...i,toi->t...o" if shared else "t...i,toi->t...o", x, w)
        if self.bias is not None:
            y = y + self.bias.to(dt).reshape((w.shape[0],) + (1,) * (y.dim() - 2) + (-1,))
        return y


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with float32 statistics and affine, cast back to the
    input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class RadialMLP(nn.Module):
    """(Linear -> LayerNorm -> SiLU)* -> Linear.

    Reference: models/EquiformerV2Functions/radial_function.py:5-30.  The
    norms compute in float32.
    """

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        chs = list(channels)
        self.linears = nn.ModuleList(
            Linear(chs[i - 1], chs[i]) for i in range(1, len(chs))
        )
        self.norms = nn.ModuleList(
            LayerNorm(chs[i], eps=1e-5) for i in range(1, len(chs) - 1)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < len(self.norms):
                x = F.silu(self.norms[i](x))
        return x


class GaussianSmearing(nn.Module):
    """Gaussian RBF distance expansion (reference equiformerv2_oc20.py:43-60)."""

    def __init__(self, start=0.0, stop=5.0, num_gaussians=600, width=2.0):
        super().__init__()
        offset = np.linspace(start, stop, num_gaussians)
        self.coeff = -0.5 / float(width * (offset[1] - offset[0])) ** 2
        self.register_buffer(
            "offset", torch.as_tensor(offset, dtype=torch.float32), persistent=False
        )

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        d = dist[..., None] - self.offset
        return torch.exp(self.coeff * d * d)
