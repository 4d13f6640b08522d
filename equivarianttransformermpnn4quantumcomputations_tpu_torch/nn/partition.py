"""Tensor- and expert-parallel roles, declared where each parameter is made.

Port of the JAX package's nn/partition.py.  There each TP-relevant module
boxes its parameters with logical axis names (``"tp"``, ``"ep"``) and
parallel/sharding.py reads them back from an abstract init.  Here each
module declares, in its constructor, a role per parameter:
``declare(module, leaf, dim, widths)`` records that ``leaf`` is split
along its torch dimension ``dim``.  The roles follow the JAX ones:

* ``tp="col"`` shards the output features (a ``Linear``'s weight rows and
  its bias; the last dim of an ``SO3Linear`` / ``SO2Conv`` weight [in, out]
  and the bias); ``tp="row"`` shards the input features and leaves the bias
  whole; ``tp=None`` replicates;
* ``"ep"``: the stacked expert axis (dim 0) of ``StackedLinear``.

``widths`` lists the chunks that the dimension concatenates (the gates of
GATA's ``W_rs`` are 1 + 2 lmax chunks of C channels; an SO(2) weight's output
is one chunk of C_out per degree).  A rank holds its 1/M of every chunk,
so that the next op stays local; inside the dimension this is a
permutation of the JAX package's contiguous shard, and
``parallel/sharding.py:gather_state`` undoes it.  A chunk that M does not
divide leaves the module unpartitioned.

``param_roles(model, model_size)`` is the counterpart of the JAX package's
``param_partition_spec``: for each ``state_dict`` name, the sharded torch
dimension or None, with its fallback (a leaf whose dimension M does not
divide is replicated whole).  At ``model_size=1`` nothing is sharded and no
module changes what it computes.
"""

from __future__ import annotations

import numpy as np
import torch.nn as nn

__all__ = ["PARTITION_AXES", "declare", "declare_tp", "roles_of", "param_roles",
           "chunked_index", "partitionable"]

# logical axis names understood by parallel/sharding.py
PARTITION_AXES = ("tp", "ep")


def declare(module: nn.Module, leaf: str, dim: int, widths=None, axis: str = "tp") -> None:
    """Record that ``module.<leaf>`` is split along ``dim`` (chunks ``widths``,
    default one chunk: the whole dimension)."""
    if axis not in PARTITION_AXES:
        raise ValueError(f"unknown partition axis {axis!r}")
    roles = module.__dict__.setdefault("_tp_roles", {})
    roles[leaf] = (dim, None if widths is None else tuple(int(w) for w in widths))


def declare_tp(module: nn.Module, tp: str | None, weight_dims: dict[str, tuple[int, int]],
               bias: str | None = None, out_widths=None, in_widths=None) -> None:
    """A Megatron role for ``module``: ``weight_dims`` maps each weight leaf
    to its (input dim, output dim); ``"col"`` splits the output dim and the
    ``bias`` leaf, ``"row"`` the input dim (the bias stays whole)."""
    if tp not in (None, "col", "row"):
        raise ValueError(f"unknown tp role: {tp!r}")
    module.tp = tp
    if tp is None:
        return
    for leaf, (din, dout) in weight_dims.items():
        if tp == "col":
            declare(module, leaf, dout, out_widths)
        else:
            declare(module, leaf, din, in_widths)
    if tp == "col" and bias is not None:
        declare(module, bias, 0, out_widths)


def roles_of(module: nn.Module) -> dict[str, tuple[int, tuple | None]]:
    """The roles ``module`` declared for its own leaves: leaf -> (dim, widths)."""
    return module.__dict__.get("_tp_roles", {})


def chunked_index(size_of_dim: int, widths, rank: int, size: int) -> np.ndarray:
    """Indices along a dimension that ``rank`` of ``size`` holds: its 1/size of
    each chunk of ``widths`` (None: one chunk, a contiguous block)."""
    widths = (size_of_dim,) if widths is None else tuple(widths)
    if sum(widths) != size_of_dim:
        raise ValueError(f"chunks {widths} do not add up to {size_of_dim}")
    out, offset = [], 0
    for w in widths:
        part = w // size
        out.append(np.arange(offset + rank * part, offset + (rank + 1) * part))
        offset += w
    return np.concatenate(out).astype(np.int64)


def partitionable(module: nn.Module, size: int) -> bool:
    """Every declared leaf of ``module`` splits evenly into ``size`` parts,
    chunk by chunk."""
    for leaf, (dim, widths) in roles_of(module).items():
        n = getattr(module, leaf).shape[dim]
        if any(w % size for w in ((n,) if widths is None else widths)):
            return False
    return bool(roles_of(module))


def param_roles(model: nn.Module, model_size: int) -> dict[str, int | None]:
    """``state_dict`` parameter name -> the dimension sharded over the
    ``model`` axis at ``model_size``, or None (replicated).  A leaf whose
    dimension ``model_size`` does not divide is replicated whole, as the JAX
    package's ``param_partition_spec`` does.  Call it on the whole model."""
    out: dict[str, int | None] = {}
    for mname, mod in model.named_modules():
        roles = roles_of(mod)
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            role = roles.get(leaf)
            dim = None
            if role is not None and model_size > 1 and p.shape[role[0]] % model_size == 0:
                dim = role[0]
            out[name] = dim
    return out
