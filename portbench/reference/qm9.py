"""Plain PyTorch reference of the QM9 EquiformerV2 (the thesis's
models/equiformerv2_qm9.py) and of its training step.

The backbone is ``reference/model.py``'s baseline EquiformerV2 (``gata``
off: the separable S2 activation on the edges, every SO(2) convolution as
plain per-m matmuls, the per-degree Wigner products); then ``num_targets``
feed-forward heads, one per target, whose weights lie stacked on a leading
target axis under the names of the model's ``state_dict``
(``output_blocks.*``).  Each head's l = 0, channel 0 output is summed over
each molecule's atoms, with no division by the atom count.  Molecules have
no periodic cell: every edge joins two atoms of one molecule within the
cutoff (the neighbour list of ``reference/neighbors.py`` in a cell so large
that no image comes within it), each atom keeping its ``max_neighbors``
closest.

The training step (``Trainer``): L1 over the molecules and the targets (a
first-order backward), then ``reference/train.py``'s clip, AdamW, schedule
and EMA.  float32 throughout, ``Numerics`` for the control.  Imports nothing
of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import model as base
from .neighbors import neighbor_list
from .train import Trainer as _Trainer

__all__ = ["Model", "Trainer", "OUTPUTS", "MOLECULE_CELL", "molecule_edges", "molecule_batch"]

# the configuration's ``outputs``: every target summed over a molecule's atoms
OUTPUTS = {"targets": "sum_over_atoms"}
# a cell whose images lie far beyond any cutoff: a molecule's neighbour list
MOLECULE_CELL = np.eye(3, dtype=np.float32) * 1.0e4
# the keys of the QM9 model beyond the backbone's
_HEAD_KEYS = {"num_targets"}
# switches of the reference's backbone that the QM9 model fixes: the baseline
_BASELINE = dict(gata=False, normalize_attn_output=True, use_phi_every_layer=False)


def molecule_edges(pos: np.ndarray, cutoff: float, max_neighbors: int):
    """(src, dst) of one molecule."""
    src, dst, _ = neighbor_list(pos, MOLECULE_CELL, cutoff, max_neighbors)
    return src, dst


class Model(base.Model):
    """The reference forward of the QM9 configuration (``cfg``: its model
    keys; ``outputs``: ``OUTPUTS``)."""

    def __init__(self, cfg: dict, outputs: dict, numerics: base.Numerics = base.F32):
        if dict(outputs) != OUTPUTS:
            raise NotImplementedError(f"outputs {outputs!r}: the QM9 reference computes "
                                      f"{OUTPUTS!r}")
        for k in _BASELINE:
            if k in cfg:
                raise NotImplementedError(f"the QM9 model takes no {k!r}")
        backbone = {k: v for k, v in cfg.items() if k not in _HEAD_KEYS}
        super().__init__({**backbone, **_BASELINE}, {"energy": "per_atom", "forces": "head"},
                         numerics)
        self.c = dict(cfg)
        self.outputs = dict(outputs)
        self.targets = int(cfg["num_targets"])

    def forward(self, W, batch: dict) -> torch.Tensor:
        """``batch``: z [N], pos [N, 3], graph [N], src / dst [E], natoms [B].
        The predictions [B, num_targets]."""
        z, pos, gi = batch["z"], batch["pos"], batch["graph"]
        src, dst = batch["src"], batch["dst"]
        E, B = src.shape[0], batch["natoms"].shape[0]
        cell_e = torch.eye(3, device=pos.device).expand(E, 3, 3)
        x, _ = self.backbone(W, z, pos, cell_e, src, dst, pos.new_zeros(E, 3))
        head = "output_blocks"
        out = []
        for t in range(self.targets):
            Wt = {k: v[t] for k, v in W.items() if k.startswith(head + ".")}
            node = self.ffn(x, Wt, head, 1)[:, 0, 0]
            out.append(base._segment_sum(node, gi, B))
        return torch.stack(out, 1)


def molecule_batch(molecules: list[dict], cutoff: float, max_neighbors: int, device) -> dict:
    """The ragged batch of ``molecules`` (dicts with z, pos and the targets y)
    with the reference's own neighbour lists."""
    z, pos, gi, src, dst = [], [], [], [], []
    off = 0
    for b, m in enumerate(molecules):
        s, d = molecule_edges(m["pos"], cutoff, max_neighbors)
        src.append(s + off)
        dst.append(d + off)
        z.append(m["z"])
        pos.append(m["pos"])
        gi.append(np.full(len(m["pos"]), b))
        off += len(m["pos"])

    def t(x, dt):
        return torch.as_tensor(np.concatenate(x), device=device).to(dt)

    return dict(z=t(z, torch.long), pos=t(pos, torch.float32), graph=t(gi, torch.long),
                src=t(src, torch.long), dst=t(dst, torch.long),
                natoms=torch.as_tensor([len(m["pos"]) for m in molecules], device=device),
                y=torch.as_tensor(np.stack([m["y"] for m in molecules]), device=device,
                                  dtype=torch.float32))


class Trainer(_Trainer):
    """``reference/train.py``'s steps with the QM9 loss: L1 of the
    predictions against ``y``, a mean over the molecules and the targets
    (``opt["loss_kind"]``: ``l1``)."""

    def gradient(self, molecules: list[dict]) -> tuple[float, dict]:
        if self.opt.get("loss_kind", "l1") != "l1":
            raise NotImplementedError(f"loss_kind {self.opt['loss_kind']!r}: l1")
        n = len(molecules) * self.m.targets
        names = list(self.W)
        grads = {k: torch.zeros_like(v) for k, v in self.W.items()}
        loss = 0.0
        for i in range(0, len(molecules), self.block):
            b = molecule_batch(molecules[i:i + self.block], self.cutoff, self.max_neighbors,
                               self.device)
            with torch.enable_grad():
                li = (self.m.forward(self.W, b) - b["y"]).abs().sum() / n
                gs = torch.autograd.grad(li, [self.W[k] for k in names], allow_unused=True)
            for k, g in zip(names, gs):
                if g is not None:
                    grads[k] += g
            loss += float(li.detach())
            del b, li, gs
        return loss, grads
