"""Plain reference of the benchmarked training steps: the losses, the
gradients (worked out a few graphs at a time and summed, so that the float32
reference fits beside nothing else on the card), the global-norm clip, AdamW,
the learning-rate schedule and the EMA.

The loss, as the configuration's ``train`` states it: ``w_energy`` x the
energy's L1 or MSE (``energy_loss``; a mean over graphs) + ``w_force`` x L1
of the forces (a mean over the real atoms' components) + ``w_stress`` x L1 of
the per-graph stress (a mean over graphs and the six components; only where
``w_stress`` > 0).  Forces by autograd keep their graph, so the loss gradient
is a second derivative; a force head's are its output.  The optimizer: clip the gradient to global
norm ``grad_clip``; AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight
decay on >= 2-D parameters named ``weight`` outside embeddings and norms);
learning rate ``lr * (0.01 + 0.99 t / warmup)`` while t < warmup, then a
cosine to 0 at ``total_steps``, t the number of updates so far; EMA of the
parameters after each step.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import Model
from .neighbors import neighbor_list

__all__ = ["reference_batch", "Trainer"]


def reference_batch(structures: list[dict], cutoff: float, max_neighbors: int,
                    device) -> dict:
    """The ragged batch of ``structures`` (dicts with z, pos, cell and the
    labels energy, forces and, where given, stress [6]; else a stress of 0,
    as the program's datasets give), with the reference's own neighbour
    lists."""
    z, pos, gi, src, dst, sh, fl = [], [], [], [], [], [], []
    off = 0
    for b, s in enumerate(structures):
        a, d, c = neighbor_list(s["pos"], s["cell"], cutoff, max_neighbors)
        src.append(a + off)
        dst.append(d + off)
        sh.append(c)
        z.append(s["z"])
        pos.append(s["pos"])
        gi.append(np.full(len(s["pos"]), b))
        fl.append(s["forces"])
        off += len(s["pos"])

    def t(x, dt):
        return torch.as_tensor(np.concatenate(x), device=device).to(dt)

    return dict(z=t(z, torch.long), pos=t(pos, torch.float32), graph=t(gi, torch.long),
                cell=torch.as_tensor(np.stack([s["cell"] for s in structures]),
                                     device=device).float(),
                src=t(src, torch.long), dst=t(dst, torch.long), shift=t(sh, torch.float32),
                natoms=torch.as_tensor([len(s["pos"]) for s in structures], device=device),
                energy=torch.as_tensor([s["energy"] for s in structures], device=device,
                                       dtype=torch.float32),
                forces=t(fl, torch.float32),
                stress=torch.as_tensor(np.stack([s.get("stress", np.zeros(6, np.float32))
                                                 for s in structures]), device=device,
                                       dtype=torch.float32))


def _decays(name: str, p: torch.Tensor) -> bool:
    low = name.lower()
    return (p.dim() >= 2 and "embed" not in low and "norm" not in low
            and name.rsplit(".", 1)[-1] == "weight")


class Trainer:
    """Steps of the reference from the weights ``W0`` (host or device float32
    tensors, by name).  ``opt``: the configuration's ``train``: lr,
    warmup_steps, total_steps, weight_decay, grad_clip, ema_decay,
    energy_loss and the loss weights w_energy, w_force, w_stress.
    ``graphs_per_block``: graphs whose gradient is worked out at once."""

    def __init__(self, model: Model, W0: dict, opt: dict, cutoff: float,
                 max_neighbors: int, device, graphs_per_block: int = 8):
        self.m, self.opt = model, opt
        self.cutoff, self.max_neighbors = cutoff, max_neighbors
        self.device = device
        self.block = graphs_per_block
        self.W = {k: v.detach().to(device, torch.float32).clone().requires_grad_(True)
                  for k, v in W0.items()}
        self.ema = {k: v.detach().clone() for k, v in self.W.items()}
        self.exp_avg = {k: torch.zeros_like(v) for k, v in self.W.items()}
        self.exp_avg_sq = {k: torch.zeros_like(v) for k, v in self.W.items()}
        self.count = 0
        self.losses: list[float] = []
        self.first_grad: dict | None = None

    def lr(self, t: int) -> float:
        o = self.opt
        if t < o["warmup_steps"]:
            return o["lr"] * (0.01 + 0.99 * t / max(o["warmup_steps"], 1))
        prog = min(max((t - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1),
                       0.0), 1.0)
        return o["lr"] * 0.5 * (1.0 + math.cos(math.pi * prog))

    def _block_loss(self, b: dict, n_graphs: int, n_atoms: int) -> torch.Tensor:
        """This block's share of the batch loss (the batch's denominators)."""
        o = self.opt
        w_stress = float(o.get("w_stress", 0.0))
        out = self.m.energy_forces(self.W, b, create_graph=True, stress=w_stress > 0.0)
        de = out["energy"] - b["energy"]
        if o["energy_loss"] == "l1":
            e = de.abs().sum() / n_graphs
        elif o["energy_loss"] == "mse":
            e = (de * de).sum() / n_graphs
        else:
            raise NotImplementedError(f"energy_loss {o['energy_loss']!r}: l1 or mse")
        f = (out["forces"] - b["forces"]).abs().sum() / (3.0 * n_atoms)
        loss = o["w_energy"] * e + o["w_force"] * f
        if w_stress > 0.0:
            loss = loss + w_stress * (out["stress"] - b["stress"]).abs().sum() / (6.0 * n_graphs)
        return loss

    def gradient(self, structures: list[dict]) -> tuple[float, dict]:
        """The loss of a batch and its gradient by name (zeros where unused)."""
        n_graphs = len(structures)
        n_atoms = sum(len(s["pos"]) for s in structures)
        names = list(self.W)
        grads = {k: torch.zeros_like(v) for k, v in self.W.items()}
        loss = 0.0
        for i in range(0, n_graphs, self.block):
            b = reference_batch(structures[i:i + self.block], self.cutoff, self.max_neighbors,
                                self.device)
            with torch.enable_grad():
                li = self._block_loss(b, n_graphs, n_atoms)
                gs = torch.autograd.grad(li, [self.W[k] for k in names], allow_unused=True)
            for k, g in zip(names, gs):
                if g is not None:
                    grads[k] += g
            loss += float(li.detach())
            del b, li, gs
        return loss, grads

    @torch.no_grad()
    def step(self, structures: list[dict]) -> float:
        """One training step; returns its loss."""
        loss, grads = self.gradient(structures)
        o = self.opt
        gnorm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
        scale = torch.clamp(o["grad_clip"] / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
        if self.first_grad is None:
            self.first_grad = {k: g.clone() for k, g in grads.items()}
        lr, t = self.lr(self.count), self.count + 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for k, p in self.W.items():
            g = grads[k]
            if _decays(k, p):
                p.mul_(1.0 - lr * o["weight_decay"])
            m = self.exp_avg[k].mul_(b1).add_(g, alpha=1 - b1)
            v = self.exp_avg_sq[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))
            self.ema[k].mul_(o["ema_decay"]).add_(p, alpha=1 - o["ema_decay"])
        self.count += 1
        self.losses.append(loss)
        return loss
