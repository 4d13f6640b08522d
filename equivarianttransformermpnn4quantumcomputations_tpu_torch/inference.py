"""Serving API: energies and forces for batches of structures.

Port of the JAX package's inference.py ``Predictor`` (energy + forces; the
JAX ``Predictor`` computes no stress either).  ``Predictor`` takes a model
and a torch ``state_dict`` (for example one converted from the JAX
package's Flax params by ``utils/convert.py``), or
``Predictor.from_checkpoint`` reads a checkpoint of the port's MatPES CLI.
The model runs on ``cuda`` unless the caller passes ``device="cpu"``.

Example:
    p = Predictor.from_checkpoint("runs/matpes_fixture_torch", "ckpt_best")
    out = p.predict_batch([dict(atomic_numbers=z, positions=r, cell=c)])
    out["energy"], out["forces"]
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from .data.graph import GraphSample, as_tensors, collate, radius_graph, radius_graph_pbc
from .models.matpes import energy_and_forces
from .utils.precision import full_f32_products

__all__ = ["Predictor", "pad_sizes"]


def _bucket(n: int, quantum: int = 16) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def pad_sizes(n_atoms: Sequence[int], in_degree: int,
              max_neighbors: int | None) -> tuple[int, int]:
    """(n_pad, e_pad) of one request in the fixed-degree layout.

    n_pad is the JAX package's bucket (inference.py:144: a multiple of 16
    above the atom count), raised to a multiple of the graph count that
    holds the largest graph; e_pad = n_pad * k with k = max_neighbors, else
    the largest in-degree.
    """
    n_pad = _bucket(sum(n_atoms) + 1)
    B = len(n_atoms)
    n_max = max(-(-n_pad // B), max(n_atoms))
    k = max_neighbors if max_neighbors is not None else max(1, in_degree)
    return B * n_max, B * n_max * k


class Predictor:
    def __init__(self, model, state_dict, cutoff: float,
                 max_neighbors: int | None, energy_mean: float = 0.0,
                 energy_std: float = 1.0, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.cutoff = cutoff
        self.max_neighbors = max_neighbors
        self.energy_mean = energy_mean
        self.energy_std = energy_std

    @classmethod
    def from_checkpoint(cls, run_dir: str, name: str = "ckpt_best", use_ema: bool = True,
                        device: str | torch.device = "cuda") -> "Predictor":
        """A Predictor of ``<run_dir>/<name>.pt``, written by
        train/train_matpes.py: the model of the stored config (float32,
        dropout off), its EMA weights (or the trained ones), the cutoff,
        neighbour cap and energy normalization of the config."""
        from .train.train_matpes import build_eval_model

        with open(os.path.join(run_dir, f"{name}.meta.json")) as f:
            cfg = json.load(f)["config"]
        sd = torch.load(os.path.join(run_dir, f"{name}.pt"), map_location="cpu",
                        weights_only=True)
        state = {**sd["model"], **sd["ema"]} if use_ema else sd["model"]
        return cls(build_eval_model(cfg), state, cfg["cutoff"], cfg.get("max_neighbors"),
                   cfg.get("energy_mean", 0.0), cfg.get("energy_std", 1.0), device)

    def predict(self, atomic_numbers, positions, cell=None) -> dict:
        """Single-structure energy (denormalized, total) + forces."""
        out = self.predict_batch([dict(
            atomic_numbers=np.asarray(atomic_numbers, np.int32),
            positions=np.asarray(positions, np.float32),
            cell=None if cell is None else np.asarray(cell, np.float32),
        )])
        return {k: v[0] for k, v in out.items()}

    def collate(self, structures: Sequence[dict]):
        """The padded fixed-degree batch (numpy) of one request, sized by
        ``pad_sizes``.  The neighbour search runs here only to find the
        largest in-degree when ``max_neighbors`` is None."""
        samples, n_atoms, in_degree = [], [], 0
        for s in structures:
            pbc = s.get("cell") is not None
            gs = GraphSample(atomic_numbers=s["atomic_numbers"],
                             pos=s["positions"], cell=s.get("cell"), pbc=pbc)
            samples.append(gs)
            n_atoms.append(gs.pos.shape[0])
            if self.max_neighbors is not None:
                continue
            if pbc:
                _, dst, _ = radius_graph_pbc(gs.pos.astype(np.float64), gs.cell,
                                             self.cutoff, None)
            else:
                _, dst, _ = radius_graph(gs.pos.astype(np.float64), self.cutoff, None)
            if dst.size:
                in_degree = max(in_degree, int(np.bincount(dst).max()))
        n_pad, e_pad = pad_sizes(n_atoms, in_degree, self.max_neighbors)
        return collate(samples, self.cutoff, self.max_neighbors, n_pad, e_pad)

    def predict_batch(self, structures: Sequence[dict]) -> dict:
        pb = self.collate(structures)
        batch = as_tensors(pb, self.device)
        with full_f32_products():
            outs = energy_and_forces(self.model, batch)

        natoms = np.asarray(pb.natoms)
        e_per_atom = (outs["energy"][:, 0].cpu().numpy() * self.energy_std
                      + self.energy_mean)
        forces = outs["forces"].cpu().numpy() * self.energy_std
        node_off = np.flatnonzero(pb.node_mask)
        out_forces, off = [], 0
        for n in natoms:
            out_forces.append(forces[node_off[off : off + n]])
            off += n
        return {
            "energy": e_per_atom * natoms,
            "energy_per_atom": e_per_atom,
            "forces": out_forces,
        }
