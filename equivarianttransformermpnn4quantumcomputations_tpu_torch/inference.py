"""Serving API: energies and forces for batches of structures.

Port of the JAX package's inference.py ``Predictor`` (energy + forces; the
JAX ``Predictor`` computes no stress either).  A request is one ragged batch
(``data/graph.py:collate`` at its defaults): its nodes padded to a multiple
of 16 above the atom count and its edges to a multiple of 128 above the edge
count, as in the JAX package, so the model must be built with the layout
defaults (``uniform_blocks=False``, ``fixed_degree=False``; a model built
for another layout is refused).  ``Predictor`` takes a model and a torch
``state_dict`` (for example one converted from the JAX
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
from .data.loader import bucket
from .models.matpes import energy_and_forces
from .utils.precision import full_f32_products

__all__ = ["Predictor"]


class Predictor:
    def __init__(self, model, state_dict, cutoff: float,
                 max_neighbors: int | None, energy_mean: float = 0.0,
                 energy_std: float = 1.0, device: str | torch.device = "cuda"):
        bb = model.backbone
        if bb.uniform_blocks or bb.fixed_degree:
            raise ValueError("Predictor serves ragged batches: build the model with "
                             "uniform_blocks=False and fixed_degree=False")
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
        dropout off, the ragged layout whatever layout it trained in, as the
        JAX ``Predictor.from_checkpoint`` builds it), its EMA weights (or the
        trained ones), the cutoff, neighbour cap and energy normalization of
        the config."""
        from .train.train_matpes import build_eval_model

        with open(os.path.join(run_dir, f"{name}.meta.json")) as f:
            cfg = json.load(f)["config"]
        sd = torch.load(os.path.join(run_dir, f"{name}.pt"), map_location="cpu",
                        weights_only=True)
        state = {**sd["model"], **sd["ema"]} if use_ema else sd["model"]
        model = build_eval_model({**cfg, "uniform_blocks": False, "fixed_degree": False})
        return cls(model, state, cfg["cutoff"], cfg.get("max_neighbors"),
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
        """The padded ragged batch (numpy) of one request: n_pad is a
        multiple of 16 above the atom count and e_pad a multiple of 128
        above the edge count, which the neighbour search here counts (JAX
        inference.py:119-146)."""
        samples = []
        max_e = 1
        n_tot = 0
        for s in structures:
            pbc = s.get("cell") is not None
            gs = GraphSample(atomic_numbers=s["atomic_numbers"], pos=s["positions"],
                             cell=s.get("cell"), pbc=pbc)
            samples.append(gs)
            n_tot += gs.pos.shape[0]
            if pbc:
                src, _, _ = radius_graph_pbc(gs.pos.astype(np.float64), gs.cell, self.cutoff,
                                             self.max_neighbors)
            else:
                src, _, _ = radius_graph(gs.pos.astype(np.float64), self.cutoff,
                                         self.max_neighbors)
            max_e += src.size
        return collate(samples, self.cutoff, self.max_neighbors, bucket(n_tot + 1),
                       bucket(max_e, 128))

    def predict_batch(self, structures: Sequence[dict]) -> dict:
        pb = self.collate(structures)
        batch = as_tensors(pb, self.device)
        with full_f32_products():
            outs = energy_and_forces(self.model, batch)

        natoms = np.asarray(pb.natoms)
        e_per_atom = (outs["energy"][:, 0].cpu().numpy() * self.energy_std
                      + self.energy_mean)
        forces = outs["forces"].cpu().numpy() * self.energy_std
        out_forces, off = [], 0
        for n in natoms:   # the ragged layout's graphs follow one another from row 0
            out_forces.append(forces[off : off + n])
            off += n
        return {
            "energy": e_per_atom * natoms,
            "energy_per_atom": e_per_atom,
            "forces": out_forces,
        }
