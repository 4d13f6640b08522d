"""The plain reference against the program at tiny widths on the CPU: the
one place where the two meet.  Energies, forces (and stress) and the
training losses and their gradients of both configurations, and of the
switches a configuration file may turn (the baseline attention, the alpha
scaling, phi every layer, the stress term); the neighbour lists."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench.harness.common import BENCH, draw_weights, program_model, reference_model
from portbench.reference.geometry import wigner_blocks
from portbench.reference.model import Model
from portbench.reference.neighbors import edge_key, neighbor_list
from portbench.reference.train import Trainer, reference_batch
from portbench.traffic import labelled_pool

PKG = "equivarianttransformermpnn4quantumcomputations_tpu_torch"
graph = pytest.importorskip(f"{PKG}.data.graph")
matpes = pytest.importorskip(f"{PKG}.models.matpes")
trainer = pytest.importorskip(f"{PKG}.train.trainer")
rotation = pytest.importorskip(f"{PKG}.ops.rotation")

TINY = dict(num_layers=2, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
            attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=16, lmax=3,
            mmax=2, edge_channels=8, num_rbf=10, max_num_elements=30, cutoff=5.0,
            avg_degree=12.0, alpha_drop=0.0, drop_path_rate=0.0)
K = 6
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=1e-3, grad_clip=1.0,
           ema_decay=0.999)
FILES = {"matpes": "matpes-gata-v2", "oc20": "oc20-s2ef-eqv2-l6"}
# case -> (configuration file, model keys changed, train keys changed)
CASES = {
    "matpes": ("matpes", dict(grid_resolution=8), {}),
    "oc20": ("oc20", dict(grid_resolution=None, avg_num_nodes=7.0), {}),
    "matpes-baseline": ("matpes", dict(grid_resolution=8, gata=False), {}),
    "matpes-no-attn-norm": ("matpes", dict(grid_resolution=8, normalize_attn_output=False),
                            {}),
    "matpes-phi-every-layer": ("matpes", dict(grid_resolution=8, use_phi_every_layer=True),
                               {}),
    "matpes-stress": ("matpes", dict(grid_resolution=8), dict(w_stress=0.5)),
}


def _config(case: str) -> dict:
    base, model_keys, train_keys = CASES[case]
    cfg = json.loads((BENCH / "configs" / f"{FILES[base]}.json").read_text())
    cfg["model"].update(TINY, **model_keys)
    cfg["train"].update(OPT, **train_keys)
    return cfg


def _case(case: str):
    cfg = _config(case)
    model = program_model(cfg, "float32", "fixed_degree")
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    w = draw_weights(shapes, 5, "cpu")
    model.load_state_dict(w)
    structs = labelled_pool.generate(dict(atoms=7, pool=3), 9)
    rng = np.random.default_rng(4)
    for s in structs:
        s["stress"] = rng.normal(size=6).astype(np.float32)
    samples = [graph.GraphSample(atomic_numbers=s["z"], pos=s["pos"], cell=s["cell"], pbc=True,
                                 energy=s["energy"], forces=s["forces"], stress=s["stress"])
               for s in structs]
    pb = graph.collate(samples, TINY["cutoff"], K, 3 * 8, 3 * 8 * K, fixed_degree=True)
    return cfg, model, w, structs, pb


def _program_outputs(cfg, model, batch, create_graph: bool) -> dict:
    stress = cfg["train"].get("w_stress", 0.0) > 0.0
    if cfg["outputs"]["forces"] == "gradient":
        out = matpes.matpes_energy_forces(model, batch, create_graph=create_graph,
                                          regress_stress=stress)
        return dict(out, energy=out["energy"][:, 0])
    return model(batch)


@pytest.mark.parametrize("case", list(CASES))
def test_energies_and_forces(case):
    cfg, model, w, structs, pb = _case(case)
    batch = graph.as_tensors(pb, "cpu")
    ref = reference_model(cfg)
    rb = reference_batch(structs, TINY["cutoff"], K, "cpu")
    stress = cfg["train"].get("w_stress", 0.0) > 0.0
    with torch.set_grad_enabled(cfg["outputs"]["forces"] == "gradient"):
        out = _program_outputs(cfg, model.eval(), batch, False)
        want = ref.energy_forces(w, rb, stress=stress)
    f_got = out["forces"][torch.as_tensor(pb.node_mask)]
    assert torch.allclose(out["energy"].detach(), want["energy"].detach(), rtol=1e-5, atol=1e-6)
    assert torch.allclose(f_got.detach(), want["forces"].detach(), rtol=1e-4, atol=1e-5)
    if stress:
        assert torch.allclose(out["stress"].detach(), want["stress"].detach(), rtol=1e-4,
                              atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients(case):
    cfg, model, w, structs, pb = _case(case)
    opt = cfg["train"]
    batch = graph.as_tensors(pb, "cpu")
    model.train()
    if cfg["outputs"]["forces"] == "gradient":
        outs = matpes.matpes_energy_forces(model, batch, create_graph=True,
                                           regress_stress=opt.get("w_stress", 0.0) > 0.0)
        loss, _ = trainer.matpes_loss(outs, batch, opt["w_energy"], opt["w_force"],
                                      opt.get("w_stress", 0.0))
    else:
        outs = model(batch)
        loss, _ = trainer.oc20_loss(outs["energy"], batch["energy"], outs["forces"],
                                    batch["forces"], batch["node_mask"], opt["w_energy"],
                                    opt["w_force"])
    loss.backward()
    ref = Trainer(reference_model(cfg), w, opt, TINY["cutoff"], K, "cpu", graphs_per_block=2)
    ref_loss, grads = ref.gradient(structs)
    assert loss.item() == pytest.approx(ref_loss, rel=1e-5)
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert torch.allclose(g, grads[n], rtol=1e-3, atol=1e-6 * max(1.0, grads[n].abs().max())), n


@pytest.mark.parametrize("keys", [dict(global_attn="scalar"), dict(gata_v1=True),
                                  dict(alpha_drop=0.1), dict(some_new_option=1)])
def test_reference_refuses_what_it_does_not_compute(keys):
    with pytest.raises(NotImplementedError):
        Model(dict(TINY, **keys), {"energy": "per_atom", "forces": "gradient"})


def test_neighbour_lists_and_wigner():
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(8, 40))
        cell = (np.eye(3) * 6 * (n / 30) ** (1 / 3) + rng.normal(size=(3, 3)) * 0.2).astype(
            np.float32)
        pos = (rng.uniform(0, 1, size=(n, 3)) @ cell).astype(np.float32)
        got = edge_key(*graph.radius_graph_pbc(pos.astype(np.float64), cell, 6.0, 20))
        assert np.array_equal(got, edge_key(*neighbor_list(pos, cell, 6.0, 20)))
    vec = torch.as_tensor(rng.normal(size=(64, 3)), dtype=torch.float32)
    want = rotation.compute_wigner_blocks(6, vec).blocks
    for a, b in zip(wigner_blocks(6, vec), want):
        assert torch.allclose(a, b, atol=2e-5)
