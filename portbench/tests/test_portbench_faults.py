"""A run with its timed path broken underneath comes out not correct, and so
does the control: the plain reference in the next lower precision in the
program's place.  Tiny widths on the CPU; the look for a card is skipped,
everything else of a run is driven as on the card, with the cells' limits."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import calibrate
from portbench.harness.common import Phases, check_limits, load_cell
from portbench.harness.run import run_entry

PKG = "equivarianttransformermpnn4quantumcomputations_tpu_torch"
trainer = pytest.importorskip(f"{PKG}.train.trainer")
inference = pytest.importorskip(f"{PKG}.inference")

TINY = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
            attn_alpha_channels=4, attn_value_channels=8, ffn_hidden_channels=32, lmax=3,
            mmax=2, edge_channels=16, num_rbf=16)
SEED = 2 ** 31 + 7


def tiny(name: str):
    cell = load_cell(name)
    cell.config["model"].update(TINY)
    if cell.traffic["entry"] == "train":
        atoms, slots = (8, 9) if name.startswith("matpes") else (12, 14)
        cell.traffic.update(pool=32, structures_per_step=4, atoms=atoms, node_slots=slots,
                            reference_graphs_per_block=2)
    else:
        cell.traffic.update(structures_per_request=3, atoms_max=24, requests=6)
    return cell


def correct(cell, seconds: float = 0.5) -> tuple[bool, dict]:
    torch.set_num_threads(2)
    r = run_entry(cell, SEED, seconds, False, "cpu", Phases(time.perf_counter()))
    return check_limits(r["numbers"], cell.limits)


TRAIN = ["matpes-train-b64x30", "oc20-train-b16x72"]


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged(name, monkeypatch):
    def frozen(state, ema_decay=0.999):
        state.step += 1
        return {"grad_norm": torch.zeros(()), "lr": 0.0, "accepted": True}

    monkeypatch.setattr(trainer, "apply_updates", frozen)
    ok, checks = correct(tiny(name))
    assert not ok, checks
    assert checks["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_left_out(name, monkeypatch):
    cell = tiny(name)
    forces = cell.config["outputs"]["forces"]
    attr = "matpes_loss" if forces == "gradient" else "oc20_loss"
    monkeypatch.setattr(trainer, attr, getattr(trainer, attr))
    calibrate.half_batch(trainer, forces)
    ok, checks = correct(cell)
    assert not ok, checks


def test_answer_altered(monkeypatch):
    plain = inference.energy_and_forces

    def altered(model, batch):
        out = plain(model, batch)
        return dict(out, forces=out["forces"] * 1.02)

    monkeypatch.setattr(inference, "energy_and_forces", altered)
    ok, checks = correct(tiny("matpes-serve-mixed16"))
    assert not ok and checks["force_gap"]["value"] > checks["force_gap"]["limit"], checks


def test_answer_missing(monkeypatch):
    plain = inference.Predictor.predict_batch
    calls = []

    def flaky(self, structures):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError("dropped request")
        return plain(self, structures)

    monkeypatch.setattr(inference.Predictor, "predict_batch", flaky)
    ok, checks = correct(tiny("matpes-serve-mixed16"))
    assert not ok and checks["unanswered"]["value"] == 1.0, checks


@pytest.mark.parametrize("name", TRAIN + ["matpes-serve-mixed16"])
def test_control_fails(name):
    torch.set_num_threads(2)
    cell = tiny(name)
    fn = calibrate.control_train if cell.traffic["entry"] == "train" else calibrate.control_serve
    numbers = fn(cell, SEED, "cpu")["numbers"]
    limits = {k: v for k, v in cell.limits.items() if k in numbers}
    ok, checks = check_limits(numbers, limits)
    assert not ok, checks


@pytest.mark.parametrize("name", TRAIN)
def test_first_gradient_is_what_the_optimizer_received(name):
    """The harness's hook reads the clipped gradient of the first step: the
    optimizer's first moment after that step over (1 - beta1)."""
    from portbench.entries.train import FirstGradient, build
    from portbench.harness.common import draw_weights, program

    torch.set_num_threads(2)
    cell = tiny(name)
    cfg, opt = cell.config, cell.config["train"]
    model = build(cfg, "cpu")
    model.load_state_dict(draw_weights({n: tuple(t.shape) for n, t in
                                        model.state_dict().items()}, SEED, "cpu"))
    optim = trainer.GuardedAdamW(model.named_parameters(), lambda t: 1e-3, 0.0, 1e-3)
    step = program(cfg["program"]["train_step"])(trainer.create_train_state(model, optim),
                                                  **{a: opt[a] for a in opt["step_args"]})
    graph = pytest.importorskip(f"{PKG}.data.graph")
    from portbench.traffic import labelled_pool

    pool = labelled_pool.generate(dict(atoms=cell.traffic["atoms"], pool=4), 3)
    pb = graph.collate([graph.GraphSample(atomic_numbers=s["z"], pos=s["pos"], cell=s["cell"],
                                          pbc=True, energy=s["energy"], forces=s["forces"])
                        for s in pool], cfg["model"]["cutoff"], cfg["max_neighbors"],
                       4 * cell.traffic["node_slots"],
                       4 * cell.traffic["node_slots"] * cfg["max_neighbors"], fixed_degree=True)
    params = dict(model.named_parameters())
    first = FirstGradient(params)
    step(graph.as_tensors(pb, "cpu"))
    first.close()
    assert first.source == "optimizer step hook"
    beta1 = optim.opt.param_groups[0]["betas"][0]
    st = optim.opt.state
    for n, p in params.items():
        want = float(st[p]["exp_avg"].norm()) / (1 - beta1)
        assert first.norms[n] == pytest.approx(want, rel=1e-5, abs=1e-12), n


def test_first_gradient_without_an_optimizer_hook():
    """Where no ``torch.optim`` step runs, the gradient is read from ``.grad``
    after the first step."""
    from portbench.entries.train import FirstGradient

    p = torch.nn.Parameter(torch.zeros(3))
    first = FirstGradient({"w": p})
    p.grad = torch.tensor([3.0, 0.0, 4.0])
    first.close()
    assert first.source == ".grad after the step" and first.norms == {"w": 5.0}
