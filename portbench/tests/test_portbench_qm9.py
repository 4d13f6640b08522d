"""The QM9 configuration and cell (``configs/qm9-eqv2-k3.json``,
``qm9-train-b64``): the manifest entries, the molecule traffic, the counts'
reader, the reference against the program through the cell's own entry at
tiny widths on the CPU (sound, and not correct under each planted fault and
the lower-precision control), and the import guard over the new files."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import calibrate_qm9
from portbench.harness.common import (BENCH, ROOT, Phases, check_limits, load_cell,
                                      load_metric, program_model)
from portbench.harness.run import run_entry
from portbench.traffic import molecules

PKG = "equivarianttransformermpnn4quantumcomputations_tpu_torch"
trainer = pytest.importorskip(f"{PKG}.train.trainer")
so2conv = pytest.importorskip(f"{PKG}.ops.cuda.so2conv")

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
            attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32, lmax=2,
            mmax=1, edge_channels=16, num_rbf=16)
SEED = 2 ** 31 + 7


def test_qm9_configuration_is_the_programs():
    """The published sizes, as the program's own copy holds them."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.configs.qm9 import config

    cfg = json.loads((BENCH / "configs" / "qm9-eqv2-k3.json").read_text())
    entry = next(c for c in MAN["configs"] if c["name"] == "qm9-eqv2-k3")
    assert entry["file"] == "portbench/configs/qm9-eqv2-k3.json"
    assert cfg["reduced"] == entry["reduced"] == ["alpha_drop", "drop_path_rate"]
    for k, v in cfg["model"].items():
        if k in config and k not in cfg["reduced"]:
            assert v == config[k], k
    assert cfg["max_neighbors"] == config["max_neighbors"]
    tr = cfg["train"]
    assert (tr["lr"], tr["weight_decay"], tr["grad_clip"], tr["ema_decay"], tr["loss_kind"]) == (
        config["lr"], config["weight_decay"], config["grad_clip"], config["ema_decay"],
        config["loss"])
    assert (tr["compute_dtype"], tr["layout"], cfg["model"]["conv_fused"]) == (
        "float32", "ragged", True)
    model = program_model(cfg, "float32", "ragged")
    assert all(b.ga.so2_conv_1.fused and b.ga.so2_conv_2.fused for b in model.backbone.blocks)


def test_the_cell_in_every_training_metric():
    c = load_cell("qm9-train-b64")
    names = {m["name"] for m in c.per_layer}
    assert {"loader_wait_ms.train", "launches_per_step.train", "rotation_roofline.train",
            "s2act_roofline.train", "device_idle.train", "mfu.train", "data_wait_ms.train",
            "idle_forward_ms.train", "idle_backward_ms.train", "idle_update_ms.train",
            "host_syncs_per_step.train", "sync_wait_ms.train", "so2conv_roofline.train"} <= names
    assert all("qm9-train-b64" not in m["workloads"] for m in MAN["per_layer"]
               if "workloads" in m and m["name"] not in names)
    assert {m["name"] for m in c.end_to_end} == {"train_graphs_per_s", "peak_mem_gib",
                                                 "setup_s"}
    assert (BENCH / "entries" / f"{c.traffic['entry']}.py").exists()
    assert (BENCH / "traffic" / f"{c.traffic['generator']}.py").exists()


def test_molecule_traffic_is_seeded_and_the_same_work():
    params = dict(load_cell("qm9-train-b64").traffic, pool=64)
    a, b, c = (molecules.generate(params, s) for s in (2 ** 31 + 1, 2 ** 31 + 1, 2 ** 31 + 2))
    assert all(np.array_equal(x["pos"], y["pos"]) and np.array_equal(x["y"], y["y"])
               for x, y in zip(a, b))
    assert not all(np.array_equal(x["pos"], y["pos"]) for x, y in zip(a, c))
    assert sorted(len(m["z"]) for m in a) == sorted(len(m["z"]) for m in c)


def test_qm9_pads_are_the_programs_rule_and_seed_free():
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph, loader

    from portbench.entries.qm9_train import pads

    cell = load_cell("qm9-train-b64")
    cell.traffic["pool"] = 128
    n_pad, e_pad = pads(loader, graph, cell)
    data = [graph.GraphSample(atomic_numbers=m["z"], pos=m["pos"], y=m["y"])
            for m in molecules.generate(cell.traffic, cell.traffic["pads_seed"])]
    assert (n_pad, e_pad) == loader.infer_pad_sizes(data, 5.0, 50, 64, sample=len(data))
    cell.config["train"]["layout"] = "fixed_degree"
    n_f, e_f = pads(loader, graph, cell)
    assert e_f == n_f * 50


def test_so2conv_roofline_reads_k3_and_nothing_else():
    from portbench.harness.readings import Readings
    from portbench.harness.trace import Slice

    cfg = load_cell("qm9-train-b64").config
    metric = load_metric("so2conv_roofline.train")
    sl = Slice(1, device=[("void so2conv_kernel<float>(Params)", 0.0, 0.004),
                          ("void b_operand_kernel<float>(float const*)", 0.004, 0.0045),
                          ("gemm", 0.0045, 0.1)])
    r = Readings(cfg["model"], cfg["outputs"], "train", "float32", 1.0, [], counts="qm9")
    r.slice, r.slice_shapes = sl, [(2320, 1024, 0, 0)]
    ops = r.ops.so2conv_ops(cfg["model"], cfg["outputs"], "train", "float32", 2320, 1024)
    assert len(ops) == 32
    assert metric.read(r) == pytest.approx(100 * r.ops.bound_seconds(ops) / 0.0045)
    r.slice = Slice(1, device=[("gemm", 0.0, 0.1)])
    assert metric.read(r) is None
    m = json.loads((BENCH / "configs" / "matpes-gata-v2.json").read_text())
    r = Readings(m["model"], m["outputs"], "train", "bfloat16", 1.0, [], counts="ops")
    r.slice, r.slice_shapes = sl, [(496, 9920, 0, 0)]
    assert metric.read(r) is None


def _tiny_qm9():
    cell = load_cell("qm9-train-b64")
    cell.config["model"].update(TINY)
    cell.traffic.update(pool=32, structures_per_step=4, reference_graphs_per_block=2)
    return cell


def _correct(cell) -> tuple[bool, dict]:
    torch.set_num_threads(2)
    r = run_entry(cell, SEED, 0.3, False, "cpu", Phases(time.perf_counter()))
    return check_limits(r["numbers"], cell.limits)


def test_qm9_cell_reference_against_the_program():
    ok, checks = _correct(_tiny_qm9())
    assert ok, checks


@pytest.mark.parametrize("fault", ["half-batch", "k3-tf32", "state-unchanged"])
def test_qm9_planted_faults_are_not_correct(fault, monkeypatch):
    if fault == "half-batch":
        monkeypatch.setattr(trainer, "qm9_loss", trainer.qm9_loss)
        calibrate_qm9.half_batch(trainer)
    elif fault == "k3-tf32":
        for name in ("b_operands", "fwd", "adj"):
            monkeypatch.setattr(so2conv, name, getattr(so2conv, name))
        calibrate_qm9.k3_single_tf32(so2conv)
    else:
        def frozen(state, ema_decay=0.999):
            state.step += 1
            return {"grad_norm": torch.zeros(()), "lr": 0.0, "accepted": True}

        monkeypatch.setattr(trainer, "apply_updates", frozen)
    ok, checks = _correct(_tiny_qm9())
    assert not ok, checks


def test_qm9_control_is_not_correct():
    cell = _tiny_qm9()
    torch.set_num_threads(2)
    r = calibrate_qm9.control(cell, SEED, "cpu")
    ok, checks = check_limits(dict(r["numbers"], graph_mismatch=0.0, overflow=0.0),
                              cell.limits)
    assert not ok, checks


def test_new_files_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.entries.qm9_train, portbench.calibrate_qm9, "
            "portbench.reference.qm9, portbench.counts.qm9, portbench.traffic.molecules\n"
            "from portbench.harness.common import load_metric\n"
            "load_metric('so2conv_roofline.train')\n"
            "import %s.models.qm9, %s.train.trainer, %s.ops.cuda.so2conv\n"
            "from portbench.harness.common import jax_loaded; print(jax_loaded())"
            % (str(ROOT), PKG, PKG, PKG))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
