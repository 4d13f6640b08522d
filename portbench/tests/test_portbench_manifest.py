"""BENCHMARK.json against the benchmark's rules and its own files."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench.harness.common import BENCH, ROOT, load_cell, load_metric

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            yield group, e


@pytest.mark.parametrize("group,entry", list(_names()), ids=lambda v: str(v)[:40])
def test_names_and_units(group, entry):
    assert NAME.match(entry["name"]), entry["name"]
    if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    for key in ("why", "layer") + (("source",) if group == "configs" else ()):
        if key in entry:
            v = entry[key]
            assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_end_to_end_rules():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files(cell):
    w = next(x for x in MAN["workloads"] if x["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    c = load_cell(cell)
    assert c.traffic["entry"] in ("train", "serve")
    assert (BENCH / "entries" / f"{c.traffic['entry']}.py").exists()
    assert (BENCH / "traffic" / f"{c.traffic['generator']}.py").exists()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:   # the end-to-end metric it moves is reported in the cell
        assert m["moves"] in e2e
    assert c.limits


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_metric_files(metric):
    entry = next(m for m in MAN["per_layer"] if m["name"] == metric)
    mod = load_metric(metric)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["better"], entry["source"], entry["layer"], entry["moves"])
    assert set(entry) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert callable(mod.read)
    if "roofline" in metric or "mfu" in metric:
        assert entry["unit"] == "%"


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / cfg["file"]
    assert path.is_relative_to(BENCH)
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:   # no width is cut
        assert not re.search(r"(_dim|_rank|channels|hidden|heads|lmax|mmax)", key)
    files = [ROOT / c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


def test_every_config_used_and_file_names():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for p in Path(BENCH).rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
