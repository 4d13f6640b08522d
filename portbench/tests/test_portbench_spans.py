"""The readers of the program's spans (``harness/spans.py`` and the metrics
that use it), on made-up slices."""

from __future__ import annotations

import pytest

from portbench.harness import spans as S
from portbench.harness.common import load_metric
from portbench.harness.readings import Readings
from portbench.harness.trace import Slice

SPAN_METRICS = ("data_wait_ms.train", "idle_forward_ms.train", "idle_backward_ms.train",
                "idle_update_ms.train", "host_syncs_per_step.train", "sync_wait_ms.train",
                "data_collate_ms.serve", "idle_model_ms.serve",
                "host_syncs_per_request.serve", "sync_wait_ms.serve")


def _step_slice(units: int = 1) -> Slice:
    """One step on a made-up clock: the device runs [1, 2), [4, 5) and
    [8, 9); the window is [0, 10)."""
    return Slice(units=units, device=[("k1", 1.0, 2.0), ("k2", 4.0, 5.0), ("k3", 8.0, 9.0)],
                 host=[("etq.data.wait", 0.0, 0.5), ("etq.step", 0.5, 10.0),
                       ("etq.step.forward", 0.5, 3.0), ("etq.model.attention", 0.6, 2.9),
                       ("etq.sync.wigner_j", 2.0, 2.5), ("etq.step.backward", 3.0, 6.0),
                       ("etq.step.update", 6.0, 10.0), ("etq.step.adamw", 6.5, 7.0),
                       ("etq.sync.guard", 9.0, 9.5), ("aten::mm", 0.0, 10.0)])


def test_an_idle_gap_across_two_phases_is_split_by_overlap():
    # the gap [2, 4) lies 1 s in the forward and 1 s in the backward
    split = S.idle_by_phase(_step_slice())
    assert split["etq.step.forward"] == pytest.approx(0.5 + 1.0)   # [0.5, 1) and [2, 3)
    assert split["etq.step.backward"] == pytest.approx(1.0 + 1.0)   # [3, 4) and [5, 6)
    # the update's gap [6, 8) and [9, 10): adamw is innermost over [6.5, 7)
    assert split["etq.step.adamw"] == pytest.approx(0.5)
    assert split["etq.step.update"] == pytest.approx(1.5 + 1.0)
    assert split["etq.data.wait"] == pytest.approx(0.5)
    assert S.OUTSIDE not in split
    assert sum(split.values()) == pytest.approx(10.0 - 3.0)
    assert S.idle_ms(_step_slice(), ("etq.step.update", "etq.step.adamw")) == \
        pytest.approx(3000.0)


def test_idle_outside_every_phase_and_per_unit():
    sl = _step_slice(units=2)
    sl.host = [h for h in sl.host if h[0] != "etq.data.wait"]   # [0, 0.5) uncovered
    split = S.idle_by_phase(sl)
    assert split[S.OUTSIDE] == pytest.approx(0.5)
    assert S.idle_ms(sl, ("etq.step.backward",)) == pytest.approx(1000.0)   # 2 s / 2 units


def test_nested_sync_spans_count_once_toward_wait_and_each_toward_syncs():
    sl = Slice(units=1, device=[("k", 0.0, 1.0)], host=[
        ("etq.request", 0.0, 10.0), ("etq.sync.d2h", 1.0, 3.0), ("etq.sync.d2h", 1.5, 2.5),
        ("etq.sync.h2d", 4.0, 4.5), ("etq.sync.h2d", 4.25, 5.0)])
    assert S.syncs(sl) == 4
    # [1, 3) once, then [4, 5) from two overlapping spans
    assert S.sync_wait_ms(sl) == pytest.approx(3000.0)


def test_a_slice_without_program_spans_gives_none():
    sl = Slice(units=1, device=[("k", 0.0, 1.0)], host=[("aten::mm", 0.0, 2.0)])
    r = Readings({}, {}, "train", "bfloat16", 1.0, [], slice=sl)
    for name in SPAN_METRICS:
        assert load_metric(name).read(r) is None, name
    assert S.idle_by_phase(sl) is None
    assert S.idle_by_phase(None) is None and S.syncs(None) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_each_metric_reads_a_slice_with_spans(name):
    sl = _step_slice()
    sl.host += [("etq.data.collate", 0.0, 0.2), ("etq.request.model", 0.5, 10.0)]
    r = Readings({}, {}, "train", "bfloat16", 1.0, [], slice=sl)
    v = load_metric(name).read(r)
    assert v is not None and v >= 0.0
    if name.startswith("host_syncs"):
        assert v == 2
    if name.startswith("sync_wait"):
        assert v == pytest.approx(1000.0)
