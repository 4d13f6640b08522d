"""The window arithmetic and the profiled slice's reading, on made-up spans."""

from __future__ import annotations

import pytest

from portbench.harness.readings import Readings
from portbench.harness.trace import Slice, bucket
from portbench.harness.window import gaps, interval_union, percentile, rate


def test_rate_over_the_whole_window_with_a_stall():
    # 10 steps of 64 graphs in 5 s, then a 5 s stall in the window: the stall counts
    assert rate(10 * 64, 10.0) == pytest.approx(64.0)
    with pytest.raises(ValueError):
        rate(1, 0.0)


def test_percentile_over_all_requests():
    lat = [0.1] * 95 + [1.0] * 5          # 5 % of the requests waited behind a stall
    assert percentile(lat, 50) == pytest.approx(0.1)
    assert percentile(lat, 95) == pytest.approx(0.1 + 0.9 * 0.05)
    assert percentile(lat, 100) == 1.0
    assert percentile(list(range(1, 11)), 95) == pytest.approx(9.55)   # numpy's linear rule


def test_interval_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    u = interval_union(spans)
    assert u == [(0.0, 2.0), (3.0, 4.0), (6.0, 7.0)]
    assert gaps(u, -1.0, 8.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 6.0), (7.0, 8.0)]
    assert gaps(u, 0.0, 7.0) == [(2.0, 3.0), (4.0, 6.0)]


def _slice():
    return Slice(units=2, device=[
        ("void pairs_kernel<float>", 1.0, 1.5), ("elementwise_kernel", 1.4, 2.0),
        ("void s2act_tc_kernel<bf16, 25, 0>", 4.0, 5.0), ("Memcpy HtoD", 5.0, 5.5)],
        host=[("step", 0.0, 6.0), ("aten::index_put_", 2.0, 3.0), ("cudaStreamSynchronize",
                                                                 5.5, 6.0)])


def test_slice_busy_idle_and_breakdown():
    sl = _slice()
    assert sl.window == (0.0, 6.0)
    assert sl.busy_s == pytest.approx(2.5)          # 1.0-2.0, 4.0-5.5
    assert sl.kernel_s(("pairs_kernel",)) == pytest.approx(0.5)
    labels = dict((lab, sec) for sec, lab in sl.idle_gaps())
    assert labels == {"step": pytest.approx(1.0),
                      "aten::index_put_": pytest.approx(2.0),
                      "cudaStreamSynchronize": pytest.approx(0.5)}
    gaps_ = sorted(sl.idle_gaps())
    assert [round(s, 6) for s, _ in gaps_] == [0.5, 1.0, 2.0]
    b = sl.breakdown()
    assert b["device_ops"][0][0].startswith("port kernels") and b["device_ops"][0][1] == 1.0
    assert b["idle_gaps"][0] == ["aten::index_put_", pytest.approx(2.0)]
    assert bucket("Memcpy HtoD") == "concat / copy"


def test_readings_idle_launches_and_absent_kernels():
    model = dict(num_layers=1, sphere_channels=4, attn_hidden_channels=4, num_heads=1,
                 attn_alpha_channels=2, attn_value_channels=4, ffn_hidden_channels=8, lmax=1,
                 mmax=1, grid_resolution=4, edge_channels=4, num_rbf=4)
    grad = {"energy": "per_atom", "forces": "gradient"}
    head = {"energy": "per_avg_num_nodes", "forces": "head"}
    r = Readings(model, grad, "serve", "float32", 10.0, [(16, 128, 10, 100)],
                 slice=_slice(), slice_shapes=[(16, 128, 10, 100)] * 2)
    assert r.idle() == pytest.approx(100 * (1 - 2.5 / 6.0))
    assert r.launches() == 2.0
    assert r.roofline("rotation", ("rot_kernel", "nothing")) is None
    assert r.roofline("rotation", ("pairs_kernel",)) > 0
    assert Readings(model, head, "train", "bfloat16", 1.0, []).mfu(1.0) is None
