"""The roofline and MFU counts against values worked out by hand at a small
shape (lmax = mmax = 1, 4 channels, one layer), and their passes as the
configuration's outputs and switches set them."""

from __future__ import annotations

import pytest

from portbench.counts import ops

SMALL = dict(num_layers=1, sphere_channels=4, attn_hidden_channels=4, num_heads=1,
             attn_alpha_channels=2, attn_value_channels=4, ffn_hidden_channels=8, lmax=1,
             mmax=1, grid_resolution=4, edge_channels=4, num_rbf=4)
GRAD = {"energy": "per_atom", "forces": "gradient"}           # MatPES
HEAD = {"energy": "per_avg_num_nodes", "forces": "head"}       # OC20
BASE = dict(SMALL, gata=False)


def test_rotation_ops_serve():
    got = ops.rotation_ops(SMALL, GRAD, "serve", "float32", 16, 128)
    # edge-degree [128, 2 -> 4, 4] f32; to_m0 [128, 4 -> 2, 8]; from [128, 4 -> 4, 4]
    one = [(4 * 128 * 6 * 4, 2 * 128 * 4 * 4), (4 * 128 * 6 * 8, 2 * 128 * 4 * 8),
           (4 * 128 * 8 * 4, 2 * 128 * 10 * 4)]
    assert [(o.bytes, o.flops) for o in got] == one * 2
    assert all(o.route == "ffma" for o in got)
    assert ops.bound_seconds(got) == pytest.approx(2 * (12288 + 24576 + 16384) / 3.35e12)
    assert len(ops.rotation_ops(SMALL, GRAD, "train", "bfloat16", 16, 128)) == 12


def test_rotation_ops_train_dtypes():
    got = ops.rotation_ops(SMALL, GRAD, "train", "bfloat16", 16, 128)
    assert got[0].bytes == 4 * 128 * 6 * 4       # the edge-degree embedding stays float32
    assert got[1].bytes == 2 * 128 * 6 * 8       # the attention's rotation in bf16
    oc = ops.rotation_ops(BASE, HEAD, "train", "bfloat16", 16, 128)
    assert len(oc) == 2 * 5 and oc[3].bytes == 4 * 128 * 8 * 8   # the force head in f32


def test_s2act_ops():
    got = ops.s2act_ops(SMALL, GRAD, "serve", "float32", 16, 128)
    k2a = ops.Op(4 * 2 * 16 * 4 * 8 + 2 * 4 * 16 * 4, 2 * 2 * 16 * 4 * 16 * 8, "f32_tc")
    k2b = ops.Op(4 * 3 * 16 * 4 * 8 + 2 * 4 * 16 * 4, 2 * 3 * 16 * 4 * 16 * 8, "f32_tc")
    assert got == [k2a, k2b, k2a, k2b]
    assert k2a.seconds() == pytest.approx(max(4608 / 3.35e12, 16384 / (495e12 / 3)))
    train = ops.s2act_ops(SMALL, GRAD, "train", "bfloat16", 16, 128)
    assert len(train) == 8 and train[0].route == "bf16" and train[4].route == "f32_tc"
    assert train[3].flops == 2 * 5 * 16 * 4 * 16 * 8          # K2c
    assert train[3].bytes == 2 * 5 * 16 * 4 * 8 + 2 * 4 * 16 * 4


def test_forward_flops_by_hand():
    # matpes: edge-degree 19200 + 3200, h_proj / W_erp 6400, HTR 36000,
    # GATA attention 147280, FFN 26240, energy head 24320
    assert ops.forward_flops(SMALL, GRAD, 10, 100) == 262640
    assert ops.model_flops(SMALL, GRAD, "train", 10, 100) == 6 * 262640
    assert ops.model_flops(SMALL, GRAD, "serve", 10, 100) == 2 * 262640
    # oc20 (default grid: 20 points): edge-degree 22400, attention 281680, FFN 31360,
    # energy head 29440, force head 280720
    oc = dict(BASE, grid_resolution=None)
    assert ops.grid_points(1, 1, None) == 20
    assert ops.forward_flops(oc, HEAD, 10, 100) == 645600
    assert ops.model_flops(oc, HEAD, "train", 10, 100) == 3 * 645600
    assert ops.model_flops(oc, HEAD, "serve", 10, 100) == 645600


def test_switches_by_hand():
    # phi every layer: phi_proj [num_rbf 4 -> S 3 x H 4] on 100 edges, 2 x 100 x 4 x 12
    phi = dict(SMALL, use_phi_every_layer=True)
    assert ops.forward_flops(phi, GRAD, 10, 100) == 262640 + 9600
    # a force head at SMALL's 16-point grid: 280720 at 20 points less the edge S2's
    # 4 x 100 edges x 4 grid points x 4 rows x 4 channels
    base = ops.forward_flops(BASE, GRAD, 10, 100)
    assert ops.forward_flops(BASE, HEAD, 10, 100) - base == 280720 - 4 * 100 * 4 * 4 * 4


@pytest.mark.parametrize("outputs,mode,passes,kernels", [
    (GRAD, "train", 4, "abbc"), (GRAD, "serve", 2, "ab"), (HEAD, "train", 2, "ab"),
    (HEAD, "serve", 1, "a")])
def test_passes_follow_the_outputs(outputs, mode, passes, kernels):
    assert ops.op_passes(outputs, mode) == passes
    assert len(ops.rotation_ops(SMALL, outputs, mode, "float32", 16, 128)) == passes * (
        3 + 2 * (outputs["forces"] == "head"))
    got = ops.s2act_ops(SMALL, outputs, mode, "float32", 16, 128)
    sites = 2 + (outputs["forces"] == "head")
    assert len(got) == sites * len(kernels)
