"""FLOP and byte counts of the QM9 configuration (``counts: "qm9"``), for
its rooflines and its MFU; the peaks and the per-site arithmetic are
``counts/ops.py``'s.

The model is the baseline EquiformerV2 backbone (no GATA) with
``num_targets`` stacked feed-forward heads and no forces, so a training
step is first order: each operation runs in the forward and once more in
the loss backward (2 operation passes), and the model FLOPs are the forward
times 3 (the backward by input and by weights).

* Rotations (``rotation_ops``): the edge-degree embedding's (float32, m = 0
  input rows) and each layer's two (into the edge frame at 2C channels, back
  at heads x value channels), at ``e_pad``.
* S2 activations (``s2act_ops``): each layer's FFN at ``n_pad`` rows and its
  edge activation at ``e_pad`` (K = the reduced layout, the reduced grid),
  and the stacked heads' one call over ``num_targets x n_pad`` rows: K2a in
  the forward, K2b in the backward.
* K3 (``so2conv_ops``): each layer's two SO(2) convolutions (2C -> H with
  the attention's heads x alpha + H scalars carved from m = 0; H -> heads x
  value) at ``e_pad``: the forward in the forward pass and the adjoint in
  the backward, 2 x num_layers calls each.  A call's FLOPs are its GEMMs,
  2 E x the packed weight's entries (m = 0: [L0 Cin, extra + L0 Cout]; m >
  0: the butterfly [2 Lm Cin, 2 Lm Cout]); its bytes read the input and the
  weights and write the output once (the forward: x, y and the extra
  scalars; the adjoint: dy and the extra's gradient, dx).  Route: float32 as
  3xTF32 on the tensor cores (3 TF32 FLOPs per float32 FLOP at 495 TFLOP/s),
  bf16 at 989 TFLOP/s: the bound ``chip_smoke.py`` gives K3.
"""

from __future__ import annotations

from .ops import (BYTES, MFU_PEAK, Op, _attention, _dims, _ffn, _K2, _rad, _rot, _s2,
                  bound_seconds, grid_points)

__all__ = ["MFU_PEAK", "bound_seconds", "rotation_ops", "s2act_ops", "so2conv_ops",
           "forward_flops", "model_flops"]

# operation passes of a training step (forward, loss backward) and of a request
PASSES = {"train": 2, "serve": 1}


def rotation_ops(model: dict, outputs: dict, mode: str, compute: str, n_pad: int,
                 e_pad: int) -> list[Op]:
    d = _dims(model)
    E, C = e_pad, d["C"]
    sites = [_rot(E, d["L0"], d["Kf"], C, d["Kf"], "float32")]
    for _ in range(model["num_layers"]):
        sites.append(_rot(E, d["Kf"], d["Kr"], 2 * C, d["P_to"], compute))
        sites.append(_rot(E, d["Kr"], d["Kf"], d["O"], d["P_to"], compute))
    return sites * PASSES[mode]


def s2act_ops(model: dict, outputs: dict, mode: str, compute: str, n_pad: int,
              e_pad: int) -> list[Op]:
    d = _dims(model)
    res = model.get("grid_resolution")
    p_full = grid_points(d["L"], d["L"], res)
    p_red = grid_points(d["L"], d["M"], res)
    sites = ([(n_pad, d["Kf"], d["Fh"], p_full, compute)] * model["num_layers"]
             + [(e_pad, d["Kr"], d["H"], p_red, compute)] * model["num_layers"]
             + [(model["num_targets"] * n_pad, d["Kf"], d["Fh"], p_full, "float32")])
    kernels = "ab" if mode == "train" else "a"
    return [_s2(*s, *_K2[k]) for s in sites for k in kernels]


def _so2conv_sites(model: dict) -> list[tuple[int, int, int]]:
    """(Cin, Cout, extra) of a layer's two K3 sites."""
    d = _dims(model)
    return [(2 * d["C"], d["H"], d["heads"] * d["A"] + d["H"]), (d["H"], d["O"], 0)]


def _k3_weights(d: dict, cin: int, cout: int, extra: int) -> int:
    L0 = d["L0"]
    n = L0 * cin * (extra + L0 * cout)
    for m in range(1, d["M"] + 1):
        n += (2 * (L0 - m)) ** 2 * cin * cout
    return n


def so2conv_ops(model: dict, outputs: dict, mode: str, compute: str, n_pad: int,
                e_pad: int) -> list[Op]:
    """K3's calls of one step (``mode="train"``: forward and adjoint) or
    request (the forward)."""
    d = _dims(model)
    E, K, nb = e_pad, d["Kr"], BYTES[compute]
    route = "bf16" if compute == "bfloat16" else "f32_tc"
    out = []
    for cin, cout, extra in _so2conv_sites(model) * model["num_layers"]:
        w = _k3_weights(d, cin, cout, extra)
        flops = 2.0 * E * w
        fwd = nb * (E * K * cin + E * K * cout + E * extra + w)
        adj = nb * (E * K * cout + E * extra + E * K * cin + w)
        out.append(Op(fwd, flops, route))
        if mode == "train":
            out.append(Op(adj, flops, route))
    return out


def forward_flops(model: dict, outputs: dict, n: int, e: int) -> float:
    """Products of one forward on ``n`` atoms and ``e`` edges: the
    edge-degree embedding, each layer's baseline attention and FFN, and the
    stacked heads (``counts/ops.py``'s per-site counts)."""
    d = _dims(model)
    res = model.get("grid_resolution")
    p_full = grid_points(d["L"], d["L"], res)
    p_red = grid_points(d["L"], d["M"], res)
    f = _rad(e, d, d["L0"] * d["C"]) + 2.0 * e * d["Kf"] * d["C"]
    for _ in range(model["num_layers"]):
        f += _attention(n, e, d, False, p_red, d["C"])
        f += _ffn(n, d, p_full, d["C"])
    return f + model["num_targets"] * _ffn(n, d, p_full, 1)


def model_flops(model: dict, outputs: dict, mode: str, n: int, e: int) -> float:
    """The forward times 3 for a training step (first order), 1 a request."""
    return (3.0 if mode == "train" else 1.0) * forward_flops(model, outputs, n, e)
