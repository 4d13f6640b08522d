"""FLOP and byte counts for the rooflines and the MFU.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
HBM 3.35 TB/s; bf16 989 TFLOP/s; TF32 495 TFLOP/s, so float32-accurate
products on the tensor cores (3xTF32) 165 TFLOP/s; float32 outside the
tensor cores (FFMA) 67 TFLOP/s.

Roofline bounds (``rotation_ops``, ``s2act_ops``) count the work one step or
request needs of the operation at the padded shapes the kernels receive:
each input read once and each output written once, the same count whatever
kernel implements it.

* Rotation (the per-edge Wigner rotation between the global and the edge
  frame): bytes of the features in and out; 2 FLOP per nonzero of the
  block-diagonal Wigner matrix (restricted to the rows and columns the
  operation needs) per channel; route FFMA.  The edge-degree embedding's
  input has only its m = 0 rows, so it counts as the m = 0 rotation.
* S2 activation ``from_grid(silu(to_grid(x)))`` on [rows, K, C] with P grid
  points: the forward (K2a) reads x and writes y, 2 products of 2 P K FLOP
  per row and channel; its adjoint (K2b) reads x and the output gradient,
  writes one gradient, 3 products; its second derivative (K2c) reads three,
  writes two, 5 products.  Bytes add the two float32 tables.  Route: bf16 at
  989 TFLOP/s, float32 on 3xTF32.

Passes follow from the configuration's ``outputs`` and the mode: a request
runs the forward, and with forces by autograd the force backward too (each
operation and its adjoint: the S2 activation K2a + K2b); training adds the
loss backward through all of that (each rotation twice more; K2b + K2c
behind a force backward).  So 1 / 2 passes a request (force head / forces by
autograd) and 2 / 4 a training step.

Model FLOPs (``model_flops``) count the products of one forward on the real
atoms and edges (dense, einsum, per-degree and SO(2) maps, rotations, grid
transforms; elementwise work and the stress's strain are not counted), as the
configuration's switches shape it (``gata``, ``use_phi_every_layer``, a force
head), times the FLOP passes: a request 1 or 2 (the force backward is by the
input alone), a training step 1.5x its operation passes (the loss backward is
by input and weights): 3 with a force head, 6 with forces by autograd.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "Op", "bound_seconds", "rotation_ops",
           "s2act_ops", "forward_flops", "model_flops", "op_passes", "grid_points"]

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"ffma": 67e12, "f32_tc": 495e12 / 3, "bf16": 989e12}
# the whole step's peak by compute type (MFU)
MFU_PEAK = {"bfloat16": 989e12, "float32": 67e12}
BYTES = {"bfloat16": 2, "float32": 4}


def op_passes(outputs: dict, mode: str) -> int:
    """How often a step (``mode="train"``) or a request runs each operation."""
    n = 2 if outputs["forces"] == "gradient" else 1
    return 2 * n if mode == "train" else n


def _gata(model: dict) -> bool:
    return bool(model.get("gata", True))     # the program's default


@dataclass(frozen=True)
class Op:
    bytes: float
    flops: float
    route: str

    def seconds(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / PEAK_FLOPS[self.route])


def bound_seconds(ops) -> float:
    return sum(op.seconds() for op in ops)


def _kept(l: int, mmax: int) -> int:
    return 2 * min(l, mmax) + 1


def _dims(m: dict) -> dict:
    L, M = m["lmax"], m["mmax"]
    return dict(L=L, M=M, Kf=(L + 1) ** 2, Kr=sum(_kept(l, M) for l in range(L + 1)),
                L0=L + 1, P_to=sum(_kept(l, M) * (2 * l + 1) for l in range(L + 1)),
                C=m["sphere_channels"], H=m["attn_hidden_channels"], heads=m["num_heads"],
                A=m["attn_alpha_channels"], O=m["num_heads"] * m["attn_value_channels"],
                Fh=m["ffn_hidden_channels"], R=m["num_rbf"], Ec=m["edge_channels"])


def grid_points(lmax: int, mmax: int, resolution) -> int:
    if resolution is not None:
        return int(resolution) ** 2
    return 2 * (lmax + 1) * (2 * mmax + 1 + (2 if lmax == mmax else 0))


def _rot(rows: int, k_in: int, k_out: int, c: int, pairs: int, dtype: str) -> Op:
    return Op(BYTES[dtype] * rows * (k_in + k_out) * c, 2.0 * rows * pairs * c, "ffma")


def rotation_ops(model: dict, outputs: dict, mode: str, compute: str, n_pad: int,
                 e_pad: int) -> list[Op]:
    """The rotations of one step (``mode="train"``) or request (``"serve"``)."""
    d = _dims(model)
    E, C, cdt = e_pad, d["C"], compute
    # the edge-degree embedding: float32, m = 0 input rows
    sites = [_rot(E, d["L0"], d["Kf"], C, d["Kf"], "float32")]
    for _ in range(model["num_layers"]):
        if _gata(model):   # GATA: only the m = 0 rows are rotated in
            sites.append(_rot(E, d["Kf"], d["L0"], 2 * C, d["Kf"], cdt))
        else:
            sites.append(_rot(E, d["Kf"], d["Kr"], 2 * C, d["P_to"], cdt))
        sites.append(_rot(E, d["Kr"], d["Kf"], d["O"], d["P_to"], cdt))
    if outputs["forces"] == "head":   # the force head reads the float32 backbone output
        sites.append(_rot(E, d["Kf"], d["Kr"], 2 * C, d["P_to"], "float32"))
        sites.append(_rot(E, d["Kr"], d["Kf"], d["O"], d["P_to"], "float32"))
    return sites * op_passes(outputs, mode)


def _s2(rows: int, K: int, C: int, P: int, dtype: str, n_in: int, n_out: int,
        products: int) -> Op:
    flops = 2.0 * products * P * K * rows * C
    nbytes = BYTES[dtype] * (n_in + n_out) * rows * K * C + 2 * 4 * P * K
    if dtype == "bfloat16":
        return Op(nbytes, flops, "bf16")
    return Op(nbytes, flops, "f32_tc")


# (inputs, outputs, products) of K2a, K2b, K2c
_K2 = {"a": (1, 1, 2), "b": (2, 1, 3), "c": (3, 2, 5)}


def s2act_ops(model: dict, outputs: dict, mode: str, compute: str, n_pad: int,
              e_pad: int) -> list[Op]:
    """The S2 activations of one step or request."""
    d = _dims(model)
    res = model.get("grid_resolution")
    p_full = grid_points(d["L"], d["L"], res)
    p_red = grid_points(d["L"], d["M"], res)
    # (rows, K, C, P, dtype) per site
    sites = [(n_pad, d["Kf"], d["Fh"], p_full, compute)] * model["num_layers"]
    sites = sites + [(n_pad, d["Kf"], d["Fh"], p_full, "float32")]      # energy head
    if not _gata(model):   # the baseline attention's separable S2 on the edges
        sites += [(e_pad, d["Kr"], d["H"], p_red, compute)] * model["num_layers"]
    if outputs["forces"] == "head":
        sites += [(e_pad, d["Kr"], d["H"], p_red, "float32")]             # force head
    # K2a in the forward; K2b behind each backward of it; K2c where a loss
    # backward runs through a force backward
    kernels = {1: "a", 2: "ab", 4: "abbc"}[op_passes(outputs, mode)]
    return [_s2(*s, *_K2[k]) for s in sites for k in kernels]


def _rad(e: int, d: dict, out: int) -> float:
    D = d["R"] + 2 * d["Ec"]
    return 2.0 * e * (D * d["Ec"] + d["Ec"] ** 2 + d["Ec"] * out)


def _conv(e: int, d: dict, cin: int, cout: int, extra: int, m0_only: bool) -> float:
    L0 = d["L0"]
    f = 2.0 * e * (L0 * cin) * (extra + (0 if m0_only else L0 * cout))
    if not m0_only:
        for m in range(1, d["M"] + 1):
            Lm = L0 - m
            f += 8.0 * e * Lm * Lm * cin * cout
    return f


def _ffn(n: int, d: dict, p: int, cout: int) -> float:
    Kf, C, Fh = d["Kf"], d["C"], d["Fh"]
    return 2.0 * n * (C * Fh + Kf * C * Fh + 2 * p * Kf * Fh + Kf * Fh * cout)


def _attention(n: int, e: int, d: dict, gata: bool, p_red: int, cout: int,
               phi: bool = False) -> float:
    C, H, heads, A, O, Kf, Kr, L0 = (d[k] for k in ("C", "H", "heads", "A", "O", "Kf", "Kr",
                                                    "L0"))
    n_rad = sum(L0 - m for m in range(d["M"] + 1)) * 2 * C
    f = _rad(e, d, n_rad) + 2.0 * e * heads * A
    if gata:
        S = 1 + 2 * d["L"]
        f += 2.0 * e * Kf * 2 * C                                    # rotation, m = 0 rows
        f += _conv(e, d, 2 * C, H, heads * A + S * H, True)
        f += 2.0 * e * (d["Ec"] * S * H + C * S * H + (Kf - 1) * C * H)   # value activation
        if phi:
            f += 2.0 * e * d["R"] * S * H                            # phi_proj
    else:
        f += 2.0 * e * d["P_to"] * 2 * C                             # rotation
        f += _conv(e, d, 2 * C, H, heads * A + H, False)
        f += 4.0 * e * p_red * Kr * H                                # S2 on the edges
    f += _conv(e, d, H, O, 0, False)
    f += 2.0 * e * d["P_to"] * O                                     # rotation back
    f += 2.0 * n * Kf * O * cout                                     # proj
    return f


def forward_flops(model: dict, outputs: dict, n: int, e: int) -> float:
    """Products of one forward on ``n`` atoms and ``e`` edges."""
    d = _dims(model)
    res = model.get("grid_resolution")
    p_full = grid_points(d["L"], d["L"], res)
    p_red = grid_points(d["L"], d["M"], res)
    gata = _gata(model)
    phi = gata and bool(model.get("use_phi_every_layer", False))
    Ec, C, Kf = d["Ec"], d["C"], d["Kf"]
    f = _rad(e, d, d["L0"] * C) + 2.0 * e * Kf * C                  # edge-degree embedding
    if gata:
        f += 2.0 * e * (C * Ec + d["R"] * Ec)                        # h_proj, W_erp
    for _ in range(model["num_layers"]):
        if gata:   # HTR
            f += 2.0 * e * (2 * (Kf - 1) * C * Ec + 3 * (Kf - 1) * Ec + 3 * Ec * Ec)
        f += _attention(n, e, d, gata, p_red, C, phi)
        f += _ffn(n, d, p_full, C)
    f += _ffn(n, d, p_full, 1)                                       # energy head
    if outputs["forces"] == "head":
        f += _attention(n, e, d, False, p_red, 1)                    # force head
    return f


def model_flops(model: dict, outputs: dict, mode: str, n: int, e: int) -> float:
    """Model FLOPs of one step or request: the forward times its FLOP passes."""
    passes = op_passes(outputs, mode) * (1.5 if mode == "train" else 1.0)
    return passes * forward_flops(model, outputs, n, e)
