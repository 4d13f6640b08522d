"""The reference weight importer (the port's utils/port.py) against the JAX
package's.

``reference_state_dict`` (below) turns a Flax params tree into a
state_dict named and laid out as the reference PyTorch EquiformerV2's: the
inverse of the JAX package's utils/port.py.  It is proved first: the JAX
package's ``port_matpes_model`` / ``port_qm9_model`` of it return the Flax
tree exactly.  Then the port's importers, on the same reference
state_dict, give the port's ``convert(flax)`` bit for bit
(utils/convert.py), load with ``strict=True``, and the port's MatPES and
QM9 models built from them match the JAX models' energies and forces /
predictions within 1e-6 relative L2 (float32 sums in another order: the
largest force differs by 1.1e-6 of the largest force).  Models: the
GATA-V2 MatPES and the QM9 EquiformerV2 at 2 layers, 8 channels, lmax 2 /
mmax 1, random Flax params made by numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_variant_helpers as V
from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    EquiformerV2MatPES as JaxMatPES,
    matpes_energy_forces_stress,
)
from equivarianttransformermpnn4quantumcomputations_tpu.models.qm9 import (
    EquiformerV2QM9 as JaxQM9,
)
from equivarianttransformermpnn4quantumcomputations_tpu.utils import port as jport
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
    matpes_energy_forces,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.qm9 import (
    EquiformerV2QM9,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils import port
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flatten,
    flax_to_state_dict,
)

WIDTHS = dict(num_layers=2, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
              attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=16,
              lmax=2, mmax=1, grid_resolution=None, edge_channels=8, num_rbf=16,
              max_num_elements=10, cutoff=5.0, alpha_drop=0.0, drop_path_rate=0.0)
QM9_TARGETS = 3
LAYOUT = dict(fixed_degree=True, uniform_blocks=True, wigner_rep="dense")
ARGS = dict(lmax=2, mmax=1, num_layers=2)


# ── the inverse of the JAX package's utils/port.py ──────────────────────────

def _linear(tree: dict, key: str) -> dict:
    out = {f"{key}.weight": np.asarray(tree["kernel"]).T}
    if "bias" in tree:
        out[f"{key}.bias"] = np.asarray(tree["bias"])
    return out


def _so3(tree: dict, key: str) -> dict:
    return {f"{key}.weight": np.transpose(np.asarray(tree["weight"]), (0, 2, 1)),
            f"{key}.bias": np.asarray(tree["bias"])}


def _radial(tree: dict, key: str) -> dict:
    """Dense_i / LayerNorm_i -> the Sequential net.{3 i} / net.{3 i + 1}."""
    out = {}
    for name, sub in tree.items():
        kind, i = name.split("_")
        j = 3 * int(i) + (kind == "LayerNorm")
        w = sub["kernel"].T if kind == "Dense" else sub["scale"]
        out[f"{key}.net.{j}.weight"], out[f"{key}.net.{j}.bias"] = np.asarray(w), sub["bias"]
    return out


def _so2(tree: dict, key: str) -> dict:
    out = {f"{key}.fc_m0.weight": np.asarray(tree["w_m0"]).T,
           f"{key}.fc_m0.bias": np.asarray(tree["b_m0"])}
    m = 1
    while f"w_m{m}_r" in tree:
        out[f"{key}.so2_m_conv.{m - 1}.fc.weight"] = np.concatenate(
            [np.asarray(tree[f"w_m{m}_r"]).T, np.asarray(tree[f"w_m{m}_i"]).T], 0)
        m += 1
    if "RadialMLP_0" in tree:
        out.update(_radial(tree["RadialMLP_0"], f"{key}.rad_func"))
    return out


def _norm(tree: dict, key: str) -> dict:
    return {f"{key}.affine_weight": np.asarray(tree["weight"]),
            f"{key}.affine_bias": np.asarray(tree["bias"])}


def _ffn(tree: dict, key: str) -> dict:
    return {**_so3(tree["so3_linear_1"], f"{key}.so3_linear_1"),
            **_so3(tree["so3_linear_2"], f"{key}.so3_linear_2"),
            **_linear(tree["gating_linear"], f"{key}.gating_linear")}


def _embeds(tree: dict, key: str) -> dict:
    return {f"{key}.source_embedding.weight": np.asarray(tree["Embed_0"]["embedding"]),
            f"{key}.target_embedding.weight": np.asarray(tree["Embed_1"]["embedding"])}


def _block(tree: dict, key: str, lmax: int) -> dict:
    ga = tree["ga"]
    out = {**_norm(tree["EquivariantRMSNormSH_0"], f"{key}.norm_1"),
           **_norm(tree["EquivariantRMSNormSH_1"], f"{key}.norm_2"),
           **_ffn(tree["ffn"], f"{key}.ffn"), **_embeds(ga, f"{key}.ga"),
           **_so2(ga["so2_conv_1"], f"{key}.ga.so2_conv_1"),
           **_so2(ga["so2_conv_2"], f"{key}.ga.so2_conv_2"),
           f"{key}.ga.alpha_norm.weight": np.asarray(ga["alpha_norm"]["scale"]),
           f"{key}.ga.alpha_norm.bias": np.asarray(ga["alpha_norm"]["bias"]),
           f"{key}.ga.alpha_dot": np.asarray(ga["alpha_dot"]),
           **_so3(ga["proj"], f"{key}.ga.proj")}
    if "value_act" in ga:
        va = ga["value_act"]
        out.update({**_linear(va["W_rs"], f"{key}.ga.value_act.W_rs"),
                    **_linear(va["gamma_s"], f"{key}.ga.value_act.gamma_s.0"),
                    **_linear(va["xj_proj"], f"{key}.ga.value_act.xj_proj")})
    if "htr" in tree:
        htr = tree["htr"]
        out.update({**_linear(htr["W_vq"], f"{key}.htr.W_vq"),
                    **_linear(htr["gamma_w"], f"{key}.htr.gamma_w.0"),
                    **_linear(htr["gamma_t_1"], f"{key}.htr.gamma_t.0"),
                    **_linear(htr["gamma_t_2"], f"{key}.htr.gamma_t.2")})
        for l in range(1, lmax + 1):
            out.update(_linear(htr[f"W_vk_{l}"], f"{key}.htr.W_vk.{l - 1}"))
    return out


def reference_state_dict(params, lmax: int) -> dict:
    """A Flax params tree of the JAX package's MatPES (GATA-V2) or QM9
    model (``scan_layers=False``) -> the reference's state_dict names and
    layouts."""
    tree = params.get("params", params)
    bb = tree["backbone"]
    out = {"sphere_embedding.weight": np.asarray(bb["sphere_embedding"]["embedding"]),
           **_embeds(bb["edge_degree_embedding"], "edge_degree_embedding"),
           **_radial(bb["edge_degree_embedding"]["RadialMLP_0"],
                     "edge_degree_embedding.rad_func"),
           **_norm(bb["EquivariantRMSNormSH_0"], "norm")}
    for key in ("W_erp", "h_proj"):
        if key in bb:
            out.update(_linear(bb[key], key))
    i = 0
    while f"block_{i}" in bb:
        out.update(_block(bb[f"block_{i}"], f"blocks.{i}", lmax))
        i += 1
    if "energy_block" in tree:
        out.update(_ffn(tree["energy_block"], "energy_block"))
    if "output_blocks" in tree:
        heads = tree["output_blocks"]
        n = np.asarray(heads["so3_linear_1"]["weight"]).shape[0]
        for t in range(n):
            head = jax.tree_util.tree_map(lambda a: np.asarray(a)[t], heads)
            out.update(_ffn(head, f"output_blocks.{t}"))
    return out


# ── the models ──────────────────────────────────────────────────────────────

def _batches(periodic: bool):
    rng = np.random.default_rng(3)
    samples = []
    for n in (4, 6, 5):
        cell = (np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1).astype(np.float32)
        samples.append(tgraph.GraphSample(
            atomic_numbers=rng.integers(1, 9, size=n).astype(np.int32),
            pos=((rng.uniform(0, 1, size=(n, 3)) @ cell) if periodic
                 else rng.uniform(0, 3.0, size=(n, 3))).astype(np.float32),
            cell=cell if periodic else None, pbc=periodic))
    pb = tgraph.collate(samples, 5.0, 6, 18, 108, fixed_degree=True)
    return {k: jnp.asarray(v) for k, v in pb.asdict().items()}, tgraph.as_tensors(pb, "cpu")


def _jax_model(kind: str):
    if kind == "matpes":
        return JaxMatPES(**WIDTHS, **LAYOUT, gata=True)
    return JaxQM9(**{k: v for k, v in WIDTHS.items() if k != "max_num_elements"}, **LAYOUT,
                  num_targets=QM9_TARGETS)


def _port_model(kind: str):
    if kind == "matpes":
        return EquiformerV2MatPES(**WIDTHS, gata=True)
    return EquiformerV2QM9(**{k: v for k, v in WIDTHS.items() if k != "max_num_elements"},
                           num_targets=QM9_TARGETS)


def _import(kind: str, ref: dict, importer) -> dict:
    if kind == "matpes":
        return importer.port_matpes_model(ref, **ARGS, gata=True)
    return importer.port_qm9_model(ref, **ARGS, num_targets=QM9_TARGETS)


@pytest.fixture(scope="module", params=["matpes", "qm9"])
def case(request):
    kind = request.param
    jb, tb = _batches(kind == "matpes")
    jm = _jax_model(kind)
    params = V.random_flax_params(jm, jb, 11)
    return kind, jm, params, reference_state_dict(params, ARGS["lmax"]), jb, tb


def test_inverse_roundtrips_through_the_jax_importer(case):
    """The helper is the inverse of the JAX importer: JAX ``port_*`` of the
    reference-named dict is the Flax tree, leaf for leaf."""
    kind, _, params, ref, _, _ = case
    back = _import(kind, ref, jport)
    want, got = flatten(params["params"]), flatten(back["params"])
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    # the reference dict uses every Flax leaf once
    assert sum(a.size for a in ref.values()) == sum(a.size for a in want.values())


def test_port_importer_equals_convert_of_the_jax_importer(case):
    """The port's ``port_*`` equals utils/convert.py of JAX ``port_*``, bit
    for bit, and loads with ``strict=True``."""
    kind, _, _, ref, _, _ = case
    got = _import(kind, ref, port)
    want = flax_to_state_dict(_import(kind, ref, jport))
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    _port_model(kind).load_state_dict(got, strict=True)


def test_imported_model_matches_jax(case):
    """The port's model loaded from the reference dict against the JAX
    model on the Flax tree: MatPES energies and forces, QM9 predictions,
    within 1e-6 relative L2."""
    kind, jm, params, ref, jb, tb = case
    model = _port_model(kind)
    model.load_state_dict(_import(kind, ref, port), strict=True)
    model.eval()
    if kind == "matpes":
        want = V.run_jax(lambda p, b: matpes_energy_forces_stress(jm, p, b), params, jb)
        got = matpes_energy_forces(model, tb)
        pairs = [("energy", got["energy"], want["energy"]),
                 ("forces", got["forces"], want["forces"])]
    else:
        want = V.run_jax(lambda p, b: jm.apply(p, b), params, jb)
        with torch.no_grad():
            pairs = [("predictions", model(tb), want)]
    for name, g, w in pairs:
        w = np.asarray(w, np.float64)
        d = g.detach().numpy().astype(np.float64) - w
        err = float(np.linalg.norm(d) / np.linalg.norm(w))
        print(f"{kind} {name}: rel L2 err {err:.2e}, max |diff| / max |value| "
              f"{np.abs(d).max() / np.abs(w).max():.2e}")   # pytest -s
        assert err <= 1e-6, (name, err)
