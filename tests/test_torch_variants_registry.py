"""The port's model registry against the JAX package's, and the backbone
options of the QM9, OC20 and MatPES models on the CPU.

``list_models()`` names the same 16 entries.  GATA v1's two checks raise
with the JAX package's messages.  The QM9 and OC20 entries (their default
configurations are held in tests/test_torch_qm9.py and
tests/test_torch_oc20.py) and MatPES models, with the backbone options no
registry preset sets (the other norms,
the gate / plain S2 / grid-MLP activations, m-share radial, no alpha
norm, shared or no atom-edge embeddings), match the JAX models from the
same converted weights at a small size (1 layer, lmax 2 / mmax 1, 8
channels): predictions, energies and forces within 1e-5 relative.
"""

import jax
import pytest

from equivarianttransformermpnn4quantumcomputations_tpu.models import registry as jregistry
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models import registry

import torch_variant_helpers as h


def test_list_models_matches_jax():
    assert registry.list_models() == jregistry.list_models()
    assert len(registry.list_models()) == 16


@pytest.mark.parametrize("bad,message", [
    (dict(mmax=1), "gata_v1 requires mmax == lmax"),
    (dict(mmax=2, attn_hidden_channels=12), "gata_v1 requires attn_hidden_channels == "
                                             "sphere_channels"),
], ids=["mmax", "hidden"])
def test_gata_v1_checks_raise_like_jax(bad, message):
    name = "equiformer_v2_matpes_gata"
    cfg = {**h.small_cfg(name), **bad}
    with pytest.raises(ValueError, match=message) as port_err:
        registry.make_model(name, **cfg)
    jb, _ = h.batches()
    jm = jregistry.make_model(name, **cfg, **h.JAX_LAYOUT)
    with pytest.raises(ValueError, match=message) as jax_err:
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb))
    assert str(port_err.value) == str(jax_err.value)


OPTIONS = {
    "qm9-layer_norm-gate-m_share-no_renorm": ("equiformer_v2_qm9", dict(
        norm_type="layer_norm", use_gate_act=True, use_m_share_rad=True,
        use_attn_renorm=False)),
    "oc20-layer_norm_sh-grid_mlp-shared_embedding": ("equiformer_v2_oc20", dict(
        norm_type="layer_norm_sh", use_grid_mlp=True, share_atom_edge_embedding=True)),
    "matpes-s2-no_atom_edge": ("equiformer_v2_matpes", dict(
        use_sep_s2_act=False, use_atom_edge_embedding=False)),
    "gatav2-grid_mlp_plain-m_share-shared_embedding": ("equiformer_v2_matpes_gatav2", dict(
        use_grid_mlp=True, use_sep_s2_act=False, use_m_share_rad=True,
        share_atom_edge_embedding=True)),
}


@pytest.mark.parametrize("case", list(OPTIONS))
def test_entry_with_options_matches_jax(case):
    name, opts = OPTIONS[case]
    if "matpes" in name:
        errs = h.energy_forces_errors(name, seed=3, jax_kw=opts)
    else:
        jb, tb = h.batches(seed=3)
        if name == "equiformer_v2_qm9":
            jb = {k: v for k, v in jb.items() if k not in ("energy", "forces")}
        jm = h.jax_model(name, **opts)
        params = h.random_flax_params(jm, jb, 4)
        with flags.override(wigner="dense"):
            want = h.run_jax(lambda p, b: jm.apply(p, b), params, jb)
        model = h.port_model(name, params, **opts, **(
            dict(wigner_rep="dense") if name == "equiformer_v2_oc20" else {}))
        got = model(tb)
        if name == "equiformer_v2_qm9":
            errs = {"predictions": h.rel(got.detach().numpy(), want)}
        else:
            errs = {k: h.rel(got[k].detach().numpy(), want[k]) for k in ("energy", "forces")}
    print(case, errs)
    assert all(v <= 1e-5 for v in errs.values()), errs
