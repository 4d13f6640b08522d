"""The composite step at (data, model) = (2, 2): 4 gloo ranks (spawned once
for the file), both process groups at once: each data row runs its own
micro-batch, TP (and with ``sp`` SP, fixed-degree or ragged) over its two
model ranks, and the rows average over their ``data`` columns.  Held against the JAX package's
unsharded math (tests/torch_sharding_helpers.py: the mean over the two
micro-batches of the force loss, one optax step) within the limits of
tests/test_torch_sharding.py.
"""

import pytest
import torch

import torch_parallel_helpers as H
import torch_sharding_helpers as S
import torch_variant_helpers as V


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_tp")
    made = {sp: S.case(2, sp, n_micro=2, seed=11) for sp in (False, True)}
    made["ragged"] = S.case(2, True, n_micro=2, seed=11, layout="ragged")
    cases = {f"sp={sp}": c for sp, (c, _, _) in made.items()}
    procs = H.start(H.composite_worker, 4, 4, H.free_port(), str(out), cases, 1, False)
    refs = {}
    for sp in (False, "ragged"):   # sp on and off: the same fixed-degree reference
        case, jm, params = made[sp]
        refs[sp] = S.jax_reference(jm, params, case["batches"])
    refs[True] = refs[False]
    codes = H.join(procs)
    assert codes == [0, 0, 0, 0], f"rank exit codes {codes}"
    return refs, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]


@pytest.mark.parametrize("sp", [False, True, "ragged"])
def test_data_2_model_2_matches_jax(sp, ranks):
    refs, results = ranks
    want, got = refs[sp], results[0][f"sp={sp}"]
    err_l = abs(got["loss"] / want["loss"] - 1)
    err_g = V.rel_l2(got["grads"], want["grads"])
    print(f"(2, 2) sp={sp}: loss {err_l:.2e}, gradients {err_g:.2e}")   # pytest -s
    assert err_l <= 2e-5 and err_g <= 1e-4, (err_l, err_g)
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    for part in ("params", "ema"):
        assert got[part].keys() == want[part].keys()
        for k, v in got[part].items():
            # as tests/test_torch_sharding.py: lr where the reference
            # gradient is rounding noise of an exact zero
            noise = want["grads"][k].abs() <= 1e-6 * gmax
            atol = torch.where(noise, 1.01 * S.LR, 1e-2 * S.LR)
            assert torch.all((v - want[part][k]).abs() <= atol), f"{part} {k}"


@pytest.mark.parametrize("sp", [False, True, "ragged"])
def test_all_four_ranks_agree(sp, ranks):
    """Every rank of both data rows gathers the same state and loss, bit for
    bit."""
    _, results = ranks
    name = f"sp={sp}"
    for r in results[1:]:
        assert r[name]["loss"] == results[0][name]["loss"]
        for key in ("params", "ema"):
            for k, v in results[0][name][key].items():
                assert torch.equal(r[name][key][k], v), (key, k)
