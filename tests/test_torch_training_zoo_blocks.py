"""The optimizer zoo in the port's ``train()`` against the JAX package's:
full-batch AdamW under LARC, and L-BFGS per block in stochastic mode, one
driver run per block against that block's gradient, the lr fixed within the
epoch (``tests/test_torch_training_stochastic.py`` sets up the comparison:
fp64, width 4, 3 steps, rtol 1e-8; torch on one intra-op thread)."""

import pytest

from test_torch_training_stochastic import check_stochastic_case
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

CASES = {
    "adam-larc": ["hyp=fb1", "hyp/optim=adam", "hyp/optim_modification=LARC"],
    "lbfgs-blocks": ["hyp=base_sgd", "hyp/optim=lbfgs"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_zoo_train_matches_jax(case, config_dir, monkeypatch):
    stats = check_stochastic_case(CASES[case], config_dir, monkeypatch)
    assert ("lbfgs_t" in stats) == (case == "lbfgs-blocks")
