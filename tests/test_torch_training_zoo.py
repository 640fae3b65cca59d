"""The optimizer zoo in the port's ``train()`` against the JAX package's:
full-batch L-BFGS (Wolfe, history 10) and full-batch Wolfe gradient descent,
each driver evaluating the full-batch gradient as often as its search needs
(``tests/test_torch_training_stochastic.py`` sets up the comparison: fp64,
width 4, 3 steps, rtol 1e-8, the stats keys equal, ``lbfgs_t`` and
``wolfe_alpha`` included; torch on one intra-op thread)."""

import pytest

from test_torch_training_stochastic import check_stochastic_case
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

CASES = {
    "lbfgs": ["hyp=fb1", "hyp/optim=lbfgs"],
    "wolfe": ["hyp=fb1", "hyp.optim.line_search=wolfe"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_zoo_train_matches_jax(case, config_dir, monkeypatch):
    stats = check_stochastic_case(CASES[case], config_dir, monkeypatch)
    assert ("lbfgs_t" in stats) == (case == "lbfgs")
    assert ("wolfe_alpha" in stats) == (case == "wolfe")
