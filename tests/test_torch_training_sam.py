"""SAM in the port's ``train()`` against the JAX package's: its stochastic
body and its full-batch step (``tests/test_torch_training_stochastic.py``
sets up the comparison)."""

import pytest

from test_torch_training_stochastic import check_stochastic_case
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

CASES = {
    "sam-stochastic": ["hyp=base_sgd", "hyp/optim_modification=SAM"],
    # two full passes a step; the EMA updates after the SAM step
    "sam-full-batch": ["hyp=base_sgd", "hyp/optim_modification=SAM",
                       "hyp.train_stochastic=False", "hyp.evaluate_ema=True",
                       "hyp.eval_ema_momentum=0.5"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_stochastic_train_matches_jax(case, config_dir, monkeypatch):
    check_stochastic_case(CASES[case], config_dir, monkeypatch)
