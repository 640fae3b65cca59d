"""``hyp.train_switch_stochastic`` and a shuffled full-batch epoch in the
port's ``train()`` against the JAX package's
(``tests/test_torch_training_stochastic.py`` sets up the comparison)."""

import pytest

from test_torch_training_stochastic import check_stochastic_case
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)

CASES = {
    # step 0 stochastic, steps 1 and 2 full-batch
    "switch": ["hyp=base_sgd", "hyp.train_switch_stochastic=1"],
    "fb1-shuffled": ["hyp=fb1", "hyp.shuffle=True"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_stochastic_train_matches_jax(case, config_dir, monkeypatch):
    check_stochastic_case(CASES[case], config_dir, monkeypatch)
