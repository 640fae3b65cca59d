"""ResNet-20 under every norm of the zoo (GhostBatchNorm with even and uneven
virtual batches, GroupNorm in each form, LayerNorm, InstanceNorm, none),
SkipInit ResNets with both pre-activation shortcuts and the
``Standardized`` convolution against the flax models: the cases of
``tests/test_torch_families.py`` built on ResNets, held there the same way
(float64; logits, running stats and eval logits at rtol 1e-10, the
gradient at 1e-9).
"""

import pytest

from test_torch_families import NORM_CASES, check_case
from test_torch_training_stochastic import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("case", NORM_CASES)
def test_norm_matches_flax(case, monkeypatch):
    check_case(case, monkeypatch)
