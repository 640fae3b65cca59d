"""``hyp.loss_modification`` and ``hyp.label_smoothing``: the port's
``get_loss_fn`` (``fullbatchtraining_tpu_torch/models/modules.py``) against
the JAX package's (``fullbatchtraining_tpu/models/modules.py``), in float64
on the same logits and labels, at 1e-12 relative.

Every modification (none, ``incorrect-xent``, ``maxup``, ``maxup-N``,
``batch-maxup``) with and without label smoothing, at three batch sizes.
Where the batch is no multiple of a maxup's ``ntrials`` both packages raise
(JAX a ``TypeError`` from its reshape, the port a ``RuntimeError``); a
maxup with label smoothing raises ``ValueError`` in both.
"""

import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullbatchtraining_tpu.models.modules import get_loss_fn as jax_get_loss_fn
from fullbatchtraining_tpu_torch.models.modules import get_loss_fn

RTOL = 1e-12
MODIFICATIONS = [None, "incorrect-xent", "maxup", "maxup-3", "batch-maxup"]
SMOOTHING = [0.0, 0.1]
BATCHES = [30, 12, 20]
BATCH_SIZE = 6   # data.batch_size: batch-maxup's ntrials
CASES = list(itertools.product(MODIFICATIONS, SMOOTHING, BATCHES))


def _ntrials(modification):
    return {"maxup": 10, "maxup-3": 3, "batch-maxup": BATCH_SIZE}.get(modification)


@pytest.mark.parametrize("modification,smoothing,batch", CASES,
                         ids=[f"{m}-{s}-{b}" for m, s, b in CASES])
def test_loss_matches_jax(modification, smoothing, batch):
    hyp = SimpleNamespace(loss_modification=modification, label_smoothing=smoothing)
    rng = np.random.default_rng(batch)
    logits = rng.standard_normal((batch, 10)) * 3
    labels = rng.integers(0, 10, batch)
    ntrials = _ntrials(modification)
    if ntrials and smoothing:
        for make in (jax_get_loss_fn, get_loss_fn):
            with pytest.raises(ValueError, match="label smoothing"):
                make(hyp, BATCH_SIZE)
        return
    with jax.enable_x64(True):
        jax_fn = jax_get_loss_fn(hyp, BATCH_SIZE)
        fn = get_loss_fn(hyp, BATCH_SIZE)
        if ntrials and batch % ntrials:
            with pytest.raises(TypeError):
                jax_fn(jnp.asarray(logits), jnp.asarray(labels))
            with pytest.raises(RuntimeError):
                fn(torch.from_numpy(logits), torch.from_numpy(labels))
            return
        ref = float(jax_fn(jnp.asarray(logits), jnp.asarray(labels)))
    ours = fn(torch.from_numpy(logits), torch.from_numpy(labels))
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.item(), ref, rtol=RTOL)
    if modification == "incorrect-xent":   # some samples are right, some wrong
        correct = logits.argmax(-1) == labels
        assert correct.any() and not correct.all()
