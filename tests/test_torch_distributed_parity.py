"""The port's 2-rank ``train()`` against the JAX package's on a 2-device
mesh, in float64 at rtol 1e-8: ``fb1`` with clipping, EMA evaluation and
test-time flips; ``gradreg`` with ``acc_strength`` on shuffled epochs;
stochastic SGD with SAM. ``tests/test_torch_distributed.py`` sets up the
comparison (:func:`check_jax_case`)."""

import pytest

from test_torch_distributed import FB, SGD, check_jax_case

JAX_CASES = {
    # per-chunk and full-gradient clipping, EMA evaluation, test-time flips
    "fb1": FB + ["hyp=fb1", "hyp.batch_clip=0.9", "hyp.grad_clip=0.5", "hyp.evaluate_ema=True",
                 "hyp.eval_ema_momentum=0.5", "hyp.test_time_flips=True"],
    # the acc_strength pre-pass stays local to each rank; shuffled epochs
    "gradreg-acc-shuffled": FB + ["hyp=gradreg", "hyp.grad_reg.acc_strength=0.5",
                                  "hyp.shuffle=True"],
    # two all_reduce a stochastic update, one at the end of the epoch
    "sam-stochastic": SGD + ["hyp/optim_modification=SAM"],
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_train_matches_jax_two_devices(case, config_dir, monkeypatch, tmp_path):
    stats = check_jax_case(JAX_CASES[case], config_dir, monkeypatch, tmp_path)
    # 2 ranks x 2 blocks x 2 chunks (x 1 norm a block when stochastic)
    norms = sum(k.startswith("grad_norm_train_") for k in stats)
    assert norms == (4 if case == "sam-stochastic" else 8), norms
    if case == "fb1":
        assert 0 < sum(stats["clipped_batches"]) < 2 * 8, stats["clipped_batches"]
