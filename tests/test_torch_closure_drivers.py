"""The port's closure drivers against the JAX package's, on a stub objective.

The same smooth, non-convex float64 objective (numpy, 330 parameters in five
named leaves) sits behind the JAX drivers' ``fns.gradient_eval`` and behind
the port drivers' evaluation hook. It has a "running stat" ``s`` that each
call advances from the value it is given (``s <- 0.9 s + 0.1 mean(theta)``)
and that enters the loss, so a driver that chains the stats through its
evaluations in another order gets other losses. In stochastic mode each
block has its own targets. The port holds its params in another order than
the JAX ``ravel_pytree`` order, as the port's flat vectors do.

Restarting, non-monotone and Wolfe gradient descent, L-BFGS (Wolfe with and
without damping, Armijo, ``None``) and the FISTA search run 8 steps (the
per-block modes 2 epochs of 4 blocks); every param, metric, evaluation count,
the stat and ``get_state()`` agree to rtol 1e-10. The side semantics of the
JAX package's own driver tests hold on the port with their queued-loss stubs.
An L-BFGS payload in ``ravel_pytree`` order of the width-4 ResNet-18 tree
goes through ``convert.py``: each element lands on its parameter, and dots
of converted vectors equal ``jnp.vdot``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fullbatchtraining_tpu.training.optimizers import SGDState
from fullbatchtraining_tpu.training.opt import closures as jclosures
from fullbatchtraining_tpu.training.training import TrainState
from fullbatchtraining_tpu_torch.config import ConfigNode
from fullbatchtraining_tpu_torch.convert import (export_jax_driver_state, export_jax_variables,
                                                 flat_from_jax, load_jax_driver_state)
from fullbatchtraining_tpu_torch.training.opt import closures
from fullbatchtraining_tpu_torch.training.opt.closures import DriverState

RTOL = 1e-10
SHAPES = {("a", "kernel"): (12, 10), ("a", "bias"): (10,), ("b", "kernel"): (8, 6, 3),
          ("b", "gain"): (6,), ("c", "scale"): (50,)}
PORT_ORDER = [("c", "scale"), ("b", "kernel"), ("a", "kernel"), ("b", "gain"), ("a", "bias")]
BLOCKS = 4

GD = {"name": "Gradient Descent", "lr": 0.5, "momentum": 0.9, "dampening": 0.0,
      "nesterov": True, "weight_decay": 5e-4}
LBFGS = {"name": "L-BFGS", "lr": 1.0, "weight_decay": 5e-4, "history_size": 4,
         "line_search": "Wolfe", "eps": 1e-2, "damping": True, "eta": 2, "c1": 1e-4,
         "c2": 0.9, "max_linesearches": 10}
CASES = {
    # lr 2: the loss rises after step 0, so restarts and retries fire
    "restarting": ("restarting", {**GD, "lr": 2.0, "interval": 2}, True, False),
    "non-monotone": ("non-monotone", {**GD, "lr": 2.0, "interval": 2, "factor": 0.25,
                                      "max_iter": 4}, False, False),
    # lr 1.5: the search zooms; lr 0.05: alpha grows to 6.25
    "wolfe-zoom": ("wolfe", {**GD, "lr": 1.5, "nesterov": False, "dampening": 0.1}, False,
                   False),
    "wolfe-grow": ("wolfe", {**GD, "lr": 0.05}, False, False),
    "lbfgs-wolfe": ("lbfgs", LBFGS, False, False),
    "lbfgs-wolfe-undamped": ("lbfgs", {**LBFGS, "damping": False}, False, False),
    "lbfgs-armijo": ("lbfgs", {**LBFGS, "line_search": "Armijo"}, True, False),
    "lbfgs-none": ("lbfgs", {**LBFGS, "line_search": "None", "lr": 0.3}, False, False),
    "fista-search": ("fista-search", {"name": "FISTA", "lr": 2.0, "fista_mod": [1.0, 1.0, 4.0],
                                      "eta": 0.5, "max_searches": 10}, False, False),
    "lbfgs-blocks": ("lbfgs", LBFGS, False, True),
    "wolfe-blocks": ("wolfe", GD, False, True),
    "non-monotone-blocks": ("non-monotone", {**GD, "lr": 2.0, "interval": 2, "max_iter": 3},
                            False, True),
}


def _node(tree):
    return ConfigNode({k: _node(v) for k, v in tree.items()}) if isinstance(tree, dict) else tree


def _cfg(optim, only_linear=False):
    return _node({"hyp": {"optim": optim, "only_linear_layers_weight_decay": only_linear},
                  "impl": {}})


def _path(name):
    return "".join(f"['{part}']" for part in name)


class Objective:
    """sum w log(1 + (theta - t)^2) + 0.05 ||theta||^2 + 0.01 s sum(theta_c),
    block ``b`` shifting the targets by ``0.3 b``."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.theta0 = {n: rng.standard_normal(s) for n, s in SHAPES.items()}
        self.target = {n: 2 * rng.standard_normal(s) for n, s in SHAPES.items()}
        self.weight = {n: rng.uniform(0.5, 1.5, s) for n, s in SHAPES.items()}

    def __call__(self, theta, s, block=None):
        shift = 0.0 if block is None else 0.3 * (block + 1)
        loss, grads = 0.0, {}
        for n in SHAPES:
            r = theta[n] - self.target[n] - shift
            loss += float(np.sum(self.weight[n] * np.log1p(r * r)) + 0.05 * np.sum(theta[n] ** 2))
            grads[n] = self.weight[n] * 2 * r / (1 + r * r) + 0.1 * theta[n]
        loss += 0.01 * s * float(np.sum(theta[("c", "scale")]))
        grads[("c", "scale")] = grads[("c", "scale")] + 0.01 * s
        s_new = 0.9 * s + 0.1 * float(np.mean(np.concatenate([t.ravel() for t in theta.values()])))
        return loss, grads, s_new, 1.0 / (1.0 + loss)


def _tree(named):
    out = {}
    for (a, b), v in named.items():
        out.setdefault(a, {})[b] = v
    return out


def _schedule(base):
    return lambda step: base * 0.9 ** int(step)


class JaxStub:
    def __init__(self, objective, base_lr):
        self.objective = objective
        self.schedule = _schedule(base_lr)
        self.calls = 0
        self.layout = (BLOCKS,)
        self.streamed = False
        self.mesh = None

    def _eval(self, state, block):
        self.calls += 1
        theta = {n: np.asarray(state.params[n[0]][n[1]]) for n in SHAPES}
        loss, grads, s, acc = self.objective(theta, float(state.batch_stats["s"]), block)
        return (jax.tree.map(jnp.asarray, _tree(grads)), {"s": jnp.asarray(s)},
                {"train_loss": jnp.asarray(loss), "train_acc": jnp.asarray(acc)})

    def gradient_eval(self, state, images, labels, with_modifiers=True):
        return self._eval(state, None)

    def block_gradient_eval(self, state, images, labels, bidx):
        return self._eval(state, bidx)


class PortStub:
    param_paths = [_path(n) for n in PORT_ORDER]
    device = torch.device("cpu")

    def __init__(self, objective, base_lr):
        self.objective = objective
        self.schedule = _schedule(base_lr)
        self.calls = 0
        self.s = 0.0

    def _eval(self, state, block):
        self.calls += 1
        theta = {n: p.numpy() for n, p in zip(PORT_ORDER, state.params)}
        loss, grads, self.s, acc = self.objective(theta, self.s, block)
        return ([torch.from_numpy(grads[n]) for n in PORT_ORDER],
                {"train_loss": torch.tensor(loss, dtype=torch.float64),
                 "train_acc": torch.tensor(acc, dtype=torch.float64)})

    def gradient_eval(self, state, images, labels):
        return self._eval(state, None)

    def block_gradient_eval(self, state, images, labels):
        return self._eval(state, images)


def _port_flat(jax_vec):
    """A JAX ravel_pytree vector of the stub's params in the port's order."""
    jax_vec = np.asarray(jax_vec)
    if not jax_vec.size:
        return jax_vec
    parts, offset = {}, 0
    for n in sorted(SHAPES):
        size = int(np.prod(SHAPES[n]))
        parts[n] = jax_vec[offset:offset + size]
        offset += size
    return np.concatenate([parts[n] for n in PORT_ORDER])


def _assert_state_close(ours, ref, kind):
    assert set(ours) == set(ref)
    for key, value in ref.items():
        if kind == "lbfgs" and key in ("s_hist", "y_hist"):
            assert len(ours[key]) == len(value), key
            for a, b in zip(ours[key], value):
                np.testing.assert_allclose(a.numpy(), _port_flat(b), rtol=RTOL, err_msg=key)
        elif kind == "lbfgs" and key in ("prev_flat_grad", "Bs", "d"):
            np.testing.assert_allclose(ours[key].numpy(), _port_flat(value), rtol=RTOL,
                                       err_msg=key)
        elif key == "x_prev":
            for n, a in zip(PORT_ORDER, ours[key]):
                np.testing.assert_allclose(a.numpy(), value[n[0]][n[1]], rtol=RTOL)
        else:
            np.testing.assert_allclose(ours[key], value, rtol=RTOL, err_msg=key)


def _run_jax(kind, cfg, objective, blocks, steps):
    with jax.enable_x64(True):
        fns = JaxStub(objective, cfg.hyp.optim.lr)
        driver = jclosures.make_closure_step(fns, cfg, kind)
        step = (jclosures.make_stochastic_closure_step(cfg, fns, kind, driver=driver)
                if blocks else driver.step)
        params = jax.tree.map(jnp.asarray, _tree(objective.theta0))
        state = TrainState(step=jnp.asarray(0), params=params,
                           batch_stats={"s": jnp.asarray(0.0)},
                           opt_state=SGDState(momentum=jax.tree.map(jnp.zeros_like, params),
                                              count=jnp.asarray(0)))
        history = []
        for _ in range(steps):
            state, metrics = step(state, np.arange(BLOCKS), np.arange(BLOCKS))
            history.append({k: float(v) for k, v in metrics.items()})
        payload = jax.tree.map(np.asarray, jax.device_get(driver.get_state()))
        return jax.device_get(state), history, fns.calls, payload


def _run_port(kind, cfg, objective, blocks, steps):
    fns = PortStub(objective, cfg.hyp.optim.lr)
    driver = closures.make_closure_step(fns, cfg, kind)
    step = closures.make_stochastic_closure_step(driver) if blocks else driver.step
    state = DriverState(0, [torch.from_numpy(objective.theta0[n].copy()) for n in PORT_ORDER])
    history = []
    for _ in range(steps):
        if blocks:
            state, metrics = step(state, [(b, None) for b in range(BLOCKS)])
        else:
            state, metrics = step(state, None, None)
        history.append({k: float(v) for k, v in metrics.items()})
    return state, history, fns, driver.get_state()


@pytest.mark.parametrize("case", list(CASES))
def test_driver_matches_jax(case):
    kind, optim, only_linear, blocks = CASES[case]
    cfg = _cfg(optim, only_linear)
    objective = Objective()
    steps = 2 if blocks else 8
    ref, ref_history, ref_calls, ref_payload = _run_jax(kind, cfg, objective, blocks, steps)
    state, history, fns, payload = _run_port(kind, cfg, objective, blocks, steps)

    assert state.step == int(ref.step) == steps
    assert fns.calls == ref_calls >= steps
    for ours, theirs in zip(history, ref_history, strict=True):
        assert set(ours) == set(theirs)
        for key in theirs:
            np.testing.assert_allclose(ours[key], theirs[key], rtol=RTOL, err_msg=key)
    for n, p in zip(PORT_ORDER, state.params):
        np.testing.assert_allclose(p.numpy(), np.asarray(ref.params[n[0]][n[1]]), rtol=RTOL,
                                   err_msg=str(n))
    np.testing.assert_allclose(fns.s, float(ref.batch_stats["s"]), rtol=RTOL)
    if kind in closures._DRIVERS and optim["momentum"]:
        for n, b in zip(PORT_ORDER, state.momentum):
            np.testing.assert_allclose(b.numpy(), np.asarray(ref.opt_state.momentum[n[0]][n[1]]),
                                       rtol=RTOL, atol=1e-14)
    _assert_state_close(payload, ref_payload, kind)


def test_the_cases_reach_their_branches():
    """The driver cases are not vacuous: restarts fire, non-monotone retries,
    Wolfe zooms and grows, L-BFGS keeps pairs and backtracks, the FISTA search
    shrinks its lr."""
    def run(case):
        kind, optim, only_linear, blocks = CASES[case]
        return _run_port(kind, _cfg(optim, only_linear), Objective(), blocks, 8)
    _, history, fns, payload = run("restarting")
    assert len(payload["losses"]) < 9    # a restart records no loss
    _, history, fns, payload = run("non-monotone")
    assert fns.calls > 8                    # retries evaluate again
    _, history, fns, payload = run("lbfgs-wolfe")
    assert len(payload["s_hist"]) == 4 and {h["lbfgs_t"] for h in history} - {1.0}
    _, history, fns, payload = run("wolfe-zoom")
    assert min(h["wolfe_alpha"] for h in history) < 1.0
    _, history, fns, payload = run("wolfe-grow")
    assert max(h["wolfe_alpha"] for h in history) == 6.25
    _, history, fns, payload = run("fista-search")
    assert payload["lr"] < 2.0 * 0.9 ** 8


# ---------------------------------------------------------------------------
# side semantics, on queued-loss stubs as the JAX package's driver tests
# ---------------------------------------------------------------------------

class QueuedStub:
    """Queued losses, a constant gradient, and a stat that counts the calls."""

    param_paths = ["['w']"]
    device = torch.device("cpu")

    def __init__(self, losses, grad_value=1.0):
        self.losses = list(losses)
        self.grad = [torch.full((2,), grad_value, dtype=torch.float64)]
        self.calls = 0

    def schedule(self, step):
        return 0.1

    def gradient_eval(self, state, images, labels):
        self.calls += 1
        return self.grad, {"train_loss": torch.tensor(self.losses.pop(0), dtype=torch.float64)}


def _gd(**optim):
    return _cfg({"momentum": 0.0, "dampening": 0.0, "nesterov": False, "weight_decay": 0.0,
                 **optim})


def _zero_state():
    return DriverState(0, [torch.zeros(2, dtype=torch.float64)])


def test_nonmonotone_retries_chain_and_scale_the_latest_gradient():
    fns = QueuedStub([5.0, 6.0, 3.0])
    drv = closures.NonMonotoneLinesearch(fns, _gd(interval=1, factor=0.25, max_iter=10))
    state, _ = drv.step(_zero_state(), None, None)
    assert fns.calls == 3   # every retry is a closure call: the stats chain 3 times
    np.testing.assert_allclose(state.params[0].numpy(), -0.1 * 0.25 * np.ones(2), rtol=1e-12)


def test_fista_driver_chains_and_composes_the_schedule():
    from fullbatchtraining_tpu_torch.training.opt.fista import FISTALineSearchDriver
    fns = QueuedStub([10.0, 1e6, 9.0])
    fns.schedule = lambda step: 0.1 * (0.5 ** int(step))
    driver = FISTALineSearchDriver(fns, _cfg({"lr": 0.1, "eta": 0.5, "max_searches": 5,
                                              "fista_mod": [1.0, 1.0, 4.0], "tk": 1.0}))
    driver.step(_zero_state(), None, None)
    assert fns.calls == 3
    np.testing.assert_allclose(driver.lr, 0.05 * 0.5, rtol=1e-12)


def test_wolfe_params_stay_at_last_fresh_attempt():
    fns = QueuedStub([10.0, 1.0, 0.5, 0.25])
    drv = closures.WolfeGradientDescent(fns, _gd(c1=1e-4, c2=0.9, alpha_max=10.0, max_iter=10))
    state, metrics = drv.step(_zero_state(), None, None)
    assert fns.calls == 4
    np.testing.assert_allclose(state.params[0].numpy(), -0.1 * 6.25 * np.ones(2), rtol=1e-12)
    assert metrics["wolfe_alpha"] == pytest.approx(6.25)


def test_restarting_reset_uses_zeros_buffer_on_step0():
    fns = QueuedStub([5.0])
    drv = closures.RestartingLineSearch(fns, _gd(momentum=0.9, dampening=0.5, interval=1))
    state, _ = drv.step(_zero_state(), None, None)
    np.testing.assert_allclose(state.params[0].numpy(), -0.1 * 0.5 * np.ones(2), rtol=1e-12)
    np.testing.assert_allclose(state.momentum[0].numpy(), 0.5 * np.ones(2), rtol=1e-12)


def test_wolfe_nan_trial_zooms_back_to_finite_point():
    fns = QueuedStub([10.0, float("nan"), 5.0])
    drv = closures.WolfeGradientDescent(fns, _gd(c1=1e-4, c2=0.9, alpha_max=10.0, max_iter=10))
    state, metrics = drv.step(_zero_state(), None, None)
    assert fns.calls == 3
    assert np.isfinite(float(metrics["train_loss"]))
    np.testing.assert_allclose(state.params[0].numpy(), -0.1 * 0.5 * np.ones(2), rtol=1e-12)
    assert metrics["wolfe_alpha"] == pytest.approx(0.5)


def test_lbfgs_ascent_direction_restarts_the_memory():
    """A history whose pair has negative curvature (y = -s, H_diag = -1)
    turns -H g uphill: both drivers drop the memory and step along -g."""
    objective = Objective()
    cfg = _cfg({**LBFGS, "line_search": "None", "lr": 0.1, "weight_decay": 0.0})
    rng = np.random.default_rng(3)
    s = rng.standard_normal(sum(int(np.prod(v)) for v in SHAPES.values()))
    jax_payload = {"s_hist": [s], "y_hist": [-s], "H_diag": -1.0, "t": 1.0, "n_iter": 1,
                   "curv_skips": 0, "fail_skips": 0, "fail": True,
                   "prev_flat_grad": np.zeros_like(s), "Bs": np.zeros_like(s),
                   "d": np.zeros_like(s)}
    with jax.enable_x64(True):
        fns = JaxStub(objective, 0.1)
        ref = jclosures.make_closure_step(fns, cfg, "lbfgs")
        ref.set_state(jax_payload)
        params = jax.tree.map(jnp.asarray, _tree(objective.theta0))
        ref_state, _ = ref.step(TrainState(step=jnp.asarray(0), params=params,
                                           batch_stats={"s": jnp.asarray(0.0)},
                                           opt_state=None), None, None)
        ref_payload = jax.tree.map(np.asarray, jax.device_get(ref.get_state()))
    driver = closures.make_closure_step(PortStub(objective, 0.1), cfg, "lbfgs")
    port_payload = {k: ([torch.from_numpy(_port_flat(v)) for v in x] if k in ("s_hist", "y_hist")
                        else torch.from_numpy(_port_flat(x)) if isinstance(x, np.ndarray) else x)
                    for k, x in jax_payload.items()}
    driver.set_state(port_payload)
    state, _ = driver.step(DriverState(0, [torch.from_numpy(objective.theta0[n].copy())
                                           for n in PORT_ORDER]), None, None)
    assert ref_payload["s_hist"] == [] and driver.s_hist == [] and driver.H_diag == 1.0
    _, grads, _, _ = objective(objective.theta0, 0.0)
    for n, p in zip(PORT_ORDER, state.params):   # one step of lr 0.1 along -g
        np.testing.assert_allclose(p.numpy(), objective.theta0[n] - 0.1 * grads[n], rtol=1e-12)
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_state.params[n[0]][n[1]]),
                                   rtol=RTOL)


# ---------------------------------------------------------------------------
# L-BFGS and FISTA payloads between the JAX ravel_pytree order and the port's
# ---------------------------------------------------------------------------

def _resnet():
    from fullbatchtraining_tpu_torch.config import load_config
    from fullbatchtraining_tpu_torch.models import construct_model
    cfg = load_config("config", overrides=["model=resnet18", "model.width=4"])
    return construct_model(cfg.model, 3, 10, seed=0).to(torch.float64)


def test_lbfgs_payload_in_ravel_order_converts():
    model = _resnet()
    tree = export_jax_variables(model)["params"]
    rng = np.random.default_rng(0)
    other = jax.tree.map(lambda a: rng.standard_normal(a.shape), tree)
    with jax.enable_x64(True):
        v1 = np.asarray(ravel_pytree(jax.tree.map(jnp.asarray, tree))[0])
        v2 = np.asarray(ravel_pytree(jax.tree.map(jnp.asarray, other))[0])
        ref_dot = float(jnp.vdot(v1, v2))
    # each element lands on its parameter: the params' own ravel is the
    # port's flat params
    ours = flat_from_jax(model, v1)
    assert torch.equal(ours, torch.cat([p.detach().reshape(-1) for p in model.parameters()]))
    np.testing.assert_allclose(float(torch.dot(ours, flat_from_jax(model, v2))), ref_dot,
                               rtol=1e-12)
    payload = {"s_hist": [v1, v2], "y_hist": [v2, v1], "H_diag": 0.5, "t": 1.0, "n_iter": 3,
               "curv_skips": 1, "fail_skips": 0, "fail": False, "prev_flat_grad": v2,
               "Bs": v1, "d": np.zeros((0,), np.float32)}
    port = load_jax_driver_state(model, payload)
    assert port["d"].numel() == 0 and port["n_iter"] == 3
    back = export_jax_driver_state(model, port)
    for key in ("s_hist", "y_hist"):
        for a, b in zip(back[key], payload[key], strict=True):
            np.testing.assert_array_equal(a, b)
    for key in ("prev_flat_grad", "Bs", "d"):
        np.testing.assert_array_equal(back[key], payload[key])


def test_fista_payload_converts():
    model = _resnet()
    tree = export_jax_variables(model)["params"]
    payload = {"lr": 0.05, "tk": 2.5, "x_prev": tree}
    port = load_jax_driver_state(model, payload)
    for p, v in zip(model.parameters(), port["x_prev"]):
        assert torch.equal(p.detach(), v)
    back = export_jax_driver_state(model, port)
    jax.tree.map(np.testing.assert_array_equal, back["x_prev"], tree)
    assert export_jax_driver_state(model, {"lr": 1.0, "tk": 1.0, "x_prev": []})["x_prev"] == {}
