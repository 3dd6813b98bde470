"""Port parity: the trainer's optimizer against optax, on the CPU.

`train.optim.AdamWClip` against the JAX trainer's
`optax.chain(clip_by_global_norm(1.0), adamw(cosine_decay_schedule(lr, n),
weight_decay))` on small random pytrees (no trainer), float32:
* 10 steps with gradient norms below and above the clip threshold:
  parameters, both moments and the count, within 2e-7 absolute and 1e-5
  relative (measured: parameters 0.0, first moment 1.5e-8, second 8.7e-11
  when clipped; the two sides round the clip's division differently);
* the cosine schedule at every count within 1e-9 of optax's learning rate,
  and the constant schedule equal to the float32 lr;
* a step with a non-finite loss or gradient leaves parameters, moments and
  the count (hence the schedule) untouched, as the JAX trainer's guard
  does: exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from fresnel_tpu_torch.train.optim import AdamWClip, cosine_lr
from test_torch_threads import _few_threads  # noqa: F401


SHAPES = {"a": (4, 3), "b": (5,), "c": ()}
LR, STEPS, WD = 2e-4, 10, 1e-5


def _tree(rng, scale=1.0):
    return {k: np.asarray(rng.normal(size=s) * scale, dtype=np.float32)
            for k, s in SHAPES.items()}


def _optax(total):
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(optax.cosine_decay_schedule(LR, total),
                                   weight_decay=WD))


@pytest.mark.parametrize("scale", [0.01, 3.0], ids=["below_clip",
                                                    "above_clip"])
def test_matches_optax_over_ten_steps(scale):
    rng = np.random.default_rng(int(scale * 100))
    p0 = _tree(rng)
    grads = [_tree(rng, scale) for _ in range(STEPS)]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values()))
             for gs in grads]
    assert all((n < 1.0) == (scale < 1.0) for n in norms)

    opt = _optax(STEPS)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    t = AdamWClip(LR, STEPS, WD)
    ts = t.init(tp)
    for g in grads:
        up, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, up)
        tp, ts = t.update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          ts, loss=torch.tensor(1.0))
    adam = js[1][0]
    assert int(ts["count"]) == int(adam.count) == STEPS
    for k in SHAPES:
        for want, got in ((jp[k], tp[k]), (adam.mu[k], ts["mu"][k]),
                          (adam.nu[k], ts["nu"][k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-7, rtol=1e-5)


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(LR, 37)
    for c in range(0, 45):
        got = cosine_lr(torch.tensor(c, dtype=torch.int32), LR, 37).item()
        assert abs(got - float(sched(c))) <= 1e-9
    const = AdamWClip(LR, 37, WD, schedule="constant")
    # float32, as optax scales a float32 update by the float lr.
    assert const.learning_rate(torch.tensor(5)).item() == float(
        np.float32(LR))


@pytest.mark.parametrize("bad", ["loss_nan", "grad_inf", "grad_nan"])
def test_non_finite_step_leaves_state_untouched(bad):
    rng = np.random.default_rng(4)
    p = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    t = AdamWClip(LR, STEPS, WD)
    s = t.init(p)
    p, s = t.update(p, {k: torch.from_numpy(v) for k, v in
                        _tree(rng).items()}, s, loss=torch.tensor(1.0))
    g = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    loss = torch.tensor(1.0)
    if bad == "loss_nan":
        loss = torch.tensor(float("nan"))
    else:
        g["b"][2] = float("inf") if bad == "grad_inf" else float("nan")
    p2, s2 = t.update(p, g, s, loss=loss)
    assert int(s2["count"]) == int(s["count"]) == 1
    for k in SHAPES:
        assert torch.equal(p2[k], p[k])
        assert torch.equal(s2["mu"][k], s["mu"][k])
        assert torch.equal(s2["nu"][k], s["nu"][k])
    # The next finite step takes the schedule's second value, as if the
    # skipped step had not happened.
    g_ok = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    assert torch.equal(t.update(p2, g_ok, s2, loss=torch.tensor(1.0))[0]["a"],
                       t.update(p, g_ok, s, loss=torch.tensor(1.0))[0]["a"])
