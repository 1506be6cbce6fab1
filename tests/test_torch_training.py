"""Parity of the port's training step (vicasplat_tpu_torch.training) with the
JAX package's `make_train_step` and `make_optimizer`, in float32 on the CPU:
the loss and logs, every parameter's gradient (carried across by the weight
bridge), and every parameter after one and two AdamW updates; remat
against no remat; the lr multipliers. Gradient accumulation is in
tests/test_torch_training_accum.py, so that the two JAX compiles run on
two workers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_training import tiny_batch, tiny_train_cfg

from vicasplat_tpu.models import vicasplat as jvs
from vicasplat_tpu.training import make_train_step as j_make_train_step
from vicasplat_tpu.training.optimizer import lr_multiplier_tree, make_optimizer
from vicasplat_tpu_torch.models.vicasplat import VicaSplat
from vicasplat_tpu_torch.training import AdamW, TrainConfig, make_train_step
from vicasplat_tpu_torch.training.optimizer import lr_multipliers
from vicasplat_tpu_torch.training.step import compute_loss, pick_phase
from vicasplat_tpu_torch.utils import weights

torch.set_num_threads(1)

# float32 on both sides through the backbone, the DPT heads, the render and
# their backward, each op summed in another order by XLA and by torch: the
# losses agree within 1e-5 relative. Every gradient flows through the
# rasterizer's compositing backward, whose matmul sums over ~100 splats a
# pixel run in other orders (tests/test_torch_render.py holds those
# gradients at 1e-3 of the largest entry); each gradient is held at 1e-3 of
# its tensor's largest entry, and the gradient norm at 1e-3 relative
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
# An Adam update -lr * mult * (mu_hat / (sqrt(nu_hat) + 1e-8) + wd * p) moves
# by about lr * mult * (relative disagreement of the entry's gradients),
# since mu_hat / sqrt(nu_hat) is scale-free: with g the clipped gradients of
# the steps so far, |d(mu_hat)| <= max |dg| and sqrt(nu_hat) >= 0.7 max |g|
# over two steps, so each updated parameter is held within lr * mult *
# (1e-3 + 4 max|dg| / max|g|, at most 2 (1 + wd)) plus 1e-7 for its own
# float32 rounding. A
# wrong clip, bias correction, decay, schedule or multiplier moves entries
# with well-determined gradients by a whole update and fails
UPDATE_TOL = 1e-3


def to_port_config(cls, value):
    """A JAX config's `dataclasses.asdict` -> the port's config class,
    nested configs included."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = value[f.name]
        if dataclasses.is_dataclass(f.default):
            v = to_port_config(type(f.default), v)
        kw[f.name] = v
    return cls(**kw)


def numpy_params(jcfg, seed=0):
    """JAX params for `jcfg` (a VicaSplatConfig) drawn with numpy, with the
    JAX init's scales: xavier-normal weights (the variance of its xavier-
    uniform), unit layer-norm scales and LayerScales of 0.1 with a little
    noise, small biases and tokens, and small (not zero) camera heads and
    AdaLN modulations, so that every layout shows. Shapes come from
    jax.eval_shape, which is fast where running the init is not."""
    shapes = jax.eval_shape(lambda k: jvs.init_vicasplat(k, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [k.key for k in path]
        shape = leaf.shape
        if keys[-1] == "w" and not any("camera" in k or "modulation" in k
                                       for k in keys):
            fan_in = int(np.prod(shape[:-1]))
            fan_out = int(np.prod(shape[:-2])) * shape[-1]
            a = rng.normal(0, np.sqrt(2.0 / (fan_in + fan_out)), shape)
        elif keys[-1] == "scale":
            a = 1.0 + rng.normal(0, 0.05, shape)
        elif keys[-1] == "ls":
            a = 0.1 + rng.normal(0, 0.02, shape)
        else:
            a = rng.normal(0, 0.02, shape)
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np_batch(batch):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), batch)


def _torch_batch(batch):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), batch)


def _setup(jcfg, B=1):
    params = numpy_params(jcfg.model)
    batch = _np_batch(tiny_batch(jax.random.PRNGKey(1), B=B))
    tcfg = to_port_config(TrainConfig, dataclasses.asdict(jcfg))
    model = weights.load_jax_params(VicaSplat(tcfg.model), params)
    return params, batch, tcfg, model


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _port_grads(model, template):
    """The port's p.grad as a JAX-shaped tree (zeros where there is none)."""
    return weights.jax_tree_from_state_dict(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in model.named_parameters()}, template)


def _assert_grads(tgrads, jgrads):
    for path, j in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        j = np.asarray(j)
        np.testing.assert_allclose(_leaf(tgrads, path), j, rtol=0,
                                   atol=GRAD_TOL * np.abs(j).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_params(model, jparams, tgrads, jgrads, mult, lr, wd):
    """tgrads, jgrads: lists over the steps taken so far of (gradient tree,
    its clip factor min(1, clip / grad_norm))."""
    got = weights.jax_tree_from_state_dict(model.state_dict(), jparams)
    mult = weights.jax_tree_from_state_dict(
        {n: torch.full_like(p, m) for n, p in model.named_parameters()
         for m in [mult[n]]}, jparams)
    for path, j in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        j = np.asarray(j)
        gj = [c * np.asarray(_leaf(g, path)) for g, c in jgrads]
        gt = [c * _leaf(g, path) for g, c in tgrads]
        rel = (np.max([np.abs(a - b) for a, b in zip(gt, gj)], axis=0)
               / (np.max([np.abs(b) for b in gj], axis=0) + 1e-30))
        tol = lr * _leaf(mult, path) * (UPDATE_TOL + np.minimum(
            4 * rel, 2 * (1 + wd))) + 1e-7
        bad = np.abs(_leaf(got, path) - j) > tol
        assert not bad.any(), (jax.tree_util.keystr(path),
                               np.abs(_leaf(got, path) - j)[bad].max(),
                               int(bad.sum()))


class _KeepGrads:
    """An optax transformation around the JAX optimizer that also carries
    the gradients it was given in its state, so that one jitted
    `make_train_step` returns the guarded, averaged gradients too."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return (self.inner.init(params), jax.tree.map(jnp.zeros_like, params))

    def update(self, grads, state, params=None):
        updates, inner = self.inner.update(grads, state[0], params)
        return updates, (inner, grads)


def _jax_steps(jcfg, params, batch, n, start=0):
    """n JAX steps from global step `start`: [(params, grads, logs)] after
    each."""
    opt = _KeepGrads(make_optimizer(params, jcfg.optimizer))
    state = jax.jit(opt.init)(params)
    step = jax.jit(j_make_train_step(jcfg, opt))
    out = []
    for i in range(start, start + n):
        params, state, logs = step(params, state, batch, i)
        out.append((params, state[1], {k: float(v) for k, v in logs.items()}))
    return out


def _check_steps(jcfg, B, n):
    params, batch, tcfg, model = _setup(jcfg, B=B)
    check_steps_from(jcfg, params, batch, tcfg, model, AdamW(model, tcfg.optimizer), n)


def check_steps_from(jcfg, params, batch, tcfg, model, opt, n, start=0, ref=None):
    """n steps of the port's make_train_step (the model holding `params`,
    its optimizer `opt`) against JAX's from global step `start` on the
    same batch (`ref`, _jax_steps' result, where it is already taken): the
    logs, every gradient and every updated parameter."""
    ref = ref if ref is not None else _jax_steps(jcfg, params, batch, n, start)
    assert len(ref) == n
    step = make_train_step(tcfg, model, opt)
    tgrads, jgrads = [], []
    for i, (jparams, jg, jlogs) in enumerate(ref):
        if i:  # from JAX's parameters, so that the step's own errors show;
            # the optimizer keeps its own moments
            model.load_state_dict(weights.state_dict_from_jax(ref[i - 1][0]))
        logs = step(_torch_batch(batch), start + i)
        assert set(logs) == set(jlogs)
        for k, v in jlogs.items():
            tol = GRAD_TOL if k == "grad_norm" else LOSS_TOL
            np.testing.assert_allclose(float(logs[k]), v, rtol=tol, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        clip = tcfg.optimizer.gradient_clip_val
        tgrads.append((_port_grads(model, jg),
                       min(1.0, clip / float(logs["grad_norm"]))))
        jgrads.append((jg, min(1.0, clip / jlogs["grad_norm"])))
        _assert_grads(tgrads[-1][0], jg)
        _assert_params(model, jparams, tgrads, jgrads, opt.mult,
                       opt.schedule(start + i), tcfg.optimizer.weight_decay)


def test_train_step_matches_jax():
    """One step, then a second one (schedule and moments): loss, logs, every
    gradient and every updated parameter."""
    _check_steps(tiny_train_cfg(), B=1, n=2)


@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_keeps_gradients(policy):
    """remat=True, with either policy, gives the gradients of remat=False
    (the same float32 arithmetic recomputed: equal up to 1e-6 relative)."""
    jcfg = tiny_train_cfg()
    params, batch, tcfg, _ = _setup(jcfg)
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        model = weights.load_jax_params(VicaSplat(cfg.model), params)
        loss, _ = compute_loss(model, cfg, _torch_batch(batch), 0)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=0,
                                   atol=1e-6 * float(g.abs().max()) + 1e-12,
                                   msg=n)


def test_lr_multipliers_match_jax():
    """The keyword match on parameter names gives each parameter the
    multiplier JAX's match on tree paths gives its leaf: the multiplier
    tree crosses the bridge as constant arrays."""
    jcfg = tiny_train_cfg()
    params, _, tcfg, model = _setup(jcfg)
    mult = jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32),
                        lr_multiplier_tree(params, jcfg.optimizer), params)
    want = {k: v.flatten()[0].item()
            for k, v in weights.state_dict_from_jax(mult).items()}
    got = lr_multipliers(model, tcfg.optimizer)
    assert got.keys() == want.keys()
    for k, m in got.items():  # want went through float32 arrays
        assert np.float32(m) == np.float32(want[k]), k
    assert set(got.values()) == {1.0, jcfg.optimizer.backbone_lr_multiplier}


def test_distill_phases_raise():
    """The distillation phases need a teacher, and a phase must be one of
    the three (the phases themselves: tests/test_torch_distill*.py)."""
    cfg = TrainConfig()
    assert pick_phase(cfg, 0, has_teacher=False) == "full"
    for phase in ("distill", "distill_only", "bogus"):
        with pytest.raises(ValueError, match="teacher" if "distill" in phase else "one of"):
            compute_loss(None, cfg, {"context": {}, "target": {}}, 0, phase=phase)
