"""Two steps of the port's `make_train_step` with the DUSt3R teacher, step 0
in "distill_only" and step 1 in "distill", against the JAX package's jitted
step in float32 on the CPU: every log, every gradient and every updated
parameter. The student is the JAX package's tiny training config with a
confidence channel and linear heads (the synthetic_pose family: two phase
compiles of the JAX step in about 35 s, against 60 s with DPT heads); the
DPT heads' distill forward is in tests/test_torch_distill.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_distill import teacher_params
from test_torch_training import (
    GRAD_TOL,
    LOSS_TOL,
    _assert_grads,
    _assert_params,
    _KeepGrads,
    _port_grads,
    _torch_batch,
    numpy_params,
    to_port_config,
)
from test_training import tiny_batch, tiny_train_cfg

from vicasplat_tpu.models import dust3r as jd
from vicasplat_tpu.training import make_train_step as j_make_train_step
from vicasplat_tpu.training import step as jstep
from vicasplat_tpu.training.optimizer import make_optimizer
from vicasplat_tpu_torch.models import dust3r as td
from vicasplat_tpu_torch.models.vicasplat import VicaSplat
from vicasplat_tpu_torch.training import AdamW, TrainConfig, make_train_step
from vicasplat_tpu_torch.training import step as tstep
from vicasplat_tpu_torch.utils import weights

torch.set_num_threads(1)

TEACHER = dict(img_size=32, patch_size=16, enc_embed_dim=64, enc_depth=1, enc_num_heads=4,
               dec_embed_dim=48, dec_depth=2, dec_num_heads=4)


def test_two_steps_distill_only_then_distill():
    """Step 0 "distill_only" (no render; the Gaussian-parameter head without
    a gradient, still decayed), step 1 "distill" (the full objective plus
    the teacher's term; warm-up 1, so step 1 moves the weights), both at
    T = 2 (anchor 0 on both sides)."""
    jcfg = tiny_train_cfg()
    jcfg = dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, predict_conf=True,
                                        gs_center_head_type="linear",
                                        gs_param_head_type="linear"),
        distill_only_steps=1, distill_max_steps=1)
    params = numpy_params(jcfg.model)
    batch = jax.tree.map(lambda x: np.asarray(x, np.float32), tiny_batch(jax.random.PRNGKey(1)))
    tcfg = to_port_config(TrainConfig, dataclasses.asdict(jcfg))
    model = weights.load_jax_params(VicaSplat(tcfg.model), params)

    t_jcfg = jd.Dust3RConfig(**TEACHER)
    tparams = teacher_params(t_jcfg, seed=5)
    teacher_fn = td.make_teacher_fn(
        weights.load_jax_params(td.Dust3R(td.Dust3RConfig(**TEACHER)), tparams), torch.float32)

    def jteacher(a, b):
        return jax.lax.stop_gradient(jd.dust3r_forward(tparams, t_jcfg, a, b,
                                                       dtype=jnp.float32))

    opt_j = _KeepGrads(make_optimizer(params, jcfg.optimizer))
    state = opt_j.init(params)
    jstep_fn = jax.jit(j_make_train_step(jcfg, opt_j, teacher_fn=jteacher),
                       static_argnames="phase")
    opt = AdamW(model, tcfg.optimizer)
    step = make_train_step(tcfg, model, opt, teacher_fn=teacher_fn)
    tgrads, jgrads, jparams = [], [], params
    for i in range(2):
        phase = tstep.pick_phase(tcfg, i, True)
        assert phase == jstep.pick_phase(jcfg, i, True) == ("distill_only", "distill")[i]
        if i:  # from JAX's parameters; the optimizer keeps its own moments
            model.load_state_dict(weights.state_dict_from_jax(jparams))
        jparams, state, jlogs = jstep_fn(jparams, state, batch, i, phase=phase)
        jlogs = {k: float(v) for k, v in jlogs.items()}
        logs = step(_torch_batch(batch), i, phase=phase)
        assert set(logs) == set(jlogs)
        assert ("mse" in logs) == (phase == "distill") and "distillation" in logs
        for k, v in jlogs.items():
            tol = GRAD_TOL if k == "grad_norm" else LOSS_TOL
            np.testing.assert_allclose(float(logs[k]), v, rtol=tol, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        clip = tcfg.optimizer.gradient_clip_val
        tg = _port_grads(model, state[1])
        if phase == "distill_only":
            assert all(float(np.abs(g).max()) == 0.0
                       for g in jax.tree.leaves(tg["gaussian_param_head"]))
        tgrads.append((tg, min(1.0, clip / float(logs["grad_norm"]))))
        jgrads.append((state[1], min(1.0, clip / jlogs["grad_norm"])))
        _assert_grads(tg, state[1])
        _assert_params(model, jparams, tgrads, jgrads, opt.mult, opt.schedule(i),
                       tcfg.optimizer.weight_decay)
