"""The port's train mode against the JAX package on the CPU, at toy size
(the synthetic_pose experiment at 32^2 with narrow widths): the step
tracker, the train loader and its prefetch threads, the parameter EMA,
checkpoints (the full-state round trip bit for bit, weights-only snapshots
read on both sides), the layout helpers and colour tables, the train loop
itself, the entry point with its files, and check C1's projection gradient."""
import importlib.util
import json
import pathlib
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vicasplat_tpu import main as jmain
from vicasplat_tpu.data import data_module as jdm
from vicasplat_tpu.models import init_vicasplat as jinit
from vicasplat_tpu.models import vicasplat_forward as jforward
from vicasplat_tpu.training import optimizer as jopt
from vicasplat_tpu.utils import image_io as jio
from vicasplat_tpu.utils import loggers as jlog
from vicasplat_tpu.utils.config import load_config as jload_config
from vicasplat_tpu.utils.step_tracker import StepTracker as JStepTracker
from vicasplat_tpu.visualization import layout as jlayout
from vicasplat_tpu_torch import main as tmain
from vicasplat_tpu_torch.data import data_module as tdm
from vicasplat_tpu_torch.models import vicasplat_forward
from vicasplat_tpu_torch.training import AdamW, OptimizerConfig, make_train_step
from vicasplat_tpu_torch.training.optimizer import get_ema_params
from vicasplat_tpu_torch.utils import checkpointing as tck
from vicasplat_tpu_torch.utils import image_io as tio
from vicasplat_tpu_torch.utils import loggers as tlog
from vicasplat_tpu_torch.utils.config import load_config
from vicasplat_tpu_torch.utils.step_tracker import StepTracker
from vicasplat_tpu_torch.utils.weights import jax_tree_from_state_dict
from vicasplat_tpu_torch.visualization import layout as tlayout

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAIN = ROOT / "configs" / "main.yaml"
# the synthetic_pose experiment at toy size: 32^2, encoder 64 x 2, decoder
# 48 x 2 (heads of 12), 256 Gaussians a scene, batch 2, float32, warm-up 1
TOY = ["encoder.backbone.img_size=32", "encoder.backbone.enc_embed_dim=64",
       "encoder.backbone.enc_depth=2", "encoder.backbone.enc_num_heads=4",
       "encoder.backbone.dec_embed_dim=48", "encoder.backbone.dec_depth=2",
       "encoder.backbone.dec_num_heads=4", "dataset.synthetic.input_image_shape=[32,32]",
       "dataset.synthetic.n_gaussians=256", "dataset.synthetic.n_scenes=4",
       "dataset.synthetic.n_val_scenes=1", "dataset.synthetic.n_test_scenes=1",
       "data_loader.train.batch_size=2", "trainer.precision=float32",
       "optimizer.warm_up_steps=1", "train.print_log_every_n_steps=1",
       "wandb.mode=offline", "checkpointing.async_save=false"]
# frames of the two rasterizers, as tests/test_torch_eval.py holds them: the
# same splats summed in other orders agree within FRAME_TOL; a splat on the
# 1/255 alpha cut may be kept on one side only (at most 2/255, rare pixels)
FRAME_TOL = 2e-4
FRAME_CUT_TOL = 2 / 255
FRAME_CUT_SHARE = 1e-3
# 3 steps of the loop in float32 from the same weights on the same batches
# (frames within FRAME_TOL): measured gaps 6e-8 in loss, 2e-6 in PSNR, 9e-7
# in any parameter after lr 2e-4 updates; the losses are held at 1e-5
# relative, PSNR at 1e-4 dB, the learning rate (float32 on the JAX side,
# Python float here) at 1e-6 relative, parameters at 1e-5
LOOP_TOL = {"loss": 1e-5, "mse": 1e-5, "camera": 1e-5, "grad_norm": 1e-4}
PSNR_TOL = 1e-4
LR_TOL = 1e-6
PARAM_TOL = 1e-5
# the EMA of the same parameters on both sides, float32 arithmetic in the
# same order: a few ulp
EMA_TOL = 1e-6
# float32 forwards of the toy model on the two sides (the eval tests hold
# the committed model's at 2e-4 relative)
FORWARD_TOL = 2e-4


def toy_cfgs(*extra):
    args = [*TOY, *extra]
    return (jload_config(MAIN, "synthetic_pose", args),
            load_config(MAIN, "synthetic_pose", args))


def jax_weights_npz(path, jcfg, seed=0):
    """JAX init weights for `jcfg` as a checkpoint npz (arr_i in leaf order),
    read by both sides."""
    leaves = jax.tree_util.tree_leaves(jinit(jax.random.PRNGKey(seed), jcfg.encoder))
    np.savez(path, **{f"arr_{i}": np.asarray(x) for i, x in enumerate(leaves)},
             _total_steps=np.int64(0))
    return path


def jax_load(path, template=None):
    with np.load(path) as z:
        leaves, treedef = jax.tree_util.tree_flatten(template)
        return jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(z[f"arr_{i}"]).astype(np.asarray(t).dtype)
                      for i, t in enumerate(leaves)])


# ---- the step tracker ----

@pytest.mark.parametrize("shared", [False, True])
def test_step_tracker_matches_jax(shared):
    j, t = JStepTracker(use_shared_memory=shared), StepTracker(use_shared_memory=shared)
    assert t.get_step() == j.get_step() == 0
    for s in (3, 7.9, 2**40):
        j.set_step(s)
        t.set_step(s)
        assert t.get_step() == j.get_step()

    def writer():
        for i in range(200):
            t.set_step(i)

    th = [threading.Thread(target=writer) for _ in range(4)]
    for x in th:
        x.start()
    for x in th:
        x.join()
    assert t.get_step() == 199


# ---- the train loader ----

def test_train_batches_match_jax():
    """The first 3 train batches of both DataModules from the same seed:
    scene ids and view indices equal, cameras equal, frames within the
    rasterizers' tolerance; the port's land as tensors, its loader drops
    the last short batch and restarts from the same first batch."""
    jcfg, tcfg = toy_cfgs("dataset.synthetic.n_scenes=5", "dataset.synthetic.repeats=1")
    tr = jdm.DataModule(jcfg.dataset, jcfg.data_loader, JStepTracker()).train_dataloader()
    pl = tdm.DataModule(tcfg.dataset, tcfg.data_loader, StepTracker(),
                        device="cpu").train_dataloader()
    try:
        jb, tb = list(tr), list(pl)
    finally:
        tr.close()
        pl.close()
    assert len(jb) == len(tb) == 2  # 5 scenes, batch 2, the last one dropped
    for j, t in zip(jb, tb):
        assert t["scene"] == j["scene"]
        for side in ("context", "target"):
            for k in ("index", "extrinsics", "intrinsics", "near", "far"):
                np.testing.assert_array_equal(t[side][k].numpy(), j[side][k], err_msg=k)
            diff = np.abs(t[side]["image"].numpy() - j[side]["image"])
            assert diff.max() <= FRAME_CUT_TOL and (diff > FRAME_TOL).mean() <= FRAME_CUT_SHARE
    again = tdm.DataModule(tcfg.dataset, tcfg.data_loader, StepTracker(),
                           device="cpu").train_dataloader()
    first = next(again)
    again.close()
    assert first["scene"] == tb[0]["scene"]
    assert tdm.DataModule(tcfg.dataset, tcfg.data_loader).train_batch_size() == 2


@pytest.mark.parametrize("drop_last", [True, False])
def test_prefetch_iterator_matches_jax_and_closes(drop_last):
    """The same batches as JAX's PrefetchIterator from one iterator, the
    short last batch dropped or kept; close() in the middle of an epoch
    leaves no live thread, and a worker's exception reaches the consumer."""
    def examples():
        return iter([{"x": np.full(2, k, np.float32), "s": str(k)} for k in range(5)])

    got = list(tdm.PrefetchIterator(examples(), 2, drop_last=drop_last))
    want = list(jdm.PrefetchIterator(examples(), 2, drop_last=drop_last))
    assert [b["s"] for b in got] == [b["s"] for b in want]
    assert len(got) == (2 if drop_last else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"], w["x"])
    before = set(threading.enumerate())

    def endless():
        while True:
            yield {"x": np.zeros(2, np.float32), "s": "e"}

    it = tdm.PrefetchIterator(endless(), 2, prefetch=1, drop_last=drop_last)
    next(it)
    it.close()
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]

    def broken():
        yield {"x": np.zeros(2, np.float32), "s": "a"}
        raise KeyError("bad example")

    with pytest.raises(KeyError, match="bad example"):
        list(tdm.PrefetchIterator(broken(), 1, drop_last=drop_last))


def test_train_loader_closes_mid_epoch():
    _, tcfg = toy_cfgs()
    before = set(threading.enumerate())
    it = tdm.DataModule(tcfg.dataset, tcfg.data_loader, device="cpu").train_dataloader()
    next(it)
    it.close()
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]


# ---- the EMA ----

class _TwoGroups(torch.nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.backbone = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.tensor(a))})
        self.gaussian_param_head = torch.nn.ParameterDict(
            {"w": torch.nn.Parameter(torch.tensor(b))})


def test_ema_matches_optax_track_param_ema():
    """AdamW with ema_decay against optax's chain with `_track_param_ema`
    over 4 steps (clip, warm-up, both lr multipliers): the EMA within
    EMA_TOL, `get_ema_params` None at ema_decay 0, as JAX's."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=5).astype(np.float32)
    grads = [(rng.normal(size=(3, 4)).astype(np.float32),
              rng.normal(size=5).astype(np.float32)) for _ in range(4)]
    kw = dict(lr=1e-2, warm_up_steps=2, gradient_clip_val=0.5, ema_decay=0.9)
    jparams = {"backbone": {"w": jnp.asarray(a)}, "gaussian_param_head": {"w": jnp.asarray(b)}}
    tx = jopt.make_optimizer(jparams, jopt.OptimizerConfig(**kw))
    state = tx.init(jparams)
    model = _TwoGroups(a, b)
    opt = AdamW(model, OptimizerConfig(**kw))
    for ga, gb in grads:
        upd, state = tx.update({"backbone": {"w": jnp.asarray(ga)},
                                "gaussian_param_head": {"w": jnp.asarray(gb)}}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        model.backbone.w.grad = torch.tensor(ga)
        model.gaussian_param_head.w.grad = torch.tensor(gb)
        opt.step()
    jema, tema = jopt.get_ema_params(state), get_ema_params(opt)
    np.testing.assert_allclose(tema["backbone.w"].numpy(), jema["backbone"]["w"],
                               rtol=0, atol=EMA_TOL)
    np.testing.assert_allclose(tema["gaussian_param_head.w"].numpy(),
                               jema["gaussian_param_head"]["w"], rtol=0, atol=EMA_TOL)
    assert not np.array_equal(tema["backbone.w"].numpy(), a)
    off = AdamW(model, OptimizerConfig(lr=1e-2))
    assert get_ema_params(off) is None
    assert jopt.get_ema_params(jopt.make_optimizer(jparams, jopt.OptimizerConfig()).init(
        jparams)) is None


# ---- checkpoints ----

@pytest.fixture(scope="module")
def toy_model_cfg():
    return toy_cfgs()


def _toy(tcfg, moment_dtype, ema):
    cfg = tcfg
    import dataclasses

    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, moment_dtype=moment_dtype, ema_decay=0.99 if ema else 0.0))
    train_cfg, model, opt = tmain.build_all(cfg, "cpu")
    return cfg, train_cfg, model, opt


def _state(model, opt):
    return dict(params={k: v.detach().clone() for k, v in model.named_parameters()},
                mu={k: v.clone() for k, v in opt.mu.items()},
                nu={k: v.clone() for k, v in opt.nu.items()},
                ema=None if opt.ema is None else {k: v.clone() for k, v in opt.ema.items()},
                count=opt.count)


def _assert_equal_state(a, b):
    assert a["count"] == b["count"]
    for kind in ("params", "mu", "nu", "ema"):
        if a[kind] is None:
            assert b[kind] is None
            continue
        for k in a[kind]:
            assert a[kind][k].dtype == b[kind][k].dtype, (kind, k)
            assert torch.equal(a[kind][k], b[kind][k]), (kind, k)


@pytest.mark.parametrize("moment_dtype,ema", [("float32", False), ("bfloat16", True)])
def test_resume_equals_unbroken_run_bit_for_bit(toy_model_cfg, tmp_path, moment_dtype, ema):
    """Save the full state after 2 steps, run a third; restore the saved
    state into a fresh model and optimizer and run the same third step: the
    parameters, both moments (bf16 kept bf16), the EMA and the step count
    equal the unbroken run's bit for bit, with the write done by the
    background thread."""
    _, tcfg = toy_model_cfg
    cfg, train_cfg, model, opt = _toy(tcfg, moment_dtype, ema)
    loader = tdm.DataModule(cfg.dataset, cfg.data_loader, device="cpu").train_dataloader()
    batches = [{k: v for k, v in next(loader).items() if k != "scene"} for _ in range(3)]
    loader.close()
    step = make_train_step(train_cfg, model, opt)
    for i in range(2):
        step(batches[i], i)
    ckpt = tck.CheckpointManager(tmp_path / "ck", every_n_steps=2, keep=1, async_save=True)
    ckpt.save(2, model, opt)
    ckpt.finalize()
    step(batches[2], 2)
    unbroken = _state(model, opt)

    _, _, model2, opt2 = _toy(tcfg, moment_dtype, ema)
    assert ckpt.latest() == tmp_path / "ck" / "step_00000002.npz"
    assert tck.restore_train_state(ckpt.latest(), model2, opt2) == 2
    make_train_step(train_cfg, model2, opt2)(batches[2], 2)
    _assert_equal_state(unbroken, _state(model2, opt2))
    assert opt2.mu[next(iter(opt2.mu))].dtype == (
        torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32)


def test_checkpoint_manager_prunes_and_refuses(toy_model_cfg, tmp_path, capsys):
    """Top-k pruning by step, no temporary file left, should_save as JAX's;
    a weights-only snapshot restores its weights only (step 0, a warning);
    a corrupt or mismatched full state raises; an orbax directory raises."""
    _, tcfg = toy_model_cfg
    cfg, _, model, opt = _toy(tcfg, "float32", False)
    from vicasplat_tpu.utils.checkpointing import CheckpointManager as JCheckpointManager

    ckpt = tck.CheckpointManager(tmp_path, every_n_steps=3, keep=2, async_save=False)
    jck = JCheckpointManager(tmp_path.parent / f"{tmp_path.name}_jax", every_n_steps=3)
    assert [ckpt.should_save(s) for s in range(8)] == [jck.should_save(s) for s in range(8)]
    for s in (3, 6, 9):
        ckpt.save(s, model, opt if s != 9 else None)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000006.npz",
                                                         "step_00000009.npz"]
    assert tck.is_full_state(tmp_path / "step_00000006.npz")
    assert not tck.is_full_state(tmp_path / "step_00000009.npz")
    _, _, fresh, fresh_opt = _toy(tcfg, "float32", False)
    assert tck.restore_train_state(tmp_path / "step_00000009.npz", fresh, fresh_opt) == 0
    assert "weights-only" in capsys.readouterr().out and fresh_opt.count == 0
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), fresh.parameters()))
    with np.load(tmp_path / "step_00000006.npz") as z:
        arrays = {k: z[k] for k in z.files if k != "mu_3"}
    tck.write_npz(tmp_path / "broken.npz", arrays)
    with pytest.raises(ValueError, match="mu leaves"):
        tck.restore_train_state(tmp_path / "broken.npz", fresh, fresh_opt)
    (tmp_path / "garbage.npz").write_bytes(b"not a zip")
    with pytest.raises(Exception):
        tck.restore_train_state(tmp_path / "garbage.npz", fresh, fresh_opt)
    _, _, _, ema_opt = _toy(tcfg, "float32", True)
    with pytest.raises(ValueError, match="EMA"):
        tck.restore_train_state(tmp_path / "step_00000006.npz", fresh, ema_opt)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        tck.load_weights(tmp_path / "orbax", fresh)


def test_weights_only_snapshot_reads_on_both_sides(toy_model_cfg, tmp_path):
    """A snapshot the port writes, read back by the port's load_weights and
    by the JAX side as the committed file is read (tools/jax_eval_reference.py
    load_npz_params): the same float32 forward on both sides."""
    import sys

    sys.path.insert(0, str(ROOT))
    from tools.jax_eval_reference import load_npz_params

    jcfg, tcfg = toy_model_cfg
    _, _, model, _ = _toy(tcfg, "float32", False)
    with torch.no_grad():
        for p in model.parameters():  # every layout visible, none zero
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    path = tmp_path / "snap.npz"
    tck.write_npz(path, tck.snapshot(model, 7))
    _, _, back, _ = _toy(tcfg, "float32", False)
    assert tck.load_weights(path, back) == {"total_steps": 7}
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), back.parameters()))
    params, steps = load_npz_params(path, jinit(jax.random.PRNGKey(0), jcfg.encoder))
    assert steps == 7
    rng = np.random.default_rng(0)
    ctx = dict(image=rng.uniform(-1, 1, (1, 4, 32, 32, 3)).astype(np.float32),
               intrinsics=np.broadcast_to(np.array([[1, 0, .5], [0, 1, .5], [0, 0, 1]],
                                                   np.float32), (1, 4, 3, 3)).copy())
    jout = jforward(params, jcfg.encoder, {k: jnp.asarray(v) for k, v in ctx.items()},
                    dtype=jnp.float32)
    with torch.no_grad():
        tout = vicasplat_forward(back, {k: torch.from_numpy(v) for k, v in ctx.items()},
                                 dtype=torch.float32)
    for k in ("means", "opacities", "harmonics"):
        a, b = getattr(tout["gaussians"], k).numpy(), np.asarray(getattr(jout["gaussians"], k))
        assert np.abs(a - b).max() <= FORWARD_TOL * np.abs(b).max(), k


def test_use_ema_reads_the_full_state(toy_model_cfg, tmp_path, capsys):
    """test.use_ema: the EMA of a full-state checkpoint becomes the test
    mode's weights; a snapshot without one warns and keeps the weights."""
    _, tcfg = toy_model_cfg
    cfg, train_cfg, model, opt = _toy(tcfg, "float32", True)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        opt.ema = {k: v + 0.5 for k, v in opt.ema.items()}
    tck.write_npz(tmp_path / "full.npz", tck.snapshot(model, 1, opt))
    tck.write_npz(tmp_path / "weights.npz", tck.snapshot(model, 1))
    import dataclasses

    for name, want in (("full.npz", opt.ema), ("weights.npz",
                                               dict(model.named_parameters()))):
        c = dataclasses.replace(cfg, checkpointing=dataclasses.replace(
            cfg.checkpointing, load=str(tmp_path / name)),
            test=dataclasses.replace(cfg.test, use_ema=True))
        got = dict(tmain.build_model(c, "cpu").named_parameters())
        assert all(torch.equal(got[k], want[k]) for k in got), name
    assert "no EMA state" in capsys.readouterr().out


# ---- layout and colour tables ----

def test_layout_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.random((20, 30, 3)), rng.random((11, 17))
    for fn in ("hcat", "vcat"):
        for gap in (0, 3):
            np.testing.assert_array_equal(getattr(tlayout, fn)(a, b, gap=gap),
                                          getattr(jlayout, fn)(a, b, gap=gap))
    np.testing.assert_array_equal(tlayout.add_border(b, 4, 0.5), jlayout.add_border(b, 4, 0.5))
    for label, size in (("target (GT)", 14), ("depth", 9), ("x" * 40, 20)):
        t, j = tlayout.add_label(a, label, size), jlayout.add_label(a, label, size)
        bar = size + 8
        assert t.shape == j.shape and t.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(t[bar:], j[bar:])  # below the label bar
        assert t[:bar].min() == 0.0 and t[:bar].max() == 1.0  # ink on white
    x = rng.random((33, 47)).astype(np.float32)
    x[0, :4] = [0.0, 1.0, -0.5, 1.5]
    np.testing.assert_allclose(tlayout.apply_color_map(x), jlayout.apply_color_map(x),
                               rtol=0, atol=1e-6)


def test_colour_tables_match_matplotlib():
    import matplotlib

    from vicasplat_tpu_torch.visualization import colormaps

    for name, table in (("inferno", colormaps.INFERNO), ("turbo", colormaps.TURBO)):
        np.testing.assert_allclose(table, np.asarray(matplotlib.colormaps[name].colors),
                                   rtol=0, atol=1e-6)
        x = np.linspace(0, 1, 1001)
        np.testing.assert_allclose(colormaps.lookup(table, x),
                                   matplotlib.colormaps[name](x)[..., :3], rtol=0, atol=1e-6)


def test_vis_depth_map_matches_jax():
    rng = np.random.default_rng(1)
    d = rng.random((24, 31)) * 7
    d[0, :5] = 0.0
    np.testing.assert_allclose(tio.vis_depth_map(d), jio.vis_depth_map(d), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tio.vis_depth_map(np.zeros((4, 4))),
                               jio.vis_depth_map(np.zeros((4, 4))), rtol=0, atol=1e-6)


# ---- the train loop and the entry point ----

def _history(out_dir):
    run, = (pathlib.Path(out_dir) / "wandb_offline").iterdir()
    steps = {}
    for line in (run / "history.jsonl").read_text().splitlines():
        rec = json.loads(line)
        s = rec.pop("_step")
        rec.pop("_timestamp")
        steps.setdefault(s, {}).update(rec)
    return run, steps


def test_train_loop_matches_jax(tmp_path):
    """3 steps of `train(cfg, device="cpu")` against the JAX package's
    `main.train` from the same weights (the checkpoint loader on both
    sides): the same batches, each step's logged scalars and learning rate,
    and the final parameters."""
    jcfg, _ = toy_cfgs()
    npz = jax_weights_npz(tmp_path / "w.npz", jcfg)
    args = [*TOY, "trainer.max_steps=3", "trainer.val_check_interval=0",
            f"checkpointing.load={npz}"]
    jcfg = jload_config(MAIN, "synthetic_pose", [*args, f"output_dir={tmp_path}/j",
                                                 f"checkpointing.output_dir={tmp_path}/j/c"])
    saved = {}
    with mock.patch("vicasplat_tpu.utils.checkpointing.load_weights", jax_load), \
            mock.patch("vicasplat_tpu.utils.checkpointing.CheckpointManager.save",
                       lambda self, step, params, **kw: saved.update(params=params)), \
            mock.patch("vicasplat_tpu.utils.checkpointing.CheckpointManager.finalize",
                       lambda self: None):
        jmain.train(jcfg)
    r = tmain.main(["+experiment=synthetic_pose", "mode=train", *args,
                    f"output_dir={tmp_path}/t", f"checkpointing.output_dir={tmp_path}/t/c"],
                   device="cpu")
    _, hj = _history(tmp_path / "j")
    _, ht = _history(tmp_path / "t")
    assert sorted(ht) == sorted(hj) == [1, 2, 3] and r["step"] == 3
    for s in hj:
        for k, tol in LOOP_TOL.items():
            a, b = ht[s][f"train/{k}"], hj[s][f"train/{k}"]
            assert abs(a - b) <= tol * abs(b), (s, k, a, b)
        assert abs(ht[s]["train/psnr"] - hj[s]["train/psnr"]) <= PSNR_TOL
        assert abs(ht[s]["train/lr"] - hj[s]["train/lr"]) <= LR_TOL * hj[s]["train/lr"]
    got = jax_tree_from_state_dict(r["model"].state_dict(), saved["params"])
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(saved["params"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=PARAM_TOL)


def test_main_train_mode_end_to_end(tmp_path, monkeypatch):
    """main([... mode=train ...]) on the CPU: a profiler trace of the first
    step, the offline logger's run directory (config, history of every
    step's scalars, summary, the validation image), the validation grid,
    full-state checkpoints, then a
    resume from the newest that continues at its step with the loader
    restarted; the test mode scores the snapshot it wrote."""
    out = tmp_path / "run"
    args = ["+experiment=synthetic_pose", "mode=train", *TOY, "trainer.max_steps=2",
            "trainer.val_check_interval=2", "checkpointing.every_n_train_steps=1",
            "checkpointing.save_weights_only=false", "checkpointing.save_top_k=1",
            f"output_dir={out}", f"checkpointing.output_dir={out}/ckpts"]
    r = tmain.main([*args, f"trainer.profile_dir={out}/prof", "trainer.profile_start=0",
                    "trainer.profile_steps=1"], device="cpu")
    trace = json.loads((out / "prof/trace.json").read_text())
    assert any("autograd" in str(e.get("name", "")) or e.get("ph") == "X"
               for e in trace["traceEvents"])
    run, hist = _history(out)
    assert sorted(hist) == [1, 2]
    assert {"train/loss", "train/psnr", "train/mse", "train/camera", "train/grad_norm",
            "train/lr"} <= set(hist[1])
    assert hist[2]["val/comparison"]["_type"] == "image-file"
    assert json.loads((run / "summary.json").read_text())["train/loss"] == hist[2]["train/loss"]
    assert (run / "config.json").exists() and (run / "media/val_comparison/00000002.png").exists()
    png = (out / "val/step_0000002/comparison.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert sorted(p.name for p in (out / "ckpts").iterdir()) == ["step_00000002.npz"]
    assert tck.is_full_state(out / "ckpts/step_00000002.npz") and r["optimizer"].count == 2
    r2 = tmain.main([*args, "trainer.max_steps=3", "trainer.val_check_interval=0",
                     "checkpointing.resume=true", "checkpointing.save_weights_only=true"],
                    device="cpu")
    assert r2["step"] == 3 and r2["optimizer"].count == 3
    assert [x["step"] for x in r2["logs"]] == [3]
    snap = out / "ckpts/step_00000003.npz"
    assert not tck.is_full_state(snap)
    summary, results = tmain.main(
        ["+experiment=synthetic_pose", *TOY, "mode=test", "dataset.synthetic.n_test_scenes=1",
         "test.pose_align_steps=1", f"checkpointing.load={snap}",
         f"test.output_path={tmp_path / 'eval'}"], device="cpu")
    assert len(results) == 1 and np.isfinite(summary["psnr"])
    # distillation through main(): one "distill_only" step with a toy
    # teacher (random: no checkpoint); the phases in tests/test_torch_distill*.py
    from vicasplat_tpu_torch.models.dust3r import Dust3RConfig

    monkeypatch.setattr(tmain, "teacher_config", lambda cfg: Dust3RConfig(
        img_size=32, enc_embed_dim=64, enc_depth=1, enc_num_heads=4, dec_embed_dim=48,
        dec_depth=2, dec_num_heads=4))
    monkeypatch.setenv("DISTILLER_CKPT", str(tmp_path / "none.ckpt"))
    r3 = tmain.main([*args, "trainer.max_steps=1", "train.distiller=dust3r",
                     "train.distill_only_steps=1", f"output_dir={tmp_path / 'distill'}",
                     f"checkpointing.output_dir={tmp_path / 'distill/ckpts'}"], device="cpu")
    assert [x["step"] for x in r3["logs"]] == [1]
    assert "distillation" in r3["logs"][0] and "mse" not in r3["logs"][0]


@pytest.mark.parametrize("mode", ["offline", "disabled"])
def test_make_logger_follows_jax(tmp_path, mode):
    """wandb without the package: the offline run directory on both sides;
    wandb disabled: TensorBoard's SummaryWriter when it imports, else None,
    on both sides."""
    jcfg, tcfg = toy_cfgs(f"wandb.mode={mode}", f"output_dir={tmp_path}")
    j, t = jlog.make_logger(jcfg), tlog.make_logger(tcfg)
    try:
        if mode == "offline" and importlib.util.find_spec("wandb") is None:
            assert type(t).__name__ == type(j).__name__ == "WandbOfflineLogger"
            t.add_scalar("train/loss", 0.5, 3)
            t.add_image("val/x", np.zeros((3, 4, 5)), 3)
            t.close()
            _, hist = _history(tmp_path)
            assert hist[3]["train/loss"] == 0.5
        else:
            assert type(t).__name__ == type(j).__name__
    finally:
        for w in (j, t):
            if w is not None and mode == "disabled":
                w.close()


def test_wandb_logger_calls_match_jax(tmp_path):
    """With the wandb package (a recording stand-in here; chip_smoke.py's
    train-mode reads back a real offline run on the card): the port's
    WandbLogger makes the JAX package's wandb.init, log, Image and finish
    calls."""
    import sys
    import types

    def fake_wandb(log):
        class Run:
            def finish(self):
                log.append(("finish",))

            def log_code(self, root):
                pass

        m = types.ModuleType("wandb")
        m.init = lambda **kw: (log.append(
            ("init", {k: v for k, v in kw.items() if k != "config"})), Run())[1]
        m.log = lambda d, step: log.append(("log", d, step))
        m.Image = lambda arr: ("Image", np.asarray(arr).shape, np.asarray(arr).tobytes())
        return m

    jcfg, tcfg = toy_cfgs("wandb.mode=offline", f"output_dir={tmp_path}")
    img = np.random.default_rng(0).random((3, 4, 5)).astype(np.float32)
    logs = {}
    for side, mod, cfg in (("jax", jlog, jcfg), ("port", tlog, tcfg)):
        log = logs[side] = []
        with mock.patch.dict(sys.modules, {"wandb": fake_wandb(log)}):
            w = mod.make_logger(cfg)
            assert type(w).__name__ == "WandbLogger"
            w.add_scalar("train/loss", np.float32(0.5), 3)
            w.add_image("val/comparison", img, 4, dataformats="CHW")
            w.close()
    assert logs["port"] == logs["jax"]
    assert [c[0] for c in logs["port"]] == ["init", "log", "log", "finish"]
    assert logs["port"][2][1]["val/comparison"][1] == (4, 5, 3)


# ---- check C1 ----

def test_c1_projection_gradient_matches_jax():
    """The projection inputs of the Gaussians whose mean gets a non-finite
    gradient at the flagship step that C1 found on the card
    (vicasplat_tpu_torch/diagnostics/c1_gaussians.npz, written by
    diagnostics/c1_locate.py): the JAX package's projection gives the same
    non-finite gradient entries as the port's, view by view. These Gaussians
    lie ~1e36 from the cameras, where fy * y overflows float32 in either
    projection and the cull's zero cotangent meets it (0 * inf). This holds
    the two projections alike at such means; it does not say whether the
    JAX package's training reaches such means."""
    import sys

    sys.path.insert(0, str(ROOT))
    from tools.jax_c1_reference import compare

    rec = compare()
    total = 0
    for item in rec.values():
        assert item["means_absmax"] > 1e35
        for v in item["views"]:
            assert v["same_nonfinite_entries"]
            assert v["jax_nonfinite"] == v["port_nonfinite"]
            total += v["port_nonfinite"]
    assert total > 0
