"""The port's parallel routes (vicasplat_tpu_torch/parallel, DDP in
training/step.py, MoE expert parallelism) on gloo process groups on the
CPU, against the JAX package's unsharded calls and the port's own serial
ones, in float32.

One group of 2 and one of 4 processes (torch.multiprocessing, spawned once
for the whole file, over FileStores under tmp_path: no TCP port, so xdist
workers cannot collide) run tests/torch_parallel_worker.py: every rank runs
every route of its world size and saves its results; the tests here compare
them. World 2: shard_batch and replicate, DDP against the single-process
step (with and without accumulation), FSDP2's sharding rule and step, the
view-sharded render, the GPipe pipeline (its replicas with and without the
stages' average), EP on a (1, 2) mesh. World 4:
tensor and sequence parallelism on (2, 2) meshes and EP on a (2, 2)
data x expert mesh. Both: two train steps under SP, TP and EP
(run_sp_tp_ep_steps) against the single-process step, and the SP step
against JAX's make_train_step(sp_mesh=...) on virtual CPU devices."""
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_training import _KeepGrads, to_port_config
from tests import torch_parallel_worker as worker
from vicasplat_tpu.decoder.splatting import DecoderSplattingConfig as JDecCfg
from vicasplat_tpu.decoder.splatting import decoder_forward as jdecoder_forward
from vicasplat_tpu.models import moe as jmoe
from vicasplat_tpu.models import vicanet as jvn
from vicasplat_tpu.models.adapter import Gaussians as JGaussians
from vicasplat_tpu.models.adapter import build_covariance
from vicasplat_tpu.models import vicasplat as jvs
from vicasplat_tpu.ops.rasterize import RasterizeConfig as JRasterCfg
from vicasplat_tpu.parallel import make_mesh_sp as j_make_mesh_sp
from vicasplat_tpu.training import TrainConfig as JTrainConfig
from vicasplat_tpu.training import make_train_step as j_make_train_step
from vicasplat_tpu.training.optimizer import make_optimizer
from vicasplat_tpu_torch.models.vicasplat import init_vicasplat
from vicasplat_tpu_torch.parallel.mesh import GradSplit, mark_split
from vicasplat_tpu_torch.training import AdamW, make_train_step
from vicasplat_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax

torch.set_num_threads(1)

# the tiny VicaNet in float32 against JAX (tests/test_torch_vicanet.py's
# rule); a sharded route sums the same products over other splits
NET_TOL = 1e-4
# the routed MLP against JAX (tests/test_torch_moe.py)
MOE_TOL = 1e-5
# renders against JAX's serial decoder_forward (tests/test_torch_render.py);
# with make_scale_invariant the rescale moves from the packed covariances to
# the Gaussians before the split (float32 rounding of the scaled inputs)
IMG_TOL = 1e-4
# the same float32 step, gradients averaged over 2 ranks (or micro-batches
# summed) instead of one pass over the batch: sums in other orders, ~1e-6
# relative; held at 1e-5 of each tensor's largest gradient
GRAD_TOL = 1e-5
LOSS_TOL = 1e-6
# GPipe sums each gradient over its micro-batches, one example each, where
# the serial pass sums over the batch: the two orders leave a few entries
# of a tensor ~1e-5 of its largest apart
PP_GRAD_TOL = 1e-4
# a whole step in micro-batches of one example against one pass over the
# batch: batch-size dependent float32 sums, and the rasterizer's 1/255
# alpha cut acting on them, move gradients by up to 1e-3 of a tensor's
# largest, as tests/test_torch_training.py holds the port against JAX
WHOLE_GRAD_TOL = 1e-3
# one AdamW step from those gradients: the first update is lr * mult *
# (g / |g| + wd * p), so an entry moves by at most about 2 lr * mult when
# its gradient is at rounding level and its sign differs; lr = 1e-3
PARAM_TOL = 2e-3
# an entry whose gradient is above 1e-4 of its tensor's largest has a
# well-determined sign: there the parameters agree to rounding
PARAM_FINE = 1e-6
# training under SP, TP and EP against the single-process step on the
# whole batch (tests/torch_parallel_worker.run_sp_tp_ep_steps): the split
# tokens, heads and experts sum their float32 products in other orders, and
# every gradient flows through the compositing backward, which
# tests/test_torch_training.py holds at 1e-3 of the largest entry against
# JAX for the same reason. Each gradient is held at 1e-3 of its tensor's
# largest entry, the loss at 1e-6 relative, the gradient norm at 1e-4, each
# beside twice the reference's own spread: the same single-process steps
# from context images 1e-7 apart (relative). That spread is at rounding
# level for the dense model; with routes overflowing the MoE step is
# ill-conditioned (one pass over batch 4 moves a decoder norm's gradient by
# 1.2e-2 of its largest entry under that change, with the same routes and
# seats). Each updated parameter by tests/test_torch_training.py's Adam rule
# (ROUTE_UPDATE_TOL): an update moves by about lr * mult * (relative
# disagreement of the entry's gradients, at most 2 (1 + wd)), plus 1e-7
ROUTE_GRAD_TOL = 1e-3
ROUTE_NORM_TOL = 1e-4
ROUTE_UPDATE_TOL = 1e-3
TINY = dict(img_size=32, patch_size=16, enc_embed_dim=64, enc_depth=2,
            enc_num_heads=4, dec_embed_dim=48, dec_depth=4, dec_num_heads=4,
            use_flash_attention=False)


def _numpy_tree(shapes, rng, std):
    """A param tree of `jax.eval_shape`'s shapes drawn by numpy (JAX's
    threefry init is the slow part at any size)."""
    return jax.tree.map(lambda x: rng.normal(0, std, x.shape).astype(np.float32),
                        shapes)


def _jax_sp_steps():
    """JAX's make_train_step(cfg, opt, mesh=m, sp_mesh=m) on a (1, 2) mesh of
    the CPU's virtual devices, jitted, on the worker's SP batch: step 0
    from the port's init (seed 0), step 1 from the port's single-process
    parameters after step 0, as the worker's SP step 1 starts (the
    optimizer keeps its own moments). Each step's loss, gradient norm,
    gradients and parameters under the port's names."""
    cfg = worker.TINY_TRAIN
    jcfg = to_port_config(JTrainConfig, dataclasses.asdict(cfg))
    template = jax.eval_shape(lambda k: jvs.init_vicasplat(k, jcfg.model),
                              jax.random.PRNGKey(0))
    model = init_vicasplat(cfg.model, torch.Generator().manual_seed(0), "cpu")
    # a copy: the bridge's arrays share the parameters' memory
    params = jax_tree_from_state_dict({k: v.clone() for k, v in model.state_dict().items()},
                                      template)
    batch = worker.train_batch(2)
    make_train_step(cfg, model, AdamW(model, cfg.optimizer))(batch, 0)
    start = jax_tree_from_state_dict(model.state_dict(), template)
    mesh = j_make_mesh_sp(1, 2)
    opt = _KeepGrads(make_optimizer(params, jcfg.optimizer))
    state = opt.init(params)
    step = jax.jit(j_make_train_step(jcfg, opt, mesh=mesh, sp_mesh=mesh))
    jbatch = jax.tree.map(lambda x: jnp.asarray(x.numpy()), batch)
    steps = []
    for i in range(2):
        params, state, logs = step(start if i else params, state, jbatch, i)
        steps.append({"loss": float(logs["loss"]), "grad_norm": float(logs["grad_norm"]),
                      "params": {k: v.numpy() for k, v in state_dict_from_jax(params).items()},
                      "grads": {k: v.numpy() for k, v in state_dict_from_jax(state[1]).items()}})
    return steps


def _inputs():
    """Every input of the ranks (numpy and torch), and a function that
    computes the JAX references, run while the ranks work."""
    rng = np.random.default_rng(0)
    jcfg = jvn.VicaNetConfig(**TINY)
    params = _numpy_tree(jax.eval_shape(lambda k: jvn.init_vicanet(k, jcfg),
                                        jax.random.PRNGKey(0)), rng, 0.2)
    images = rng.uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32)
    K = (np.eye(3, dtype=np.float32) + rng.normal(0, 0.05, (2, 2, 3, 3))
         ).astype(np.float32)
    K[..., 2, :] = [0, 0, 1]
    K[..., 0, 2] += 0.5
    K[..., 1, 2] += 0.5

    moe_dims = (16, 32, 4)
    moe_p = _numpy_tree(jax.eval_shape(lambda k: jmoe.moe_init(k, *moe_dims),
                                       jax.random.PRNGKey(2)), rng, 0.5)
    moe_x = rng.normal(size=(24, 16)).astype(np.float32)

    n = 300
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(2.0, 6.0, n)], -1).astype(np.float32)
    scales = rng.uniform(0.03, 0.2, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    covs = np.array(build_covariance(jnp.asarray(scales), jnp.asarray(quats)))
    g = dict(means=means[None], covariances=covs[None],
             harmonics=rng.normal(0, 0.3, (1, n, 3, 4)).astype(np.float32),
             opacities=rng.uniform(0.2, 1.0, (1, n)).astype(np.float32))
    V = 3  # over 2 ranks: a ragged tail
    ext = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    ext[0, :, :3, 3] = rng.normal(0, 0.2, (V, 3))
    cams = (ext, np.tile(np.array([[0.9, 0, 0.5], [0, 1.1, 0.48], [0, 0, 1]],
                                  np.float32), (1, V, 1, 1)),
            np.array([[0.8, 0.5, 0.7]], np.float32), np.full((1, V), 100.0, np.float32))
    raster = dict(tile_px=8, dup_hw=(4, 4), max_per_tile=64, chunk=32,
                  tile_group=16)

    def references():
        # the SP train step's compile, the longest, in a thread beside the rest
        sp_pool = ThreadPoolExecutor(1)
        sp_step = sp_pool.submit(_jax_sp_steps)
        net = jvn.vicanet_forward(params, jcfg, jnp.asarray(images), jnp.asarray(K),
                                  dtype=jnp.float32)
        moe = jmoe.moe_mlp(moe_p, jnp.asarray(moe_x), top_k=2,
                           capacity_factor=0.5, return_aux=True)
        view = {}
        for inv in (False, True):
            cfg = JDecCfg(make_scale_invariant=inv, rasterize=JRasterCfg(**raster))
            jg = JGaussians(**{k: jnp.asarray(v) for k, v in g.items()},
                            scales=None, rotations=None)
            view[inv] = [np.asarray(x) for x in jdecoder_forward(
                cfg, jg, *map(jnp.asarray, cams), (32, 32))]
        sp_pool.shutdown()
        return {"net": net, "moe": moe, "view": view, "sp_step": sp_step.result()}

    scan_blocks = torch.nn.ModuleList(torch.nn.Linear(6, 6) for _ in range(4))
    torch.manual_seed(0)
    for p in scan_blocks.parameters():
        torch.nn.init.normal_(p, 0, 0.4)
    t = torch.from_numpy
    inp = {
        "net_cfg": dataclasses.asdict(jcfg), "net_sd": state_dict_from_jax(params),
        "images": t(images), "K": t(K),
        "moe_dims": moe_dims, "moe_sd": state_dict_from_jax(moe_p), "moe_x": t(moe_x),
        "gaussians": {k: t(v) for k, v in g.items()} | {"scales": None,
                                                         "rotations": None},
        "cams": tuple(t(c) for c in cams), "raster": raster,
        "scan_blocks": scan_blocks.state_dict(),
        "scan_x": t(rng.normal(size=(4, 6)).astype(np.float32)),
    }
    return inp, references


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel"))
    inp, references = _inputs()
    torch.save(inp, os.path.join(root, "inputs.pt"))
    inp["root"] = root
    ctxs = [mp.start_processes(worker.main, args=(w, root), nprocs=w, join=False,
                               start_method="spawn") for w in (2, 4)]
    refs = references()  # JAX, while the ranks run
    for c in ctxs:
        while not c.join(timeout=300):
            pass
    res = {w: [torch.load(os.path.join(root, f"w{w}_r{r}.pt"), weights_only=False)
               for r in range(w)] for w in (2, 4)}
    for w, ranks in res.items():
        for r, out in enumerate(ranks):
            assert not out["errors"], f"world {w} rank {r}:\n" + "\n".join(out["errors"])
    return res, inp, refs


def test_shard_batch_and_replicate(runs):
    res, _, _ = runs
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    for r, out in enumerate(res[2]):
        np.testing.assert_array_equal(out["shard_batch"], x[3 * r:3 * r + 3])
        np.testing.assert_array_equal(out["replicated"], np.ones((2, 3)))


def _same_step(d, grad_tol=GRAD_TOL, norm_tol=GRAD_TOL, params=True):
    np.testing.assert_allclose(*d["loss"], rtol=LOSS_TOL)
    np.testing.assert_allclose(*d["grad_norm"], rtol=norm_tol)
    assert d["same_keys"]
    for k, (dg, scale, dp, dp_sure) in d["rows"].items():
        assert dg <= grad_tol * scale + 1e-12, (k, dg, scale)
        if params:
            assert dp <= PARAM_TOL and dp_sure <= PARAM_FINE, (k, dp, dp_sure)


@pytest.mark.parametrize("route", ["ddp", "ddp_accum", "fsdp"])
def test_data_parallel_step_equals_single_process(runs, route):
    """DP's gradient is the full batch's (JAX's test_dp_psum_semantics), and
    one DDP or FSDP2 step equals the single-process step on the whole batch:
    loss, gradient norm, gradients and parameters after AdamW. The
    reference runs the whole batch in micro-batches of one example, as each
    rank does, so that only the ranks' averaging differs."""
    res, _, _ = runs
    _same_step(res[2][1 if route == "ddp_accum" else 0][route])
    # DDP keeps the replicas equal
    assert res[2][0]["ddp_checksum"] == res[2][1]["ddp_checksum"]


def test_ddp_step_near_one_pass_over_the_batch(runs):
    """The same step against one pass over both examples (WHOLE_GRAD_TOL)."""
    res, _, _ = runs
    _same_step(res[2][0]["ddp_whole"], grad_tol=WHOLE_GRAD_TOL,
               norm_tol=WHOLE_GRAD_TOL, params=False)


def test_train_mode_under_ddp(runs, tmp_path):
    """main.py's train mode at world 2 (as torchrun runs it) against the
    same command in one process: each step's loss and gradient norm, the
    replicas equal, rank 0 alone logging and writing the checkpoint."""
    from tests.torch_parallel_worker import TRAIN_MODE
    from vicasplat_tpu_torch import main as tmain

    res, inp, _ = runs
    ranks = [out["train_mode"] for out in res[2]]
    one = tmain.main([*TRAIN_MODE, f"output_dir={tmp_path}",
                      f"checkpointing.output_dir={tmp_path}/ckpts"], device="cpu")
    assert ranks[0]["step"] == ranks[1]["step"] == one["step"] == 2
    assert ranks[0]["checksum"] == ranks[1]["checksum"]
    assert not ranks[1]["logs"] and len(ranks[0]["logs"]) == len(one["logs"]) == 2
    for got, want in zip(ranks[0]["logs"], one["logs"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_TOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=WHOLE_GRAD_TOL)
    ckpts = os.path.join(inp["root"], "train_mode", "ckpts")
    assert sorted(os.listdir(ckpts)) == ["step_00000002.npz"]


def test_fsdp_sharding_rule(runs):
    """JAX's test_fsdp_sharding: a big leaf shards along its largest dim the
    world divides; small and indivisible leaves stay whole."""
    res, _, _ = runs
    out = res[2][0]
    placed, rule = out["fsdp_placed"], out["fsdp_rule"]
    assert set(placed) == set(rule)
    n_sharded = 0
    for name, dim in rule.items():
        assert placed[name][0] == dim, name
        n_sharded += dim is not None
    assert 0 < n_sharded < len(rule)
    w = "backbone.enc_blocks.0.mlp.fc1.weight"  # (256, 64): rows halve
    assert rule[w] == 0 and placed[w][1] == (128, 64)


@pytest.mark.parametrize("invariant", [False, True])
def test_view_sharded_render_matches_jax(runs, invariant):
    res, _, refs = runs
    for out in res[2]:
        got = out[f"view_{invariant}"]
        assert got[0].shape == (1, 3, 32, 32, 3)
        for a, b in zip(got, refs["view"][invariant]):
            np.testing.assert_allclose(a, b, atol=IMG_TOL)
    assert float(refs["view"][invariant][2].max()) > 0.5


def _net_close(got, ref, rows=slice(None)):
    _, cam, _, inter = ref
    assert len(got["inter"]) == len(inter)
    for i, (a, b) in enumerate(zip(got["inter"], inter)):
        np.testing.assert_allclose(a, np.asarray(b)[rows], atol=NET_TOL,
                                   rtol=NET_TOL, err_msg=f"intermediate {i}")
    np.testing.assert_allclose(got["cam"], np.asarray(cam)[rows], atol=NET_TOL,
                               rtol=NET_TOL)


def test_pipeline_forward_and_grads(runs):
    """GPipe over 2 stages (2 micro-batches) against JAX's unsharded forward;
    each stage's gradients against the serial port's."""
    res, _, refs = runs
    metas = []
    for out in res[2]:
        _net_close(out["pp"], refs["net"])
        np.testing.assert_allclose(*out["pp_loss"], rtol=LOSS_TOL)
        for name, (g, gs) in out["pp_grads"].items():
            np.testing.assert_allclose(g, gs, atol=PP_GRAD_TOL * np.abs(gs).max() + 1e-12,
                                       err_msg=name)
        metas.append(set(out["pp_meta"]))
    # each stage holds half of each stack; together they hold all
    assert metas[0] and metas[1] and not metas[0] & metas[1]
    assert any(n.startswith("dec_blocks.0.") for n in metas[1])
    assert any(n.startswith("dec_blocks.3.") for n in metas[0])


def test_pipeline_train_step_equals_single_process(runs):
    """make_train_step(pipeline_group=...) over 2 stages of 2 micro-batches:
    the loss, the clip's norm over both stages' blocks, and each stage's
    gradients against the single-process step on one pass over the batch
    (WHOLE_GRAD_TOL); the stages hold disjoint blocks."""
    res, _, _ = runs
    held = [set(out["pp_step_held"]) for out in res[2]]
    assert not {n for n in held[0] & held[1] if "_blocks." in n}
    for out in res[2]:
        _same_step(out["pp_step"], grad_tol=WHOLE_GRAD_TOL,
                   norm_tol=WHOLE_GRAD_TOL, params=False)


def test_pipeline_replicas_averaged_over_stages(runs):
    """Each GPipe stage computes its own copy of the rest of the step; its
    gradients are averaged over the stages, so the replicas stay equal
    when the copies differ (a change planted in one stage's gradient of
    center_head.proj.weight): every replicated parameter equal on both
    stages after the step, and without the average the planted one apart."""
    res, _, _ = runs
    a, b = res[2]
    assert a["pp_replicas_True"] and set(a["pp_replicas_True"]) == set(b["pp_replicas_True"])
    assert not any("_blocks." in n for n in a["pp_replicas_True"])
    apart = {avg: [n for n, x in a[f"pp_replicas_{avg}"].items()
                   if not np.array_equal(x, b[f"pp_replicas_{avg}"][n])]
             for avg in (True, False)}
    assert apart[True] == []
    assert "center_head.proj.weight" in apart[False], apart


def test_pipeline_scan_matches_serial_loop(runs):
    res, inp, _ = runs
    blocks = torch.nn.ModuleList(torch.nn.Linear(6, 6) for _ in range(4))
    blocks.load_state_dict(inp["scan_blocks"])
    x = inp["scan_x"].clone().requires_grad_(True)
    a, b, ys = x, x * 2, []
    for blk in blocks:
        a, b = torch.tanh(blk(a)) + b, b * 0.5
        ys.append(a)
    ys = torch.stack(ys)
    ((a ** 2).sum() + ys.sum()).backward()
    for out in res[2]:
        s = out["scan"]
        np.testing.assert_allclose(s["a"], a.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(s["b"], b.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(s["ys"], ys.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(s["gx"], x.grad.numpy(), atol=1e-5)
        for i, gw in s["gw"].items():
            np.testing.assert_allclose(gw, blocks[i].weight.grad.numpy(), atol=1e-5)
    assert sorted(res[2][0]["scan"]["gw"]) == [0, 1]


@pytest.mark.parametrize("route", ["tp", "sp"])
def test_tp_sp_forward_matches_jax(runs, route):
    """(2, 2) meshes: each data row's example against JAX's unsharded
    forward of the whole batch. SP splits N = 5 tokens (4 patches and the
    intrinsic token) over 2 ranks, so the padding shows."""
    res, _, refs = runs
    for r, out in enumerate(res[4]):
        _net_close(out[route], refs["net"], slice(r // 2, r // 2 + 1))
    assert res[4][0]["tp_qkv_rows"] == (72, 48)  # 2 of 4 heads' q, k, v


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_ep_moe_matches_jax(runs, mesh):
    """E = 4 experts, top-2, capacity factor 0.5 (48 routes for 4 x 6
    seats: routes overflow), tokens split over every rank, experts over the
    "expert" axis: each rank's rows and the aux loss against JAX's
    unsharded moe_mlp; and the same tokens with every expert on each rank,
    routed over the world (DDP's MoE)."""
    res, inp, refs = runs
    world = 2 if mesh == "1x2" else 4
    y_ref, aux_ref = (np.asarray(x) for x in refs["moe"])
    n = 24 // world
    for r, out in enumerate(res[world]):
        y, aux, local_shape = out[f"ep_{mesh}"]
        assert local_shape == (2, 16, 32)
        np.testing.assert_allclose(y, y_ref[r * n:(r + 1) * n], atol=MOE_TOL,
                                   rtol=MOE_TOL)
        np.testing.assert_allclose(aux, aux_ref, rtol=MOE_TOL)
        # DDP's route: all experts on each rank, routed over the world
        y, aux = out[f"tokens_{world}"]
        np.testing.assert_allclose(y, y_ref[r * n:(r + 1) * n], atol=MOE_TOL,
                                   rtol=MOE_TOL)
        np.testing.assert_allclose(aux, aux_ref, rtol=MOE_TOL)


def _update_held(got, ref, mult, lr, i, optimizer):
    """Step i's updated parameters against the reference's, by the Adam
    rule above; the gradients of steps 0..i scaled by their clip factors."""
    def clipped(steps, name):
        return [min(1.0, optimizer.gradient_clip_val / s["grad_norm"]) * s["grads"][name]
                for s in steps[:i + 1]]

    for n, p in ref[i]["params"].items():
        gt, gr = clipped(got, n), clipped(ref, n)
        rel = (np.max([np.abs(a - b) for a, b in zip(gt, gr)], axis=0)
               / (np.max([np.abs(b) for b in gr], axis=0) + 1e-30))
        tol = lr[i] * mult[n] * (ROUTE_UPDATE_TOL + np.minimum(
            4 * rel, 2 * (1 + optimizer.weight_decay))) + 1e-7
        gap = np.abs(got[i]["params"][n] - p)
        assert (gap <= tol).all(), (i, n, float(gap.max()), int((gap > tol).sum()))


def _route_held(r, optimizer):
    """Both steps of a route (loss, gradient norm, every gradient, every
    updated parameter) against the single-process step, beside twice its
    spread."""
    got, ref, spread = r["got"], r["ref"], r["spread"]
    for i, (g, f, e) in enumerate(zip(got, ref, spread)):
        for key, tol in (("loss", LOSS_TOL), ("grad_norm", ROUTE_NORM_TOL)):
            assert abs(g[key] - f[key]) <= tol * abs(f[key]) + 2 * abs(e[key] - f[key]), \
                (i, key, g[key], f[key], e[key])
        assert set(g["grads"]) == set(f["grads"]) and set(g["params"]) == set(f["params"])
        for n, gr in f["grads"].items():
            np.testing.assert_allclose(
                g["grads"][n], gr, rtol=0, err_msg=f"step {i} {n}",
                atol=ROUTE_GRAD_TOL * np.abs(gr).max() + 2 * np.abs(e["grads"][n] - gr).max()
                + 1e-12)
        _update_held(got, ref, r["mult"], r["lr"], i, optimizer)


@pytest.mark.parametrize("route", ["sp_1x2", "sp_2x2", "sp_remat_accum", "tp_1x2",
                                   "tp_remat_accum", "ep_1x2", "ep_2x2"])
def test_sp_tp_ep_train_step_equals_single_process(runs, route):
    """make_train_step under sequence parallelism (sp_mesh; (1, 2), (2, 2),
    and (1, 2) with remat "dots" and 2 micro-batches), on a TP-sharded model
    ((1, 2), and with remat "dots" and 2 micro-batches: the all-reduces of
    the checkpointed blocks replayed) and an EP-sharded MoE model (E 4, top-2, routes overflowing;
    (1, 2), (2, 2)): two steps against the single-process step on the
    whole batch, TP's and EP's slices gathered whole. Every rank's replicas
    and gathered shards are equal."""
    from tests.torch_parallel_worker import MOE_TRAIN

    res, _, _ = runs
    world = 4 if route.endswith("2x2") else 2
    _route_held(res[world][0]["steps"][route], MOE_TRAIN.optimizer)
    sums = [out["route_checksums"][route] for out in res[world]]
    assert all(s == sums[0] for s in sums[1:])
    if route.startswith("tp"):
        assert res[2][0]["tp_step_qkv_rows"] == (72, 48)  # 2 of 4 heads' q, k, v
    if route.startswith("ep"):
        assert res[world][0]["ep_step_local_experts"] == (2, 48, 192)


def test_sp_train_step_matches_jax(runs):
    """The port's SP step on a (1, 2) mesh (gloo) against JAX's
    make_train_step(sp_mesh=...) on a (1, 2) mesh of virtual CPU devices:
    both steps' loss, gradient norm, gradients and updated parameters, by
    tests/test_torch_training.py's tolerances (float32 on both sides, the
    compositing backward summed in other orders)."""
    from test_torch_training import GRAD_TOL as JAX_GRAD_TOL
    from test_torch_training import LOSS_TOL as JAX_LOSS_TOL

    res, _, refs = runs
    r = res[2][0]["steps"]["sp_1x2"]
    want = refs["sp_step"]
    for i, (g, j) in enumerate(zip(r["got"], want)):
        np.testing.assert_allclose(g["loss"], j["loss"], rtol=JAX_LOSS_TOL)
        np.testing.assert_allclose(g["grad_norm"], j["grad_norm"], rtol=JAX_GRAD_TOL)
        assert set(g["grads"]) == set(j["grads"])
        for n, gj in j["grads"].items():
            np.testing.assert_allclose(g["grads"][n], gj, rtol=0,
                                       atol=JAX_GRAD_TOL * np.abs(gj).max() + 1e-12,
                                       err_msg=f"step {i} {n}")
        _update_held(r["got"], want, r["mult"], r["lr"], i, worker.TINY_TRAIN.optimizer)


def test_sp_tp_ep_train_alone():
    """make_train_step refuses sequence, tensor or expert parallelism beside
    another route (JAX's forward takes one mesh), before any collective."""
    cfg = worker.TINY_TRAIN
    model = init_vicasplat(cfg.model, torch.Generator().manual_seed(0), "cpu")
    opt = AdamW(model, cfg.optimizer)
    with pytest.raises(ValueError, match="train alone"):
        make_train_step(cfg, model, opt, sp_mesh=object(), ddp_group=object())
    tp = GradSplit(reduce=None, divisor=1, norm=None, mesh=None, mesh_size=1)
    mark_split([model.backbone.dec_blocks[0].attn.qkv.weight], tp)
    with pytest.raises(ValueError, match="train alone"):
        make_train_step(cfg, model, opt, sp_mesh=object())
    mark_split([model.backbone.dec_blocks[0].mlp.fc1.weight], dataclasses.replace(tp))
    with pytest.raises(ValueError, match="train alone"):
        make_train_step(cfg, model, opt)
