"""One rank of tests/test_torch_parallel.py's process groups: gloo over a
FileStore, no JAX. Each rank runs every route of its world size on inputs
the parent wrote (`inputs.pt`) and saves what it computed to
`w<world>_r<rank>.pt`; the parent compares against JAX and the serial
calls."""
import dataclasses
import datetime
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from vicasplat_tpu_torch import parallel as par
from vicasplat_tpu_torch.decoder.splatting import DecoderSplattingConfig
from vicasplat_tpu_torch.models import moe as tmoe
from vicasplat_tpu_torch.models.adapter import GaussianAdapterConfig, Gaussians
from vicasplat_tpu_torch.models.vicanet import VicaNet, VicaNetConfig
from vicasplat_tpu_torch.models.vicasplat import VicaSplat, VicaSplatConfig, init_vicasplat
from vicasplat_tpu_torch.ops.rasterize import RasterizeConfig
from vicasplat_tpu_torch.parallel.mesh import fsdp_placement, shard_params_fsdp
from vicasplat_tpu_torch.training import AdamW, OptimizerConfig, TrainConfig, make_train_step

# tests/test_training.py's tiny_train_cfg with synthetic_pose's linear heads
# (its DPT heads hold 39 M parameters at any width: the steps' time)
TINY_TRAIN = TrainConfig(
    model=VicaSplatConfig(
        backbone=VicaNetConfig(img_size=32, patch_size=16, enc_embed_dim=64,
                               enc_depth=2, enc_num_heads=4, dec_embed_dim=48,
                               dec_depth=4, dec_num_heads=4),
        gaussian_adapter=GaussianAdapterConfig(sh_degree=1),
        gs_center_head_type="linear", gs_param_head_type="linear",
        pts3d_bounds=(0.1, 20.0)),
    decoder=DecoderSplattingConfig(rasterize=RasterizeConfig(
        tile_px=8, dup_hw=(2, 2), max_per_tile=64, chunk=32, tile_group=4)),
    optimizer=OptimizerConfig(lr=1e-3, warm_up_steps=1),
    dtype="float32", remat=False)
# FSDP2's rule at this size: leaves of 4096+ entries shard
FSDP_MIN = 4096


def train_batch(B, seed=0, T=2, V=2, size=32):
    rng = np.random.default_rng(seed)
    K = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32)

    def views(n):
        ext = np.tile(np.eye(4, dtype=np.float32), (B, n, 1, 1))
        ext[:, 1:, :3, 3] = rng.normal(0, 0.05, (B, n - 1, 3))
        return {"image": torch.from_numpy(rng.uniform(0, 1, (B, n, size, size, 3))
                                          .astype(np.float32)),
                "intrinsics": torch.from_numpy(np.broadcast_to(K, (B, n, 3, 3)).copy()),
                "extrinsics": torch.from_numpy(ext),
                "near": torch.ones(B, n), "far": torch.full((B, n), 100.0)}

    return {"context": views(T), "target": views(V)}


def _np(x):
    """A copy (a CPU tensor's .numpy() would share the live parameter's
    memory)."""
    return x.detach().float().cpu().numpy().copy()


def _full(p):
    return p.full_tensor() if hasattr(p, "full_tensor") else p


def _step_results(model, logs):
    """Loss, gradient norm, and every parameter and gradient this rank holds
    (whole, for FSDP2's shards; none of another pipeline stage's blocks)."""
    held = [(n, p) for n, p in model.named_parameters() if not p.is_meta]
    return {"loss": float(logs["loss"]), "grad_norm": float(logs["grad_norm"]),
            "params": {n: _np(_full(p)) for n, p in held},
            "grads": {n: _np(_full(p.grad)) for n, p in held if p.grad is not None}}


def _diff(got, ref):
    """What the parent checks of a step against its reference, per tensor:
    loss and gradient norm of both, the largest gradient gap and gradient,
    the largest parameter gap overall and where the reference's gradient is
    above 1e-4 of its largest (its sign well determined)."""
    rows = {}
    for k, g in ref["grads"].items():
        if k not in got["params"]:  # another pipeline stage's block
            continue
        scale = np.abs(g).max()
        dp = np.abs(got["params"][k] - ref["params"][k])
        sure = np.abs(g) > 1e-4 * scale
        rows[k] = (float(np.abs(got["grads"][k] - g).max()), float(scale),
                   float(dp.max()), float(dp[sure].max(initial=0.0)))
    return {"loss": (got["loss"], ref["loss"]),
            "grad_norm": (got["grad_norm"], ref["grad_norm"]),
            "same_keys": set(got["grads"]) == set(ref["grads"]) & set(got["params"]),
            "rows": rows,
            "checksum": {k: float(v.astype(np.float64).sum())
                         for k, v in got["params"].items()}}


def run_data_parallel(inp, out, world, rank):
    mesh = par.make_mesh()
    # shard_batch and replicate
    x = torch.arange(world * 3 * 2, dtype=torch.float32).reshape(world * 3, 2)
    out["shard_batch"] = _np(par.shard_batch(mesh, {"a": {"b": x}})["a"]["b"])
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(rank + 1))
    out["replicated"] = _np(par.replicate(mesh, lin).weight)

    cfg = TINY_TRAIN
    batch = train_batch(2)
    # the single-process step on the whole batch, and the same batch in
    # micro-batches of one example, as each rank computes them (rank 0 the
    # first two, rank 1 the third)
    refs = (("ref_whole", 1, batch), ("ref", 2, batch),
            ("ref_accum", 4, train_batch(4, seed=1)))
    ref = {}
    for key, A, b in refs[:2] if rank == 0 else refs[2:]:
        m = init_vicasplat(cfg.model, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(dataclasses.replace(cfg, accumulate_steps=A),
                               m, AdamW(m, cfg.optimizer))
        ref[key] = _step_results(m, step(b, 0))
    group = mesh.get_group()
    model = init_vicasplat(cfg.model, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, model, AdamW(model, cfg.optimizer), ddp_group=group)
    got = _step_results(model, step(par.shard_batch(mesh, batch), 0))
    if rank == 0:
        out["ddp"], out["ddp_whole"] = _diff(got, ref["ref"]), _diff(got, ref["ref_whole"])
    out["ddp_checksum"] = _diff(got, got)["checksum"]
    acfg = dataclasses.replace(cfg, accumulate_steps=2)
    model = init_vicasplat(cfg.model, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(acfg, model, AdamW(model, cfg.optimizer), ddp_group=group)
    got = _step_results(model, step(par.shard_batch(mesh, train_batch(4, seed=1)), 0))
    if rank == 1:
        out["ddp_accum"] = _diff(got, ref["ref_accum"])

    model = init_vicasplat(cfg.model, torch.Generator().manual_seed(0), "cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    shard_params_fsdp(mesh, model, min_size=FSDP_MIN)
    placed = {}
    for n, p in model.named_parameters():
        placed[n] = (p.placements[0].dim if hasattr(p, "placements") else None,
                     tuple(p.to_local().shape) if hasattr(p, "to_local") else None)
    out["fsdp_placed"] = placed
    out["fsdp_rule"] = {n: fsdp_placement(s, world, FSDP_MIN) for n, s in shapes.items()}
    step = make_train_step(cfg, model, AdamW(model, cfg.optimizer))
    got = _step_results(model, step(par.shard_batch(mesh, batch), 0))
    if rank == 0:
        out["fsdp"] = _diff(got, ref["ref"])


def run_view_sharded(inp, out, world, rank):
    mesh = par.make_mesh()
    g = Gaussians(**{k: v for k, v in inp["gaussians"].items()})
    for inv in (False, True):
        cfg = DecoderSplattingConfig(make_scale_invariant=inv,
                                     rasterize=RasterizeConfig(**inp["raster"]))
        o = par.decoder_forward_view_sharded(cfg, g, *inp["cams"], (32, 32), mesh)
        out[f"view_{inv}"] = [_np(x) for x in o]


def _net(inp, cfg_key="net_cfg", sd_key="net_sd"):
    model = VicaNet(VicaNetConfig(**inp[cfg_key]))
    model.load_state_dict(inp[sd_key], strict=True)
    return model


def _outs(o):
    return {"inter": [_np(t) for t in o[3]], "cam": _np(o[1])}


def run_pipeline(inp, out, world, rank):
    mesh = par.make_mesh_pipe()
    images, K = inp["images"], inp["K"]
    serial = _net(inp)
    o = serial(images, K, dtype=torch.float32)
    loss = sum((t ** 2).mean() for t in o[3]) + (o[1] ** 2).mean()
    loss.backward()
    model = _net(inp)
    par.shard_params_pp(mesh, model.enc_blocks)
    par.shard_params_pp(mesh, model.dec_blocks)
    o = model(images, K, dtype=torch.float32, pipeline_group=mesh,
              pipeline_n_micro=2)
    loss_p = sum((t ** 2).mean() for t in o[3]) + (o[1] ** 2).mean()
    loss_p.backward()
    out["pp"] = _outs(o)
    out["pp_loss"] = (float(loss_p), float(loss))
    # every gradient this stage holds against the serial one
    ref = dict(serial.named_parameters())
    out["pp_grads"] = {n: (_np(p.grad), _np(ref[n].grad))
                       for n, p in model.named_parameters()
                       if not p.is_meta and p.grad is not None}
    out["pp_meta"] = sorted(n for n, p in model.named_parameters() if p.is_meta)

    # pipeline_scan on its own: a carry of two tensors, collected outputs
    blocks = torch.nn.ModuleList(torch.nn.Linear(6, 6) for _ in range(4))
    blocks.load_state_dict(inp["scan_blocks"])
    x = inp["scan_x"].clone().requires_grad_(True)

    def fn(carry, blk):
        a, b = carry
        a = torch.tanh(blk(a)) + b
        return (a, b * 0.5), a

    (a, b), ys = par.pipeline_scan(fn, blocks, (x, x * 2), mesh, n_micro=2,
                                   collect_outputs=True)
    ((a ** 2).sum() + ys.sum()).backward()
    out["scan"] = {"a": _np(a), "b": _np(b), "ys": _np(ys), "gx": _np(x.grad),
                   "gw": {i: _np(blocks[i].weight.grad)
                          for i in par.pp.stage_range(4, mesh.get_group())}}


def run_pipeline_step(inp, out, world, rank):
    """make_train_step over 2 stages of 2 micro-batches against the
    single-process step: each stage's blocks and the replicated rest."""
    mesh = par.make_mesh_pipe()
    cfg = TINY_TRAIN
    batch = train_batch(2)
    ref = init_vicasplat(cfg.model, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, ref, AdamW(ref, cfg.optimizer))
    ref = _step_results(ref, step(batch, 0))
    model = init_vicasplat(cfg.model, torch.Generator().manual_seed(0), "cpu")
    par.shard_params_pp(mesh, model.backbone.enc_blocks)
    par.shard_params_pp(mesh, model.backbone.dec_blocks)
    step = make_train_step(cfg, model, AdamW(model, cfg.optimizer),
                           pipeline_group=mesh.get_group(), pipeline_n_micro=2)
    got = _step_results(model, step(batch, 0))
    out["pp_step"] = _diff(got, ref)
    out["pp_step_held"] = sorted(got["params"])


def run_pipeline_replicas(inp, out, world, rank):
    """GPipe's replicated rest averaged over the stages (training/step.py
    _average_replicas): a change planted in one stage's gradient of a
    replicated parameter (on the card the render's atomics leave such a
    change, a rounding) moves that stage's update alone without the
    average, and no stage's with it. The parameters that every stage
    holds, after one step each way."""
    from contextlib import nullcontext
    from unittest import mock

    from vicasplat_tpu_torch.training import step as step_module

    mesh = par.make_mesh_pipe()
    batch = train_batch(2)
    for average in (True, False):
        model = init_vicasplat(TINY_TRAIN.model, torch.Generator().manual_seed(0), "cpu")
        par.shard_params_pp(mesh, model.backbone.enc_blocks)
        par.shard_params_pp(mesh, model.backbone.dec_blocks)
        model.center_head.proj.weight.register_hook(
            lambda g: g + rank * 1e-2 * g.abs().max())
        off = (nullcontext() if average else
               mock.patch.object(step_module, "_average_replicas", lambda grads, group: None))
        with off:
            step = make_train_step(TINY_TRAIN, model, AdamW(model, TINY_TRAIN.optimizer),
                                   pipeline_group=mesh.get_group(), pipeline_n_micro=2)
            step(batch, 0)
        out[f"pp_replicas_{average}"] = {
            n: _np(p) for n, p in model.named_parameters()
            if not p.is_meta and not getattr(p, "_pipeline_block", False)}


# tests/test_torch_train.py's toy synthetic_pose train mode
TRAIN_MODE = ["+experiment=synthetic_pose", "mode=train",
              "encoder.backbone.img_size=32", "encoder.backbone.enc_embed_dim=64",
              "encoder.backbone.enc_depth=2", "encoder.backbone.enc_num_heads=4",
              "encoder.backbone.dec_embed_dim=48", "encoder.backbone.dec_depth=2",
              "encoder.backbone.dec_num_heads=4",
              "dataset.synthetic.input_image_shape=[32,32]",
              "dataset.synthetic.n_gaussians=256", "dataset.synthetic.n_scenes=4",
              "dataset.synthetic.n_val_scenes=1", "dataset.synthetic.n_test_scenes=1",
              "data_loader.train.batch_size=2", "trainer.precision=float32",
              "optimizer.warm_up_steps=1", "train.print_log_every_n_steps=1",
              "wandb.mode=offline", "checkpointing.async_save=false",
              "trainer.max_steps=2", "trainer.val_check_interval=0",
              "checkpointing.every_n_train_steps=2"]


def run_train_mode(inp, out, world, rank):
    """main.py's train mode as torchrun starts it (WORLD_SIZE set, the group
    up): DDP over the ranks, rank 0 alone logging and checkpointing."""
    from vicasplat_tpu_torch import main as tmain

    run = os.path.join(inp["root"], "train_mode")
    os.environ["WORLD_SIZE"] = str(world)
    try:
        r = tmain.main([*TRAIN_MODE, f"output_dir={run}",
                        f"checkpointing.output_dir={run}/ckpts"], device="cpu")
    finally:
        del os.environ["WORLD_SIZE"]
    out["train_mode"] = {"logs": r["logs"], "step": r["step"],
                         "checksum": {n: float(p.detach().double().sum())
                                      for n, p in r["model"].named_parameters()}}


def run_tp_sp(inp, out, world, rank):
    images, K = inp["images"], inp["K"]
    mesh = par.make_mesh_2d(2, 2)
    model = par.shard_params_tp(mesh, _net(inp))
    d = mesh.get_local_rank("data")
    with torch.no_grad():
        out["tp"] = _outs(model(images[d:d + 1], K[d:d + 1], dtype=torch.float32))
    out["tp_qkv_rows"] = tuple(model.dec_blocks[0].attn.qkv.weight.shape)
    mesh = par.make_mesh_sp(2, 2)
    model = _net(inp)
    with torch.no_grad():
        o = model(par.sp_shard_batch_only(images, mesh),
                  par.sp_shard_batch_only(K, mesh), dtype=torch.float32,
                  sp_mesh=mesh)
    out["sp"] = _outs(o)


# TINY_TRAIN's decoder MLPs as 4 experts, top-2, capacity factor 0.75:
# routes overflow, so capacity over the whole call and over one rank's
# tokens part
MOE_TRAIN = dataclasses.replace(TINY_TRAIN, model=dataclasses.replace(
    TINY_TRAIN.model, backbone=dataclasses.replace(
        TINY_TRAIN.model.backbone, moe_experts=4, moe_top_k=2,
        moe_capacity_factor=0.75)))
# SP and TP with both of the step's options at once: remat "dots" (blocks
# whose forwards gather or all-reduce, replayed in the backward) and 2
# micro-batches
REMAT_ACCUM = dataclasses.replace(TINY_TRAIN, remat=True, remat_policy="dots",
                                  accumulate_steps=2)


def _reference(cfg, batch, start=None):
    """The single-process step on the whole batch, from init seed 0: two
    steps' results and the model's state after each; step 1 from `start`'s
    parameters when given."""
    model = init_vicasplat(cfg.model, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, model, AdamW(model, cfg.optimizer))
    steps, states = [], []
    for i in range(2):
        if i and start is not None:
            model.load_state_dict(start)
        steps.append(_step_results(model, step(batch, i)))
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    return steps, states


def _perturbed(batch, eps=1e-7):
    """The batch with its context images scaled by 1 + eps."""
    return {"context": dict(batch["context"], image=batch["context"]["image"] * (1 + eps)),
            "target": batch["target"]}


def _route_steps(cfg, model, batch, ref_state, reshard=None, results=_step_results,
                 **kw):
    """Steps 0 and 1 of make_train_step on this rank's `batch`, step 1 from
    the reference's parameters after step 0 (as tests/test_torch_training.py
    holds the port to JAX, so that each step's own errors show; the
    optimizer keeps its own moments). `reshard`: a model sharded as this
    one, from a state dict of the whole model."""
    opt = AdamW(model, cfg.optimizer)
    step = make_train_step(cfg, model, opt, **kw)
    steps = [results(model, step(batch, 0))]
    src = reshard(ref_state) if reshard is not None else None
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(ref_state[n] if src is None else src[n])
    steps.append(results(model, step(batch, 1)))
    return {"got": steps, "mult": dict(opt.mult),
            "lr": [opt.schedule(i) for i in range(2)]}


def _gathered_results(group, cut):
    """_step_results with every sliced tensor made whole: each of `cut`'s
    parameters ({parameter: how to join the ranks' slices}) all-gathered
    over `group` and joined, its gradient too."""
    def join(kind, parts):
        if kind == "qkv":  # each rank's rows [q_r | k_r | v_r]
            return torch.cat([torch.cat([p.chunk(3)[j] for p in parts])
                              for j in range(3)])
        return torch.cat(parts, dim=1 if kind == "row" else 0)

    def whole(x, kind):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.detach().contiguous(), group=group)
        return _np(join(kind, parts))

    def results(model, logs):
        res = _step_results(model, logs)
        for n, p in model.named_parameters():
            if p in cut:
                res["params"][n] = whole(p, cut[p])
                res["grads"][n] = whole(p.grad, cut[p])
        return res

    return results


def _marked(model):
    """The parameters that parallel/tp.py or ep.py sliced (and marked)."""
    return [p for p in model.parameters() if hasattr(p, "_grad_split")]


def _tp_cut(model):
    """{TP-sliced parameter: its join}: a weight by its linear's rule, a
    bias as its linear's rows."""
    kinds = {}
    for name, lin in model.named_modules():
        kind = par.tp.tp_rule(tuple(name.split(".")))
        if isinstance(lin, torch.nn.Linear) and kind is not None:
            kinds[lin.weight] = kind
            if lin.bias is not None:
                kinds[lin.bias] = "col" if kind == "row" else kind
    return {p: kinds[p] for p in _marked(model)}


def _resharder(cfg, shard):
    """A state dict of the whole model -> the named parameters of the same
    model sharded by `shard` (a function of the model)."""
    def reshard(state):
        model = VicaSplat(cfg.model)
        model.load_state_dict(state)
        return dict(shard(model).named_parameters())
    return reshard


def run_sp_tp_ep_steps(inp, out, world, rank):
    """Training under SP, TP and EP against the single-process step on the
    whole batch (the routed MoE in one pass over the whole call, a dense
    step in the micro-batches each "data" row takes), and that step's own
    spread under a 1e-7 relative change of the context images. World 2: SP (1, 2)
    and TP (1, 2), each plain and with remat "dots" and 2 micro-batches, EP
    (1, 2);
    world 4: SP (2, 2), EP (2, 2). The step's results are whole on every
    rank (TP's and EP's slices gathered): rank 0 keeps them."""
    dense = train_batch(2)
    moe_batch = train_batch(world, seed=2)
    init = lambda cfg: init_vicasplat(cfg.model, torch.Generator().manual_seed(0), "cpu")
    micro = dataclasses.replace(TINY_TRAIN, accumulate_steps=2)
    runs = {}

    def run(name, cfg, ref_cfg, batch, mine, model=None, **kw):
        ref, states = _reference(ref_cfg, batch)
        # the reference's own spread: the same steps from images 1e-7 apart
        spread, _ = _reference(ref_cfg, _perturbed(batch), states[0])
        r = _route_steps(cfg, model if model is not None else init(cfg), mine,
                         states[0], **kw)
        runs[name] = dict(r, ref=ref, spread=spread)

    if world == 2:
        mesh = par.make_mesh_sp(1, 2)
        run("sp_1x2", TINY_TRAIN, TINY_TRAIN, dense, par.shard_batch(mesh, dense),
            sp_mesh=mesh)
        run("sp_remat_accum", REMAT_ACCUM, micro, dense,
            par.shard_batch(mesh, dense), sp_mesh=mesh)
        mesh = par.make_mesh_2d(1, 2)
        for name, cfg, ref_cfg in (("tp_1x2", TINY_TRAIN, TINY_TRAIN),
                                   ("tp_remat_accum", REMAT_ACCUM, micro)):
            model = par.shard_params_tp(mesh, init(cfg))
            out["tp_step_qkv_rows"] = tuple(model.backbone.dec_blocks[0].attn.qkv.weight.shape)
            run(name, cfg, ref_cfg, dense, par.shard_batch(mesh, dense),
                model=model, results=_gathered_results(mesh.get_group("model"),
                                                       _tp_cut(model)),
                reshard=_resharder(cfg, lambda m: par.shard_params_tp(mesh, m)))
    else:
        mesh = par.make_mesh_sp(2, 2)
        run("sp_2x2", TINY_TRAIN, micro, dense, par.shard_batch(mesh, dense),
            sp_mesh=mesh)
    ep_shape = (1, 2) if world == 2 else (2, 2)
    mesh = par.make_mesh_ep(*ep_shape)
    model = par.shard_params_ep(mesh, init(MOE_TRAIN))
    out["ep_step_local_experts"] = tuple(
        model.backbone.dec_blocks[0].mlp.experts.fc1.w.shape)
    run("ep_%dx%d" % ep_shape, MOE_TRAIN, MOE_TRAIN, moe_batch,
        par.shard_batch(mesh, moe_batch, ("data", "expert")), model=model,
        results=_gathered_results(mesh.get_group("expert"),
                                  {p: "col" for p in _marked(model)}),
        reshard=_resharder(MOE_TRAIN, lambda m: par.shard_params_ep(mesh, m)))
    # the replicas and the gathered shards are the same on every rank
    out["route_checksums"] = {k: [_diff(g, g)["checksum"] for g in r["got"]]
                              for k, r in runs.items()}
    if rank == 0:
        out["steps"] = runs


def run_ep(inp, out, world, rank, shape):
    mesh = par.make_mesh_ep(*shape)
    mod = tmoe.MoeMlp(*inp["moe_dims"])
    mod.load_state_dict(inp["moe_sd"], strict=True)
    par.shard_params_ep(mesh, mod)
    x = inp["moe_x"]
    n = x.shape[0] // world
    y, aux = tmoe.moe_mlp(mod, x[rank * n:(rank + 1) * n], top_k=2,
                          capacity_factor=0.5, return_aux=True)
    out[f"ep_{shape[0]}x{shape[1]}"] = (_np(y), float(aux),
                                        tuple(mod.experts.fc1.w.shape))
    # every expert on every rank, the call's tokens spread (DDP's MoE)
    whole = tmoe.MoeMlp(*inp["moe_dims"])
    whole.load_state_dict(inp["moe_sd"], strict=True)
    y, aux = tmoe.moe_mlp(whole, x[rank * n:(rank + 1) * n], top_k=2,
                          capacity_factor=0.5, return_aux=True,
                          token_group=dist.group.WORLD)
    out[f"tokens_{world}"] = (_np(y), float(aux))


def main(rank, world, root):
    torch.set_num_threads(1)
    out, errors = {}, []
    try:
        # a rank that fails leaves the others in a collective: time out
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(root, f"store{world}"), world),
            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=90))
        inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
        inp["root"] = root
        routes = ([run_data_parallel, run_view_sharded, run_pipeline,
                   run_pipeline_step, run_pipeline_replicas,
                   lambda *a: run_ep(*a, (1, 2)), run_train_mode,
                   run_sp_tp_ep_steps]
                  if world == 2 else
                  [run_tp_sp, lambda *a: run_ep(*a, (2, 2)), run_sp_tp_ep_steps])
        for fn in routes:
            fn(inp, out, world, rank)
            dist.barrier()
    except Exception:
        errors.append(traceback.format_exc())
        print(errors[-1], file=sys.stderr, flush=True)
    out["errors"] = errors
    torch.save(out, os.path.join(root, f"w{world}_r{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()
