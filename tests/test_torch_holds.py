"""vicasplat_tpu_torch/diagnostics/holds.py, the checks that chip_smoke.py
and the four-card run share, on the CPU: K1's dQ rule against its own
rounding (dq_same_rounding) passes the bf16 algorithm summed in another
order, with dQ written as bf16, and fails a wrong dQ where the k1-bwd rule cannot tell (keys with a
large common component), and the step records' gaps and merges."""
import math

import pytest
import torch

from vicasplat_tpu_torch.diagnostics import holds
from vicasplat_tpu_torch.kernels.flash_attn import (
    attention_backward_reference,
    attention_lse_reference,
    attention_reference,
)

torch.set_num_threads(1)


def _inputs(common: float, seed: int = 0, q_scale: float = 0.3):
    """q, k, v, do in bf16 as a decoder's at random init: keys and values
    share a common component `common` times their spread (a larger
    `q_scale` peaks the softmax on a few keys, so that dQ's largest entry
    sums terms of one sign); O and lse of the float32 forward, O rounded to
    bf16 as the kernel's forward hands it on."""
    g = torch.Generator().manual_seed(seed)
    B, Sq, Sk, H, D = 1, 128, 512, 2, 64

    def rand(*s):
        return torch.randn(*s, generator=g)

    q = (q_scale * rand(B, Sq, H, D)).bfloat16()
    k = (rand(B, Sk, H, D) + common * rand(1, 1, H, D)).bfloat16()
    v = (rand(B, Sk, H, D) + common * rand(1, 1, H, D)).bfloat16()
    do = rand(B, Sq, H, D).bfloat16()
    o32 = attention_reference(q, k, v)
    return q, k, v, o32, attention_lse_reference(q, k), do


def _kernel_dq(q, k, v, o, lse, do, tile: int = 64, start: int = 0,
               out=torch.bfloat16):
    """dQ as K1's bf16 backward takes it: dS in float32 rounded to bf16,
    its product with K accumulated in float32 one key tile at a time (from
    key `start`: a kernel that skips the first tiles), written as `out`."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, dof = (x.float().transpose(1, 2) for x in (q, k, v, o, do))
    p = torch.exp(qf @ kf.transpose(-1, -2) * scale - lse[..., None])
    ds = (p * (dof @ vf.transpose(-1, -2) - (dof * of).sum(-1, keepdim=True))).bfloat16()
    acc = torch.zeros_like(qf)
    for j in range(start, kf.shape[-2], tile):
        acc = acc + ds[..., j:j + tile].float() @ kf[..., j:j + tile, :]
    return (acc * scale).transpose(1, 2).to(out)


@pytest.mark.parametrize("common,q_scale", [(0.0, 0.3), (3.0, 0.3), (0.0, 8.0)])
def test_dq_rule_passes_the_kernels_rounding(common, q_scale):
    """Written as float32, the kernel's dQ is far inside the rule; written
    as bf16, as K1 writes it, within it with room, and the tolerance is
    FLASH_BWD_FLOOR of the sum of |dS| |K| plus half a bf16 spacing at dQ's
    largest entry (2^-9 to 2^-8 of it)."""
    q, k, v, o32, lse, do = _inputs(common, q_scale=q_scale)
    o = o32.bfloat16()
    r = holds.dq_same_rounding(q, k, v, o, lse, do,
                               _kernel_dq(q, k, v, o, lse, do, out=torch.float32))
    assert r["ok"] and r["ratio"] < 0.1, r
    _out_allowance(r, torch.float32)
    r = holds.dq_same_rounding(q, k, v, o, lse, do, _kernel_dq(q, k, v, o, lse, do))
    assert r["ok"] and r["ratio"] < 0.7, r
    _out_allowance(r, torch.bfloat16)


def _out_allowance(r: dict, dtype):
    """The tolerance past FLASH_BWD_FLOOR of the sum of |dS| |K| is half
    the spacing of `dtype` at dQ's largest entry: eps/4 to eps/2 of it."""
    out_rel = r["effective_rel"] - holds.FLASH_BWD_FLOOR * r["cancel"]
    eps = torch.finfo(dtype).eps
    assert eps / 4 * 0.999 <= out_rel <= eps / 2 * 1.001, r


def test_dq_rule_allows_the_bf16_output_where_nothing_cancels():
    """A softmax peaked on a few keys: dQ's largest entry sums terms of one
    sign (cancel near 1), and dQ's rounding to bf16 alone then exceeds
    FLASH_BWD_FLOOR of that sum (as on the card, in the train mode's K1
    backward); the rule's allowance for the output's rounding passes it."""
    q, k, v, o32, lse, do = _inputs(0.0, q_scale=4.0)
    o = o32.bfloat16()
    r = holds.dq_same_rounding(q, k, v, o, lse, do, _kernel_dq(q, k, v, o, lse, do))
    assert r["cancel"] < 1.2, r
    assert r["rel"] > holds.FLASH_BWD_FLOOR * r["cancel"], r
    assert r["ok"], r


def test_dq_rule_fails_what_the_k1_bwd_rule_allows():
    """With a common key component, O's rounding in D alone leaves the
    exact algorithm's dQ about its own size from the float32 backward (so
    SDPA's error, and the k1-bwd rule's tolerance, are that large), while
    the rule against the kernel's own rounding rejects that dQ (a D taken
    from another O than the one the kernel was given), one with a key tile
    dropped and one with a column negated, and passes the same algorithm
    without dS's rounding to bf16."""
    q, k, v, o32, lse, do = _inputs(3.0)
    o = o32.bfloat16()
    exact = attention_backward_reference(q, k, v, o32, lse, do)[0]
    dq = _kernel_dq(q, k, v, o, lse, do)
    assert (dq - exact).abs().max() > 0.5 * exact.abs().max()
    dropped = _kernel_dq(q, k, v, o, lse, do, start=64)
    negated = dq.clone()
    negated[..., 5] *= -1
    for wrong in (exact, dropped, negated):
        r = holds.dq_same_rounding(q, k, v, o, lse, do, wrong)
        assert not r["ok"] and r["ratio"] > 5, r
    unrounded = attention_backward_reference(q, k, v, o, lse, do)[0]
    assert holds.dq_same_rounding(q, k, v, o, lse, do, unrounded)["ok"]


def test_route_gaps_requires_what_the_reference_holds():
    ref = {"loss": 2.0, "grad_norm": 1.0, "group_norms": {"a": 1.0},
           "update_mass": {"a": 4.0}, "update_sum": {"a": 1.0}}
    got = dict(ref, loss=2.0 + 2e-6, update_sum={"a": 1.2})
    gaps = holds.route_gaps(got, ref)
    assert gaps["loss"] == pytest.approx(1e-6) and gaps["signed"] == pytest.approx(0.05)
    with pytest.raises(KeyError):
        holds.route_gaps({k: v for k, v in got.items() if k != "update_mass"}, ref)
    assert holds.route_gaps(got, {"loss": 2.0}) == {"loss": pytest.approx(1e-6)}


def test_step_and_update_records_of_a_step():
    """step_record's group norms and update mass of one AdamW step on a
    small module, and update_record within AdamW's bound (update_gaps
    empty); a group that did not move is reported."""
    from vicasplat_tpu_torch.training.optimizer import AdamW, OptimizerConfig

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    opt = AdamW(model, OptimizerConfig(lr=1e-2, warm_up_steps=1, cosine_annealing=False))
    before = holds.host_copy(model)
    model(torch.randn(5, 4)).square().sum().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    opt.step(g_norm=torch.tensor(1.0))
    rec = holds.step_record(model, {"loss": 1.0, "grad_norm": 1.0}, before=before)
    for grp in ("0", "1"):
        want = math.sqrt(sum(float((g.double() ** 2).sum()) for n, g in grads.items()
                             if n.startswith(grp + ".")))
        assert rec["group_norms"][grp] == pytest.approx(want)
        assert rec["update_mass"][grp] > 0
    assert rec["replica_sums"] == rec["param_sums"]
    upd = holds.update_record(opt, before)
    assert holds.update_gaps([upd]) == [] and upd["lr"] > 0
    still = holds.update_record(opt, holds.host_copy(model))
    assert holds.update_gaps([still])
