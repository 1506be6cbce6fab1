"""Mixture-of-experts MLP with top-k routing (port of
vicasplat_tpu/models/moe.py).

A router (dim -> E, no bias, computed in float32) picks each token's top-k
experts; every expert is a 2-layer exact-GELU MLP, its weights stacked on a
leading expert axis in the JAX layout: fc1.w (E, dim, hidden), fc2.w
(E, hidden, dim), so the expert products are `bmm`s with no transpose.

Capacity and priority follow JAX exactly. Each expert seats at most
cap = min(S, max(1, ceil(top_k * S / E * capacity_factor))) routes, S being
every token of the call. Seating is route-major: every token's first choice
is seated before any second choice. A token's gates are renormalised over
its top-k with a 1e-9 floor; a route past its expert's capacity is dropped.

Two dispatch forms compute the same function:
- `moe_mlp`, the index form the model runs: the slots of JAX's cumsum, as
  row index_add / index_select into an (E * cap, C) slot buffer; a dropped
  route writes to one spare row. Shapes are static, so it captures in a
  CUDA graph.
- `moe_mlp_einsum`, JAX's one-hot dispatch and combine tensors (S, E, cap)
  contracted by einsum, on one rank: the plain version that the tests and
  chip_smoke.py hold the index form against. It spends O(S * E * cap * C)
  products on zeros.

Expert parallelism (`ep_group`): each rank holds E / n experts
(parallel/ep.shard_params_ep) and its own tokens. The router probabilities
of every rank are all-gathered so that capacity and seat order are those of
the whole call, as JAX computes them; each rank then keeps its own routes.
Slot buffers go to the experts' owners by all_to_all and the outputs come
back by the reverse all_to_all.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

class ExpertLinear(nn.Module):
    """E stacked linears: w (E, d_in, d_out), b (E, d_out)."""

    def __init__(self, n_experts: int, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n_experts, d_in, d_out))
        self.b = nn.Parameter(torch.zeros(n_experts, d_out))


class Experts(nn.Module):
    def __init__(self, n_experts: int, dim: int, hidden: int):
        super().__init__()
        self.fc1 = ExpertLinear(n_experts, dim, hidden)
        self.fc2 = ExpertLinear(n_experts, hidden, dim)


class MoeMlp(nn.Module):
    """Router + E experts. After `parallel/ep.shard_params_ep` the experts
    hold this rank's E / n of them and `ep_group` names the group."""

    def __init__(self, dim: int, hidden: int, n_experts: int):
        super().__init__()
        self.n_experts = n_experts
        self.router = nn.Linear(dim, n_experts, bias=False)
        self.experts = Experts(n_experts, dim, hidden)
        self.ep_group = None


def route(probs: torch.Tensor, top_k: int, cap: int):
    """(S, E) router probabilities -> per route, route-major (all first
    choices, then all second choices...): expert (K*S,), slot (K*S,), kept
    (K*S,) bool, and the renormalised gates (K*S,)."""
    S, E = probs.shape
    # (S, K), descending; equal probabilities may order otherwise than
    # jax.lax.top_k orders them
    gate_k, idx_k = torch.topk(probs, top_k, dim=-1)
    gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp(min=1e-9)
    e_flat = idx_k.T.reshape(-1)
    g_flat = gate_k.T.reshape(-1)
    onehot = F.one_hot(e_flat, E)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1  # seat within the expert
    return e_flat, pos, pos < cap, g_flat


def _dispatch_combine(probs: torch.Tensor, top_k: int, cap: int):
    """JAX's dense form: (S, E) probabilities -> dispatch (S, E, cap) in
    {0, 1} and combine (S, E, cap) gate weights, summed over the routes."""
    S, E = probs.shape
    e_flat, pos, keep, g_flat = route(probs, top_k, cap)
    onehot = F.one_hot(e_flat, E).float() * keep[:, None]
    slot = F.one_hot(pos.clamp(0, cap - 1), cap).float()
    disp = onehot[:, :, None] * slot[:, None, :]
    comb = disp * g_flat[:, None, None]
    return (disp.reshape(top_k, S, E, cap).sum(0),
            comb.reshape(top_k, S, E, cap).sum(0))


def capacity(S: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    return min(S, max(1, int(math.ceil(top_k * S / n_experts * capacity_factor))))


def _experts_apply(ex: Experts, h: torch.Tensor, dt) -> torch.Tensor:
    """(E_local, cap, dim) slot rows -> expert outputs, exact GELU."""
    h = torch.bmm(h, ex.fc1.w.to(dt)) + ex.fc1.b.to(dt)[:, None, :]
    h = F.gelu(h)
    return torch.bmm(h, ex.fc2.w.to(dt)) + ex.fc2.b.to(dt)[:, None, :]


def _all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's equal-shaped x along dim 0 (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _router_probs(mod: MoeMlp, xt: torch.Tensor) -> torch.Tensor:
    logits = F.linear(xt.float(), mod.router.weight.float())
    return torch.softmax(logits, dim=-1)


def _aux_loss(probs, aux_probs, E: int, token_group=None):
    """The switch load-balance loss on the primary route: probs are this
    rank's router probabilities, aux_probs those of the whole call."""
    primary = F.one_hot(aux_probs.argmax(-1), E).float()
    mean_prob = probs.sum(0)
    if token_group is not None:
        from torch.distributed.nn.functional import all_reduce

        mean_prob = all_reduce(mean_prob, group=token_group)
    return E * (primary.mean(0) * (mean_prob / aux_probs.shape[0])).sum()


def moe_mlp_einsum(mod: MoeMlp, x: torch.Tensor, *, top_k: int = 1,
                   capacity_factor: float = 1.25, dtype=None,
                   return_aux: bool = False):
    """JAX's einsum form of `moe_mlp`, on one rank holding every expert."""
    E = mod.n_experts
    C = x.shape[-1]
    xt = x.reshape(-1, C)
    probs = _router_probs(mod, xt)
    cdt = dtype or x.dtype
    disp, comb = _dispatch_combine(probs, top_k,
                                   capacity(xt.shape[0], E, top_k, capacity_factor))
    expert_in = torch.einsum("sec,sd->ecd", disp.to(cdt), xt.to(cdt))
    out_e = _experts_apply(mod.experts, expert_in, cdt)
    y = torch.einsum("sec,ecd->sd", comb.to(cdt), out_e)
    y = y.reshape(x.shape).to(x.dtype if dtype is None else cdt)
    return (y, _aux_loss(probs, probs, E)) if return_aux else y


def moe_mlp(mod: MoeMlp, x: torch.Tensor, *, top_k: int = 1,
            capacity_factor: float = 1.25, dtype=None, ep_group=None,
            token_group=None, return_aux: bool = False):
    """Drop-in for layers.mlp. x (..., C) -> y (..., C) [, aux].

    ep_group: the group the experts are sharded over (defaults to the
    module's, set by shard_params_ep). Under it every rank passes its own
    tokens, the same count on each; token_group (default: the whole world)
    is the set of ranks whose tokens make up the call, over which capacity
    and seat order are computed. token_group alone (every expert on every
    rank, as under DDP) routes the same way.

    aux is the switch-transformer load-balance loss on the primary route,
    E * sum_e(token_frac_e * mean_prob_e), 1 at perfect balance, over the
    whole call."""
    ep_group = ep_group if ep_group is not None else mod.ep_group
    E = mod.n_experts
    e_local = mod.experts.fc1.w.shape[0]
    if ep_group is None and e_local != E:
        raise ValueError(f"the module holds {e_local} of {E} experts: pass "
                         "the ep_group it was sharded over")
    C = x.shape[-1]
    xt = x.reshape(-1, C)
    S = xt.shape[0]
    probs = _router_probs(mod, xt)
    cdt = dtype or x.dtype

    if ep_group is None and token_group is None:
        cap = capacity(S, E, top_k, capacity_factor)
        e_flat, pos, keep, g_flat = route(probs, top_k, cap)
        y = _index_moe(mod.experts, xt.to(cdt), e_flat, pos, keep, g_flat,
                       E, cap, torch.arange(S, device=x.device).repeat(top_k))
        aux_probs = probs
    else:
        token_group = token_group or dist.group.WORLD
        e_flat, pos, keep, g_flat, tok, cap, aux_probs = _global_route(
            probs, top_k, capacity_factor, E, token_group)
        if ep_group is None:  # every expert here: DDP's ranks
            y = _index_moe(mod.experts, xt.to(cdt), e_flat, pos, keep, g_flat,
                           E, cap, tok)
        else:
            y = _ep_moe(mod, xt.to(cdt), e_flat, pos, keep, g_flat, tok, cap,
                        ep_group)
    y = y.reshape(x.shape).to(x.dtype if dtype is None else cdt)
    if not return_aux:
        return y
    return y, _aux_loss(probs, aux_probs, E, token_group)


def _index_moe(ex: Experts, xt, e_flat, pos, keep, g_flat, E: int, cap: int,
               tok: torch.Tensor) -> torch.Tensor:
    """Index-form dispatch -> experts -> combine on one rank holding all E
    experts. tok: (K*S,) the token row of each route."""
    C = xt.shape[-1]
    spare = E * cap
    dst = torch.where(keep, e_flat * cap + pos, torch.full_like(pos, spare))
    buf = xt.new_zeros(spare + 1, C).index_add(0, dst, xt[tok])
    out = _experts_apply(ex, buf[:spare].reshape(E, cap, C), xt.dtype)
    out = torch.cat([out.reshape(spare, C), out.new_zeros(1, C)])
    return _combine(out[dst], g_flat * keep, tok, xt)


def _combine(rows, gates, tok, xt):
    """sum over a token's routes of gate * expert output: the gates rounded
    to the compute dtype and the products summed in float32, then rounded
    once, as the einsum form's matmul accumulates (top-k terms a token)."""
    w = gates.to(xt.dtype).float()[:, None]
    y = torch.zeros(xt.shape, dtype=torch.float32, device=xt.device)
    return y.index_add(0, tok, rows.float() * w).to(xt.dtype)


def _global_route(probs, top_k: int, capacity_factor: float, E: int, token_group):
    """This rank's routes under the whole call's capacity and seat order:
    the router probabilities of every rank of token_group (the same token
    count on each) all-gathered, routed together, this rank's rows kept
    (k * S + offset + t of the route-major order). Returns (expert, slot,
    kept, gates with gradient, token row of each route, cap, every rank's
    probabilities)."""
    S_local = probs.shape[0]
    all_probs = _all_gather_rows(probs.detach(), token_group)
    S = all_probs.shape[0]
    cap = capacity(S, E, top_k, capacity_factor)
    e_all, pos_all, keep_all, _ = route(all_probs, top_k, cap)
    offset = dist.get_rank(token_group) * S_local
    t = torch.arange(S_local, device=probs.device)
    mine = (torch.arange(top_k, device=probs.device)[:, None] * S + offset
            + t[None, :]).reshape(-1)
    gate_k, _ = torch.topk(probs, top_k, dim=-1)  # the same picks, with gradient
    gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp(min=1e-9)
    return (e_all[mine], pos_all[mine], keep_all[mine], gate_k.T.reshape(-1),
            t.repeat(top_k), cap, all_probs)


def _ep_moe(mod: MoeMlp, xt, e_flat, pos, keep, g_flat, tok, cap: int, ep_group):
    """Expert-parallel index form; see the module docstring."""
    from torch.distributed.nn.functional import all_to_all_single

    E = mod.n_experts
    n_ep = dist.get_world_size(ep_group)
    e_local = mod.experts.fc1.w.shape[0]
    if e_local * n_ep != E:
        raise ValueError(f"{e_local} experts a rank x {n_ep} ranks != {E}")
    C = xt.shape[-1]
    spare = E * cap
    dst = torch.where(keep, e_flat * cap + pos, torch.full_like(pos, spare))
    buf = xt.new_zeros(spare + 1, C).index_add(0, dst, xt[tok])[:spare]
    # slots are grouped by owner (experts r * e_local ...): send each owner
    # its slots, sum what every rank sent (each slot has one writer)
    recv = all_to_all_single(torch.empty_like(buf), buf, group=ep_group)
    h = recv.reshape(n_ep, e_local * cap, C).sum(0).reshape(e_local, cap, C)
    out = _experts_apply(mod.experts, h, xt.dtype).reshape(e_local * cap, C)
    send = out[None].expand(n_ep, e_local * cap, C).reshape(spare, C)
    full = all_to_all_single(torch.empty_like(send), send, group=ep_group)
    full = torch.cat([full, full.new_zeros(1, C)])
    return _combine(full[dst], g_flat * keep, tok, xt)
