"""Optimizers (own copy of the reference's ``training/optim.py``): AdamW
and a factored-second-moment Adafactor for the largest configs, whose
full fp32 Adam state would not fit beside the weights.

Pure functions over the nested parameter dict, as in the reference:
``init(params) -> OptState`` and ``update(params, grads, state) ->
(new_params, new_state)``. Every update computes in fp32 and casts the
new parameter back to its own dtype (``torch.optim.AdamW`` would do its
arithmetic in the bf16 parameter dtype). ``OptState.step`` is an int32
tensor, and the learning rate is computed from it in fp32.

A ``launch.shardings.Sharded`` parameter keeps its state sharded like it
(a replica per pod, as the parameter) and is updated where each shard
lives. AdamW is elementwise. Adafactor reduces across a leaf's shards
wherever the whole-leaf update reduces — the row and column means of the
squared gradient, the mean of the row mean, the RMS clip over the whole
leaf: each shard's partial sums are summed, within its replica, on the
device of the reduced state's slice and sent back.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.launch.shardings import Sharded, collective, position_device


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar: updates applied so far
    m: Any              # first moment, a dict like the params
    v: Any              # full v (adamw) or (v_row, v_col) pairs (adafactor)


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same keys; the first
    tree's structure is the result's."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def cosine_lr(step, base_lr=3e-4, warmup=100, total=10_000, min_frac=0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine decay to
    ``min_frac`` × ``base_lr`` at ``total``: an fp32 tensor."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = base_lr * (step + 1) / warmup
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def _zero_step(params) -> torch.Tensor:
    leaf = next(iter(tree_leaves(params)))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def _unzip3(tree):
    """A dict of (a, b, c) leaves → three dicts of its structure."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(3))


def tree_leaves(tree):
    """The tensors of a nested dict, a sharded leaf's shards in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, Sharded):
        yield from tree.shards.values()
    else:
        yield tree


def _on(x, device):
    """A scalar (a tensor on the step's device, or a number) for use
    beside a tensor on ``device``."""
    return x.to(device) if isinstance(x, torch.Tensor) else x


def _each(fn, p, *rest):
    """``fn`` on a tensor leaf, or on each aligned shard of sharded
    leaves."""
    if isinstance(p, Sharded):
        return p.map(fn, *rest)
    return fn(p, *rest)


# ----------------------------- AdamW ---------------------------------------

def adamw_init(params) -> OptState:
    zeros32 = lambda p: _zeros_like(p, torch.float32)
    return OptState(step=_zero_step(params), m=tree_map(zeros32, params),
                    v=tree_map(zeros32, params))


def adamw_update(params, grads, state: OptState, *, lr=None, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1):
    step = state.step + 1
    if lr is None:
        lr = cosine_lr(step)
    b1t = 1 - b1 ** step.float()
    b2t = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        dev = p.device
        g = g.float()
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        u = (m2 / _on(b1t, dev)) / (torch.sqrt(v2 / _on(b2t, dev)) + eps)
        u = u + weight_decay * p.float()
        return (p.float() - _on(lr, dev) * u).to(p.dtype), m2, v2

    new_p, m, v = _unzip3(tree_map(lambda *a: _each(upd, *a), params, grads,
                                   state.m, state.v))
    return new_p, OptState(step=step, m=m, v=v)


# --------------------------- Adafactor -------------------------------------

def _factored(p) -> bool:
    return p.ndim >= 2


def adafactor_init(params) -> OptState:
    def v_init(p):
        if isinstance(p, Sharded):
            if not _factored(p):
                return _zeros_like(p, torch.float32)
            return (_reduced_zeros(p, -1), _reduced_zeros(p, -2))
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p):
            return (torch.zeros(p.shape[:-1], **f32),
                    torch.zeros(p.shape[:-2] + p.shape[-1:], **f32))
        return torch.zeros(p.shape, **f32)
    return OptState(
        step=_zero_step(params),
        m=tree_map(lambda p: _zeros_like(p, torch.bfloat16), params),
        v=tree_map(v_init, params))


def _zeros_like(p, dtype):
    return _each(lambda t: torch.zeros(t.shape, dtype=dtype,
                                       device=t.device), p)


def _reduced_zeros(p: Sharded, dim: int) -> Sharded:
    """fp32 zeros of ``p`` without axis ``dim``, sharded like the rest of
    ``p``."""
    dim %= p.ndim
    spec = p.spec[:dim] + p.spec[dim + 1:]
    shape = p.shape[:dim] + p.shape[dim + 1:]
    return Sharded.build(p.mesh, spec, shape, lambda index, dev: torch.zeros(
        [len(range(*s.indices(n))) for s, n in zip(index, shape)],
        dtype=torch.float32, device=dev), p.pod)


def _reduced_axes(p: Sharded, spec) -> tuple:
    """The axes of a key of ``p``'s state reduced to ``spec``: 'pod' for
    a replicated leaf, then the spec's."""
    return ("pod",) * p.pod + tuple(a for a in spec if a is not None)


def _reduced_key(p: Sharded, spec, coords: dict) -> tuple:
    return tuple(coords[a] for a in _reduced_axes(p, spec))


def _mean_over(p: Sharded, parts, spec, n: int) -> dict:
    """The mean along one axis of ``p`` (``n`` long) from ``parts(key)``,
    each shard's partial sum along it: the partials summed into the
    slices of the reduced ``spec``, on their devices → {reduced key:
    mean}."""
    acc: dict = {}
    for key in p.shards:
        c = p.coords(key)
        k = _reduced_key(p, spec, c)
        dev = position_device(p.mesh, {a: c[a] for a in _reduced_axes(p, spec)})
        t = parts(key)
        with collective("all-reduce"):
            t = t.to(dev)
        acc[k] = t if k not in acc else acc[k] + t
    return {k: t / n for k, t in acc.items()}


def _adafactor_sharded(p: Sharded, g: Sharded, m: Sharded, v, *, lr, b1,
                       decay, eps, weight_decay):
    """``adafactor_update``'s leaf update on a sharded leaf: the same
    arithmetic with every reduction summed across the leaf's shards.
    Each full-size fp32 temporary lives for one shard at a time (u is
    computed again for the clipped update rather than kept)."""
    def g2(key):
        t = g.shards[key].float()
        return t * t + eps

    if _factored(p):
        vr, vc = v
        rows = _mean_over(p, lambda k: g2(k).sum(-1), vr.spec, p.shape[-1])
        cols = _mean_over(p, lambda k: g2(k).sum(-2), vc.spec, p.shape[-2])
        vr2 = vr.with_shards({
            k: decay * t + (1 - decay) * rows[k] for k, t in vr.shards.items()})
        vc2 = vc.with_shards({
            k: decay * t + (1 - decay) * cols[k] for k, t in vc.shards.items()})
        rm_spec = vr.spec[:-1]
        row_mean = _mean_over(vr2, lambda k: vr2.shards[k].sum(-1), rm_spec,
                              vr.shape[-1])
        v2 = (vr2, vc2)

        def u_of(key):
            c = p.coords(key)
            dev = p.shards[key].device
            denom = (vr2.part(c, dev)[..., None]
                     / row_mean[_reduced_key(p, rm_spec, c)].to(dev)[
                         ..., None, None]) * vc2.part(c, dev)[..., None, :]
            return g.shards[key].float() * torch.rsqrt(denom + eps)
    else:
        v2 = v.with_shards({
            k: decay * t + (1 - decay) * g2(k) for k, t in v.shards.items()})

        def u_of(key):
            return g.shards[key].float() * torch.rsqrt(v2.shards[key] + eps)
    # update clipping at RMS 1.0, over the whole leaf (each replica's)
    sq: dict = {}
    for key in p.shards:
        u = u_of(key)
        sq.setdefault(_reduced_key(p, (), p.coords(key)), []).append(
            (u * u).sum())
        del u
    rms = {}
    for r, parts in sq.items():
        first = position_device(p.mesh, dict(zip(("pod",) * p.pod, r)))
        with collective("all-reduce"):
            ss = sum(t.to(first) for t in parts)
        rms[r] = torch.sqrt(ss / p.numel() + eps)
    new_p, new_m = {}, {}
    for key, t in p.shards.items():
        u = u_of(key) / torch.clamp(
            rms[_reduced_key(p, (), p.coords(key))].to(t.device), min=1.0)
        m2 = b1 * m.shards[key].float() + (1 - b1) * u
        del u
        out = t.float() - _on(lr, t.device) * (m2 + weight_decay * t.float())
        new_p[key], new_m[key] = out.to(t.dtype), m2.to(torch.bfloat16)
    return p.with_shards(new_p), p.with_shards(new_m), v2


def adafactor_update(params, grads, state: OptState, *, lr=None, b1=0.9,
                     decay=0.99, eps=1e-30, weight_decay=0.0):
    """Adafactor with a bf16 first moment, the second moment factored into
    row and column means for every leaf of ndim ≥ 2, and the update
    clipped at RMS 1.0."""
    step = state.step + 1
    if lr is None:
        lr = cosine_lr(step, base_lr=1e-3)

    def upd(p, g, m, v):
        if isinstance(p, Sharded):
            return _adafactor_sharded(p, g, m, v, lr=lr, b1=b1, decay=decay,
                                      eps=eps, weight_decay=weight_decay)
        # each full-size fp32 temporary is dropped as soon as it is used:
        # at llama2-70b's width one is 3.8 GB for a 4-layer w1 stack
        g = g.float()
        g2 = g * g + eps
        if _factored(p):
            vr, vc = v
            vr2 = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
            vc2 = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
            del g2
            denom = (vr2[..., None]
                     / torch.mean(vr2, dim=-1, keepdim=True)[..., None]) \
                * vc2[..., None, :]
            u = g * torch.rsqrt(denom + eps)
            del denom
            v2 = (vr2, vc2)
        else:
            v2 = decay * v + (1 - decay) * g2
            u = g * torch.rsqrt(v2 + eps)
        del g
        # update clipping at RMS 1.0
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms, min=1.0)
        m2 = b1 * m.float() + (1 - b1) * u
        del u
        out = p.float() - lr * (m2 + weight_decay * p.float())
        return out.to(p.dtype), m2.to(torch.bfloat16), v2

    new_p, m, v = _unzip3(tree_map(upd, params, grads, state.m, state.v))
    return new_p, OptState(step=step, m=m, v=v)


def make_optimizer(name: str):
    """(init, update) of ``"adamw"`` or ``"adafactor"``."""
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")
