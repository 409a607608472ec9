"""Optimizers (own copy of the reference's ``training/optim.py``): AdamW
and a factored-second-moment Adafactor for the largest configs, whose
full fp32 Adam state would not fit beside the weights.

Pure functions over the nested parameter dict, as in the reference:
``init(params) -> OptState`` and ``update(params, grads, state) ->
(new_params, new_state)``. Every update computes in fp32 and casts the
new parameter back to its own dtype (``torch.optim.AdamW`` would do its
arithmetic in the bf16 parameter dtype). ``OptState.step`` is an int32
tensor, and the learning rate is computed from it in fp32.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch


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
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


# ----------------------------- AdamW ---------------------------------------

def adamw_init(params) -> OptState:
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
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
        g = g.float()
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        u = (m2 / b1t) / (torch.sqrt(v2 / b2t) + eps)
        u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), m2, v2

    new_p, m, v = _unzip3(tree_map(upd, params, grads, state.m, state.v))
    return new_p, OptState(step=step, m=m, v=v)


# --------------------------- Adafactor -------------------------------------

def _factored(p) -> bool:
    return p.dim() >= 2


def adafactor_init(params) -> OptState:
    def v_init(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p):
            return (torch.zeros(p.shape[:-1], **f32),
                    torch.zeros(p.shape[:-2] + p.shape[-1:], **f32))
        return torch.zeros(p.shape, **f32)
    return OptState(
        step=_zero_step(params),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                         device=p.device), params),
        v=tree_map(v_init, params))


def adafactor_update(params, grads, state: OptState, *, lr=None, b1=0.9,
                     decay=0.99, eps=1e-30, weight_decay=0.0):
    """Adafactor with a bf16 first moment, the second moment factored into
    row and column means for every leaf of ndim ≥ 2, and the update
    clipped at RMS 1.0."""
    step = state.step + 1
    if lr is None:
        lr = cosine_lr(step, base_lr=1e-3)

    def upd(p, g, m, v):
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
