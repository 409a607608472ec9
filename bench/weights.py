"""Weights drawn from the seed on the device, in the layout the port's
``models.transformer.init_params`` returns (a dense uniform stack), with
the published model's function.

Every random leaf is a view of one bf16 buffer filled by a few large
``normal_`` calls from a ``torch.Generator`` on the device, then scaled
leaf by leaf in place. The port's padding carries zeros: the padded
query heads' ``wq`` columns and ``wo`` rows, and the padded vocabulary's
``embed`` rows and ``lm_head`` columns, so the padded model computes the
published one. Norm weights are ones. The same tensors go to the port
and to the plain reference.
"""
from __future__ import annotations

import math

import torch

DRAW_ELEMS = 1 << 30       # elements per normal_ call


def _leaves(d: dict) -> list:
    """(key path, shape, scale) of every random leaf."""
    D, L = d["d_model"], d["layers"]
    Hp, KV, Dh, F, Vp = d["padded_heads"], d["kv_heads"], d["head_dim"], \
        d["d_ff"], d["padded_vocab"]
    s_attn = math.sqrt(2.0 / (D + d["heads"] * Dh))
    s_mlp = math.sqrt(2.0 / (D + F))
    return [
        (("embed",), (Vp, D), D ** -0.5),
        (("lm_head",), (D, Vp), D ** -0.5),
        (("attn", "wq"), (L, D, Hp * Dh), s_attn),
        (("attn", "wk"), (L, D, KV * Dh), s_attn),
        (("attn", "wv"), (L, D, KV * Dh), s_attn),
        (("attn", "wo"), (L, Hp * Dh, D), s_attn),
        (("mlp", "w1"), (L, D, F), s_mlp),
        (("mlp", "w2"), (L, F, D), s_mlp),
        (("mlp", "w3"), (L, D, F), s_mlp),
    ]


def dims(cfg) -> dict:
    """The sizes ``_leaves`` reads, from the port's ``ModelConfig``."""
    return dict(d_model=cfg.d_model, layers=cfg.n_layers, heads=cfg.n_heads,
                padded_heads=cfg.padded_heads, kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
                padded_vocab=cfg.padded_vocab, qk_norm=cfg.qk_norm)


def draw(d: dict, seed: int, device) -> dict:
    """The parameter dict for the sizes ``d`` (``dims``), drawn from
    ``seed`` on ``device``."""
    device = torch.device(device)
    leaves = _leaves(d)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    buf = torch.empty(total, dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    for lo in range(0, total, DRAW_ELEMS):
        buf[lo:lo + DRAW_ELEMS].normal_(generator=gen)
    params: dict = {"attn": {}, "mlp": {}}
    off = 0
    for path, shape, scale in leaves:
        n = math.prod(shape)
        leaf = buf[off:off + n].view(shape).mul_(scale)
        off += n
        node = params
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = leaf
    H, Dh, V = d["heads"], d["head_dim"], d["vocab"]
    params["attn"]["wq"][:, :, H * Dh:] = 0
    params["attn"]["wo"][:, H * Dh:, :] = 0
    params["embed"][V:] = 0
    params["lm_head"][:, V:] = 0

    def ones(*shape):
        return torch.ones(shape, dtype=torch.bfloat16, device=device)

    L, D = d["layers"], d["d_model"]
    params["final_ln"] = ones(D)
    params["attn"]["ln"] = ones(L, D)
    params["mlp"]["ln"] = ones(L, D)
    if d["qk_norm"]:
        params["attn"]["q_norm"] = ones(L, Dh)
        params["attn"]["k_norm"] = ones(L, Dh)
    return params
