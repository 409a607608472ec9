"""Chunked Pipeline Parallelism (CPP) for long-context prefill (§5.1) —
the counterpart of the reference's ``repro/serving/cpp.py``.

A request's input is cut into ``prefill_chunk``-token chunks that flow
through X pipeline stages: stage s owns a contiguous slice of L/X layers
and the KV its slice has accumulated for the chunks it has already run,
so when chunk i reaches it, every key chunk i attends (chunks ≤ i, by
autoregressivity) is resident. Only one activation crosses a stage
boundary per chunk, and the KV ends up sharded by layer across the
stages — the layout layer-wise store-back (§5.2) wants.

One controller drives the stage mesh (``launch.mesh.make_stage_mesh``
or an explicit ``Mesh``): the schedule is the GPipe wavefront of
C + X − 1 microsteps; in microstep t stage s runs chunk t − s when it
exists, and the bubbles run nothing and commit nothing. The reference's
``ppermute`` to the next stage is a copy to that stage's device, and its
final broadcast of the last stage's activations a copy to the embedding's
device. A stage's body is the chunked extend of ``attention_block`` at a
runtime offset (on CUDA, the chunked-prefill kernel).

The uniform dense stack only, as in the reference (the paper's dummy
LLaMA2-70B is dense).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.shardings import collective
from repro_torch.models.layers import DTYPE, attention_block, mlp_block, rms_norm
from repro_torch.models.transformer import _embed, _layer, _logits_at, prefill


def _stage_body(x, p_attn, p_mlp, cfg: ModelConfig, k_buf, v_buf,
                offset: int):
    """This stage's layer slice on one chunk x (B, C, D) at absolute
    position ``offset``; its (L_s, B, S, KV, Dh) buffers take the chunk's
    KV in place. Returns the chunk's activations after the slice."""
    h = x
    for l in range(k_buf.shape[0]):
        y, _ = attention_block(h, _layer(p_attn, l), cfg,
                               cache=(k_buf[l], v_buf[l]), cache_len=offset)
        h = h + y
        h = h + mlp_block(h, _layer(p_mlp, l), cfg)
    return h


def cpp_prefill(params, tokens, cfg: ModelConfig, mesh, *,
                stage_axis: str = "stage", prefill_chunk: int = 1024):
    """Pipelined prefill of ONE long request over the X = ``mesh``'s
    ``stage_axis`` stages. tokens (B, S) with S % prefill_chunk == 0;
    parameters stacked (n_layers, ...) with n_layers % X == 0 (stage s
    holds layers [s·L/X, (s+1)·L/X) on its device).

    Returns (last-position logits (B, V) fp32 on the embedding's device,
    (k, v)): k and v are lists of the stages' (L/X, B, S, KV, Dh)
    buffers, each on its stage's device — the KV sharded by layer.
    ``cpp_prefill.last_schedule`` records, per microstep, the chunk each
    stage ran (None for a bubble)."""
    if cfg.attention_layers != cfg.n_layers or cfg.encoder_layers \
            or (cfg.moe is not None and cfg.moe.every == 1):
        raise ValueError(f"CPP covers the uniform dense stack; {cfg.name} "
                         f"({cfg.kind}) is not one")
    X = mesh.shape[stage_axis]
    B, S = tokens.shape
    assert S % prefill_chunk == 0 and cfg.n_layers % X == 0
    C = S // prefill_chunk
    L_s = cfg.n_layers // X
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    devs = [mesh.devices[s] for s in range(X)]

    x_emb = _embed(params, tokens, cfg)          # (B, S, D)
    stages = []
    for s, dev in enumerate(devs):
        lo, hi = s * L_s, (s + 1) * L_s
        stages.append((
            {k: t[lo:hi].to(dev) for k, t in params["attn"].items()},
            {k: t[lo:hi].to(dev) for k, t in params["mlp"].items()},
            torch.zeros((L_s, B, S, KV, Dh), dtype=DTYPE, device=dev),
            torch.zeros((L_s, B, S, KV, Dh), dtype=DTYPE, device=dev)))

    inbox: list = [None] * X     # what each stage takes at this microstep
    h_last = None
    schedule = []
    for t in range(C + X - 1):
        nxt: list = [None] * X
        ran = []
        for s in range(X):
            c = t - s                            # which chunk this stage sees
            if not 0 <= c < C:
                ran.append(None)                 # a bubble: nothing to commit
                continue
            ran.append(c)
            p_attn, p_mlp, k_buf, v_buf = stages[s]
            x = x_emb[:, c * prefill_chunk:(c + 1) * prefill_chunk].to(
                devs[0]) if s == 0 else inbox[s]
            y = _stage_body(x, p_attn, p_mlp, cfg, k_buf, v_buf,
                            c * prefill_chunk)
            if s + 1 < X:
                with collective("collective-permute"):
                    nxt[s + 1] = y.to(devs[s + 1])   # to the next stage
            elif c == C - 1:
                h_last = y
        inbox = nxt
        schedule.append(tuple(ran))
    cpp_prefill.last_schedule = schedule
    with collective("collective-permute"):
        h_last = h_last.to(x_emb.device)
    h_last = rms_norm(h_last, params["final_ln"], cfg.norm_eps)
    logits = _logits_at(params, h_last[:, -1:, :], cfg)[:, 0]
    return logits, ([st[2] for st in stages], [st[3] for st in stages])


cpp_prefill.last_schedule = []


def cpp_reference(params, tokens, cfg: ModelConfig):
    """Single-device oracle: plain full prefill (same math, no pipeline).
    Returns (logits (B, V), (k, v) (L, B, S, KV, Dh) each)."""
    logits, caches = prefill(params, tokens, cfg)
    return logits, (caches.kv.k, caches.kv.v)
