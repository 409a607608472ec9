"""The dense family: a uniform decoder stack of grouped-query attention
(optional per-head q/k RMSNorm, full causal attention) and a SwiGLU MLP,
as the port's ``models.transformer`` serves phi3-mini-3.8b and
qwen3-14b. Its reference is ``bench/reference/model.py``'s
``PlainModel``, its counts ``bench/counts.py``'s ``Arch``."""
from __future__ import annotations

import copy
import dataclasses
import math

from bench import weights
from bench.counts import Arch
from bench.reference.model import PlainModel

#: the file's keys and the port's ``ModelConfig`` fields they set
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "qk_norm": "qk_norm", "tie_word_embeddings": "tie_embeddings"}
KERNELS = ("paged_attention", "flash_prefill")


def held(cfg, config: dict):
    """``cfg`` with the file's norm epsilon and RoPE base, and the keys
    the file lists in its ``reduced`` taken from the file; every other
    width held equal to the file's, and no sliding window."""
    cut = {FIELDS[k]: config[k] for k in config["reduced"] if k in FIELDS}
    if len(cut) != len(config["reduced"]):
        raise ValueError(f"the dense family cannot take {config['reduced']} "
                         f"from the file; it sets {sorted(FIELDS)}")
    cfg = dataclasses.replace(cfg, norm_eps=float(config["rms_norm_eps"]),
                              rope_theta=float(config["rope_theta"]), **cut)
    want = {f: config[k] for k, f in FIELDS.items()}
    want["sliding_window"] = 0
    got = {f: getattr(cfg, f) for f in want}
    if got != want:
        raise ValueError(f"the port's {cfg.name} is not the configuration "
                         f"file's: {got} != {want}")
    return cfg


def port_config(config: dict):
    """The port's registry config of ``port_arch``, held against the
    file."""
    from repro_torch.configs.base import get_config
    return held(get_config(config["port_arch"]), config)


def tiny(config: dict):
    """The port's ``.reduced()`` config of ``port_arch`` with the file's
    norm epsilon, and a copy of the file with its sizes."""
    from repro_torch.configs.base import get_config
    cfg = get_config(config["port_arch"]).reduced()
    cfg = dataclasses.replace(cfg, norm_eps=config["rms_norm_eps"])
    c = copy.deepcopy(config)
    c.update({k: getattr(cfg, f) for k, f in FIELDS.items()})
    return c, cfg


def draw(cfg, seed: int, device) -> dict:
    """The port's parameter dict (``models.transformer.init_params``'s
    layout), drawn from ``seed`` on ``device``. The port's padding
    carries zeros: the padded query heads' ``wq`` columns and ``wo`` rows,
    and the padded vocabulary's ``embed`` rows and ``lm_head`` columns, so
    the padded model computes the published one. Norm weights are ones."""
    D, L, H, Hp, KV, Dh, F, V, Vp = (
        cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.padded_heads,
        cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size,
        cfg.padded_vocab)
    s_attn = math.sqrt(2.0 / (D + H * Dh))
    s_mlp = math.sqrt(2.0 / (D + F))
    embed, lm_head, wq, wk, wv, wo, w1, w2, w3 = weights.normal([
        ((Vp, D), D ** -0.5), ((D, Vp), D ** -0.5),
        ((L, D, Hp * Dh), s_attn), ((L, D, KV * Dh), s_attn),
        ((L, D, KV * Dh), s_attn), ((L, Hp * Dh, D), s_attn),
        ((L, D, F), s_mlp), ((L, F, D), s_mlp), ((L, D, F), s_mlp)],
        seed, device)
    wq[:, :, H * Dh:] = 0
    wo[:, H * Dh:, :] = 0
    embed[V:] = 0
    lm_head[:, V:] = 0
    device = embed.device
    params = {"attn": {"wq": wq, "wk": wk, "wv": wv, "wo": wo},
              "mlp": {"w1": w1, "w2": w2, "w3": w3},
              "embed": embed, "lm_head": lm_head,
              "final_ln": weights.ones(D, device=device)}
    params["attn"]["ln"] = weights.ones(L, D, device=device)
    params["mlp"]["ln"] = weights.ones(L, D, device=device)
    if cfg.qk_norm:
        params["attn"]["q_norm"] = weights.ones(L, Dh, device=device)
        params["attn"]["k_norm"] = weights.ones(L, Dh, device=device)
    return params


def reference(params: dict, cfg, control: bool = False) -> PlainModel:
    """``PlainModel`` at the published sizes ``cfg`` holds; the control
    computes in fp8."""
    arch = dict(layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
                kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
                vocab=cfg.vocab_size, rms_eps=cfg.norm_eps,
                rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)
    return PlainModel(params, arch, "fp8" if control else "bf16")


def counts(config: dict) -> Arch:
    return Arch.of(config)


def _no_kv_write(orig):
    """The decode step attends without writing its new K/V rows."""
    def scatter_attend(q, k, v, k_pages, v_pages, block_table, pos, qh2kv,
                       window):
        import torch
        from repro_torch.kernels.paged_attention.ops import \
            paged_decode_attention
        return paged_decode_attention(q, k_pages, v_pages, block_table,
                                      (pos + 1).to(torch.int32),
                                      qh2kv=qh2kv, window=window)
    return scatter_attend


FAULTS = {
    "step_state_unchanged": ("repro_torch.models.layers", "_scatter_attend",
                             _no_kv_write),
}
