"""The operation and byte counts, held to hand counts and to the port's
own op accounting (``launch/op_analysis.py``) less its padding; each
family's counts adding up over chunks and slots; each family's weights
in the port's layout, and the dense family's padding."""
import dataclasses

import pytest
import torch

from bench import counts, families
from bench.counts import Arch
from bench.families import dense
from conftest import CONFIGS, tiny_config

TINY = Arch(layers=2, d_model=256, heads=16, kv_heads=4, head_dim=32,
            d_ff=512, vocab=512)


def test_hand_counts():
    a = TINY
    per_layer = 256 * 16 * 32 + 2 * 256 * 4 * 32 + 16 * 32 * 256 + 3 * 256 * 512
    assert a.layer_weights == per_layer
    assert counts.causal_pairs(0, 4) == 1 + 2 + 3 + 4
    assert counts.causal_pairs(4, 6) == 5 + 6
    assert counts.chunk_flops(a, 4, 6, last=False) == \
        2 * 2 * 2 * per_layer + 2 * 4 * 16 * 32 * 11
    assert counts.chunk_flops(a, 4, 6, last=True) - \
        counts.chunk_flops(a, 4, 6, last=False) == 2 * 256 * 512
    assert counts.decode_flops(a, 3, 100) == \
        2 * 3 * (2 * per_layer + 256 * 512) + 2 * 4 * 16 * 32 * 100
    assert a.chunk_flops(4, 6, True) == counts.chunk_flops(a, 4, 6, True)
    assert a.decode_flops(3, 100) == counts.decode_flops(a, 3, 100)
    f, b = counts.flash_prefill_call(a, 4, 6)
    assert f == 4 * 16 * 32 * 11
    assert b == 2 * (2 * 2 * 16 * 32 + 2 * 6 * 4 * 32)
    f, b = counts.paged_attention_call(a, 3, 100)
    assert f == 4 * 16 * 32 * 100
    assert b == 2 * (2 * 3 * 16 * 32 + 2 * 100 * 4 * 32)
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("n_heads,n_kv", [(16, 4), (4, 4)])
def test_prefill_count_is_op_analysis_less_padding(n_heads, n_kv):
    """A whole prompt as one chunk: the port's counted dot FLOPs (its
    padded query heads, its attention over every key of the chunk) less
    what the padding and the masked keys add are the benchmark's count."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.op_analysis import analyze, standin
    from repro_torch.models.transformer import prefill
    cfg = dataclasses.replace(get_config("qwen3-14b").reduced(),
                              n_heads=n_heads, n_kv_heads=n_kv)
    S = 96
    real = dense.draw(cfg, 3, "cpu")

    def stand(tree):
        return {k: stand(v) if isinstance(v, dict)
                else standin(v.shape, v.dtype, "cpu:0")
                for k, v in tree.items()}
    toks = standin((1, S), torch.int64, "cpu:0")
    got = analyze(prefill, stand(real), toks, cfg)["flops"]
    a = Arch(layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
             kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
             vocab=cfg.vocab_size)
    Hp, Dh, D, L = cfg.padded_heads, cfg.head_dim, cfg.d_model, cfg.n_layers
    pad_proj = 2 * S * L * 2 * D * (Hp - cfg.n_heads) * Dh
    pad_vocab = 2 * D * (cfg.padded_vocab - cfg.vocab_size)
    attn_all = L * 4 * Hp * Dh * S * S
    attn_causal = L * a.attn_pair_flops() * counts.causal_pairs(0, S)
    assert got - pad_proj - pad_vocab - attn_all + attn_causal == \
        counts.chunk_flops(a, 0, S, last=True)


def _leaves(tree, pre=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, pre + (k,)))
        else:
            out[pre + (k,)] = v
    return out


def _shapes(tree):
    return {k: (tuple(v.shape), v.dtype) for k, v in _leaves(tree).items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_add_up(name):
    """A prompt's chunks add up to the prompt as one chunk, and a decode
    step over two groups of slots to the two steps, at the family's tiny
    size; the unembedding and every cached key cost something."""
    c, cfg = tiny_config(name)
    a = families.of(c).counts(c)
    assert a.layers == cfg.n_layers
    whole = a.chunk_flops(0, 700, True)
    assert a.chunk_flops(0, 256, False) + a.chunk_flops(256, 512, False) \
        + a.chunk_flops(512, 700, True) == pytest.approx(whole, rel=1e-12)
    assert a.chunk_flops(0, 700, False) < whole
    assert a.decode_flops(3, 500) + a.decode_flops(5, 700) == \
        pytest.approx(a.decode_flops(8, 1200), rel=1e-12)
    assert a.decode_flops(8, 1200) < a.decode_flops(8, 1201)


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_layout(name):
    """The family's weights at its tiny size: the port's own parameters'
    leaves, shapes and types, the same for one seed and not for
    another."""
    from repro_torch.models.transformer import init_params
    c, cfg = tiny_config(name)
    fam = families.of(c)
    mine = fam.draw(cfg, 2 ** 40 + 1, "cpu")
    theirs = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(mine) == _shapes(theirs)
    again = _leaves(fam.draw(cfg, 2 ** 40 + 1, "cpu"))
    other = _leaves(fam.draw(cfg, 2 ** 40 + 2, "cpu"))
    mine = _leaves(mine)
    assert all(torch.equal(again[k], v) for k, v in mine.items())
    assert not all(torch.equal(other[k], v) for k, v in mine.items())


def test_weights_layout_and_padding():
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config("qwen3-14b").reduced()
    mine = dense.draw(cfg, 2 ** 40 + 1, "cpu")
    theirs = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(mine) == _shapes(theirs)
    H, Dh, V = cfg.n_heads, cfg.head_dim, cfg.vocab_size
    assert cfg.padded_heads > H and cfg.padded_vocab >= V
    assert not mine["attn"]["wq"][:, :, H * Dh:].any()
    assert not mine["attn"]["wo"][:, H * Dh:, :].any()
    assert not mine["embed"][V:].any() and not mine["lm_head"][:, V:].any()
    assert mine["attn"]["wq"][:, :, :H * Dh].float().std() > 0
    again = dense.draw(cfg, 2 ** 40 + 1, "cpu")
    assert torch.equal(again["mlp"]["w2"], mine["mlp"]["w2"])
    other = dense.draw(cfg, 2 ** 40 + 2, "cpu")
    assert not torch.equal(other["mlp"]["w2"], mine["mlp"]["w2"])
