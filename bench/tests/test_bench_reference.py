"""The plain reference: each family's held against the port's tiny stack
on the CPU, through the same harness path the card runs; the dense
reference's attention held against a direct masked softmax; the control
farther off than the port."""
import dataclasses

import pytest
import torch

from bench import families
from bench.families import dense
from bench.reference.model import fp8_round
from conftest import CELLS, CONFIGS, tiny_config


def _cfg(name, **kw):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(name).reduced(), **kw)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_is_the_ports_prefill(name):
    """Every position's logits of a 700-token prompt (two of the dense
    reference's query blocks), at the family's tiny size with a
    vocabulary of 500 that the port pads: the port's prefill and the
    reference within bf16 rounding of logits of size about 1 (a tenth of
    the control's distance)."""
    from repro_torch.models.transformer import prefill
    c, cfg = tiny_config(name)
    fam = families.of(c)
    cfg = dataclasses.replace(cfg, vocab_size=500)
    p = fam.draw(cfg, 2 ** 33 + 1, "cpu")
    toks = torch.randint(0, 500, (700,), generator=torch.Generator()
                         .manual_seed(1))
    ref = fam.reference(p, cfg).logits(toks, 0)
    ctl = fam.reference(p, cfg, control=True).logits(toks, 0)
    for pos in (0, 511, 512, 699):
        lg, _ = prefill(p, toks[None, :pos + 1], cfg)
        assert not lg[0, 500:].any()            # padded vocabulary is zero
        d = (lg[0, :500] - ref[pos]).abs().max().item()
        assert d < 0.06, (pos, d)
    assert (ctl - ref).abs().max().item() > 0.3


def test_attention_is_masked_softmax():
    cfg = _cfg("qwen3-14b", n_heads=8, n_kv_heads=2)
    m = dense.reference({}, cfg)
    g = torch.Generator().manual_seed(0)
    S, H, KV, Dh = 600, 8, 2, 32
    q, k, v = (torch.randn(S, h, Dh, generator=g) for h in (H, KV, KV))
    got = m._attention(q, k, v).view(S, H, Dh)
    ke, ve = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
    s = torch.einsum("qhd,khd->hqk", q, ke) / Dh ** 0.5
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -torch.inf)
    want = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), ve)
    assert torch.allclose(got, want, atol=1e-5)


def test_fp8_rounding():
    x = torch.tensor([[1.0, 0.3, -448.0, 17.0]], dtype=torch.bfloat16)
    y = fp8_round(x, -1)
    assert y.dtype == torch.bfloat16 and y[0, 2] == -448.0
    assert (y - x).abs().max() <= 448 / 8
    assert y[0, 1] != x[0, 1]                    # 3 mantissa bits


@pytest.mark.parametrize("name", CELLS)
def test_run_holds_the_port_to_the_reference(tiny_cell, name):
    """The harness path at the tiny size: the sampled served tokens'
    widest gap under the tiny limit (the control's side is
    ``test_bench_control.py``)."""
    from bench import run
    cell, cfg = tiny_cell(name)
    out = run.execute(cell, 2 ** 31 + 7, 6.0, False, torch.device("cpu"),
                      cfg=cfg, control=True, log=lambda s: None)
    gap = out["check"]["max_logit_gap"]
    assert out["correct"], out["check"]
    assert out["check"]["sampled"]["value"] >= 2
    assert gap["value"] < gap["limit"]
    assert out["control_gap"] >= gap["value"]
