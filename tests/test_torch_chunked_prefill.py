"""The port's ``ChunkedPrefill`` state and the decode worker's admission
guards, against the reference's on smollm-360m's reduced config with
the reference's weights (``bridge.params_from_jax``): the mirrors of
``tests/test_serving_loop.py``'s join guards — a full decode batch
raises "decode batch full", also inside a generator; an overlong join
raises the same "exceeds max_len" on the paged and the dense substrate,
with nothing admitted — and of its chunk-resumable prefill: one
``advance()`` per device chunk, the final one counted, ``done``,
``prompt_len``, ``tokens`` and ``worker`` as the reference keeps them,
and a drained prefill bit-exact with the blocking call."""
import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro.serving.engine import HostKVPool as JHostKVPool
from repro.serving.engine import PrefillWorker as JPrefillWorker
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.serving import DecodeWorker, HostKVPool, PrefillWorker
from repro_torch.serving.request import ServingRequest

torch.set_num_threads(1)


def _req(rid, toks, max_new):
    return ServingRequest(req_id=rid, tokens=toks, max_new=max_new)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("smollm-360m").reduced()
    cfg = get_config("smollm-360m").reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, cfg, tp


def test_join_full_batch_raises_runtime_error(setup):
    """A full decode batch raises RuntimeError from ``join``, and inside a
    serving generator that error propagates (a bare StopIteration would
    end the generator silently)."""
    _, _, cfg, params = setup
    pw = PrefillWorker(params, cfg, HostKVPool(), prefill_chunk=64)
    dw = DecodeWorker(params, cfg, max_batch=1, max_len=512)
    rng = np.random.default_rng(0)
    t1 = rng.integers(0, cfg.vocab_size, 80)
    dw.join(_req(0, t1, 4), pw(t1))
    assert not dw.has_free_slot and dw.free_slots == 0
    t2 = rng.integers(0, cfg.vocab_size, 80)
    r2 = pw(t2)
    with pytest.raises(RuntimeError, match="decode batch full"):
        dw.join(_req(1, t2, 4), r2)

    def serving():
        yield "before"
        dw.join(_req(1, t2, 4), r2)
        yield "after"

    g = serving()
    assert next(g) == "before"
    with pytest.raises(RuntimeError, match="decode batch full"):
        next(g)
    r2.release_pages()


def test_join_overlong_rejects_identically_on_both_substrates(setup):
    """100 prompt tokens + 64 new past a 128-slot decode: the paged and
    the dense substrate raise the same ``ValueError`` ("exceeds
    max_len") and admit nothing."""
    _, _, cfg, params = setup
    pw = PrefillWorker(params, cfg, HostKVPool(), prefill_chunk=64)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, 100)
    res = pw(toks)
    msgs = {}
    for substrate in ("paged", "dense"):
        dw = DecodeWorker(params, cfg, max_batch=2, max_len=128,
                          substrate=substrate)
        with pytest.raises(ValueError) as ei:
            dw.join(_req(0, toks, 64), res)
        msgs[substrate] = str(ei.value)
        assert dw.n_active == 0
    assert msgs["paged"] == msgs["dense"]
    assert "exceeds max_len" in msgs["paged"]
    res.release_pages()


@pytest.mark.parametrize("n_tokens", [300, 256, 1])
def test_chunked_prefill_state_matches_the_reference(setup, n_tokens):
    """``start`` → one ``advance()`` per 64-token device chunk (the final
    one counted): ``chunks_done`` = ⌈n / 64⌉, ``done`` only at the end,
    ``prompt_len``, ``tokens`` and ``worker`` as given — each equal to
    the reference's after every call on the same prompt — and the
    drained result bit-exact with a blocking call of a fresh worker."""
    jcfg, jp, cfg, tp = setup
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, n_tokens)
    pw = PrefillWorker(tp, cfg, HostKVPool(), prefill_chunk=64)
    jpw = JPrefillWorker(jp, jcfg, JHostKVPool(), prefill_chunk=64)
    cp, jcp = pw.start(toks), jpw.start(toks)
    assert cp.worker is pw and cp.prompt_len == jcp.prompt_len == n_tokens
    np.testing.assert_array_equal(cp.tokens, jcp.tokens)
    assert not cp.done and cp.chunks_done == jcp.chunks_done == 0
    while True:
        fin, jfin = cp.advance(), jcp.advance()
        assert fin == jfin == cp.done == jcp.done
        assert cp.chunks_done == jcp.chunks_done
        if fin:
            break
    assert cp.chunks_done == -(-n_tokens // 64)
    assert cp.advance() and cp.chunks_done == -(-n_tokens // 64)
    assert cp.result.first_token == jcp.result.first_token
    ref = PrefillWorker(tp, cfg, HostKVPool(), prefill_chunk=64)(toks)
    assert cp.result.first_token == ref.first_token
    assert torch.equal(cp.result.kv_k, ref.kv_k)
    assert torch.equal(cp.result.kv_v, ref.kv_v)
