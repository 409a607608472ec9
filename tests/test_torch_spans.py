"""The port's span recorder (``repro_torch.serving.spans``) and the byte
counters beside it, driven through ``ServingLoop.iterate`` on
smollm-360m's reduced config on the CPU.

Two prompts share their first 512-token block, so a run holds every
phase the spans time: the first prompt's store-back, the second's
prefix load from the host pool, staging that adopts the registered
block and writes the rest, zero-copy joins and paged decode steps. The
same run is made with the recorder off and on: off, nothing is kept and
the served tokens are the ones served with it on, bit for bit; on, every
span of the serving loop appears inside its parent on its thread, and
each byte counter equals the bytes its spans carry."""
import gc
import importlib.util
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.trace import BLOCK_TOKENS
from repro_torch.models.transformer import DTYPE, init_params
from repro_torch.serving import (DecodeWorker, DevicePagePool, HostKVPool,
                                 PrefillWorker, ServingLoop, spans)
from repro_torch.serving.request import ServingRequest

torch.set_num_threads(1)

PROMPTS = (600, 700)      # the second shares the first's first block
MAX_NEW = 6


def _serve(cfg, params, record: bool) -> dict:
    pp = DevicePagePool(cfg, n_pages=1 + 4 * 2048 // 64, page_tokens=64,
                        device="cpu")
    pool = HostKVPool()
    pw = PrefillWorker(params, cfg, pool, prefill_chunk=128, page_pool=pp)
    dw = DecodeWorker(params, cfg, max_batch=4, max_len=2048, page_pool=pp)
    loop = ServingLoop([pw], dw, chunks_per_iter=1, max_queue=8,
                       admission="baseline")
    rng = np.random.default_rng(7)
    first = rng.integers(0, cfg.vocab_size, PROMPTS[0]).astype(np.int32)
    second = np.concatenate([first[:BLOCK_TOKENS], rng.integers(
        0, cfg.vocab_size, PROMPTS[1] - BLOCK_TOKENS).astype(np.int32)])
    before = dict(prefill=dict(pw.counters), decode=dict(dw.counters),
                  loop=loop.stats())
    spans.take()
    if record:
        spans.enable()
    try:
        assert loop.submit(ServingRequest(req_id=1, tokens=first,
                                          max_new=MAX_NEW))
        while loop.stats()["joined"] < 1:
            loop.iterate()
        assert loop.submit(ServingRequest(req_id=2, tokens=second,
                                          max_new=MAX_NEW))
        loop.close_intake()
        loop.run()
    finally:
        spans.disable()
    after = dict(prefill=dict(pw.counters), decode=dict(dw.counters),
                 loop=loop.stats())
    pp.check_leaks()
    return dict(tokens={r: list(o.tokens) for r, o in loop.outputs.items()},
                spans=spans.take(), reused=pw.counters["reused_blocks"],
                zero_copy=dw.counters["zero_copy_joins"],
                deltas={k: {kk: after[k][kk] - before[k][kk]
                            for kk in before[k]
                            if isinstance(before[k][kk], int)}
                        for k in after})


@pytest.fixture(scope="module")
def runs():
    cfg = get_config("smollm-360m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, _serve(cfg, params, False), _serve(cfg, params, True)


def test_off_keeps_nothing_and_serves_the_same_tokens(runs):
    _, off, on = runs
    assert off["spans"] == []
    assert off["tokens"] == on["tokens"]
    assert all(len(t) == MAX_NEW for t in on["tokens"].values())
    assert spans.span("x") is spans.span("y")      # the one no-op


# span, its parent, whether it serves one request, whether it counts bytes
TABLE = [
    ("loop.iteration", None, False, False),
    ("loop.arrivals", "loop.iteration", False, False),
    ("loop.joins", "loop.iteration", False, False),
    ("loop.chunks", "loop.iteration", False, False),
    ("decode.join", "loop.joins", True, False),
    ("decode.step", "loop.iteration", False, False),
    ("decode.prepare", "decode.step", False, False),
    ("decode.tables", "decode.step", False, False),
    ("decode.dispatch", "decode.step", False, False),
    ("decode.token_sync", "decode.step", False, False),
    ("decode.emit", "decode.step", False, False),
    ("prefill.advance", "loop.chunks", True, False),
    ("prefill.match", "prefill.advance", True, False),
    ("prefill.prefix_load", "prefill.advance", True, True),
    ("prefill.chunk", "prefill.advance", True, False),
    ("prefill.chunk_dispatch", "prefill.chunk", True, False),
    ("prefill.chunk_sync", "prefill.chunk", True, False),
    ("prefill.offload", "prefill.advance", True, True),
    ("prefill.store_back", "prefill.advance", True, False),
    ("prefill.stage", "prefill.advance", True, True),
]


@pytest.mark.parametrize("name,parent,per_request,counts", TABLE,
                         ids=[row[0] for row in TABLE])
def test_span_inside_its_parent(runs, name, parent, per_request, counts):
    _, _, on = runs
    by_id = {s.sid: s for s in on["spans"]}
    mine = [s for s in on["spans"] if s.name == name]
    assert mine, f"no {name} span"
    for s in mine:
        assert s.t0 <= s.t1 and (s.nbytes is not None) == counts
        if parent is None:
            assert s.parent is None
            continue
        up = by_id[s.parent]
        assert up.name == parent and up.thread == s.thread
        assert up.t0 <= s.t0 and s.t1 <= up.t1
        if per_request:
            assert s.req_id in (1, 2)


def test_every_span_is_in_the_table(runs):
    _, _, on = runs
    assert {s.name for s in on["spans"]} == {row[0] for row in TABLE}


def test_decode_children_fit_their_step(runs):
    """A step's children are siblings: they sum to at most the step."""
    _, _, on = runs
    inside: dict = {}
    for s in on["spans"]:
        if s.name.startswith("decode.") and s.name != "decode.step":
            inside[s.parent] = inside.get(s.parent, 0) + s.t1 - s.t0
    steps = [s for s in on["spans"] if s.name == "decode.step"]
    assert steps and all(inside[s.sid] <= s.t1 - s.t0 for s in steps)


def _block_bytes(cfg) -> int:
    return 2 * cfg.n_layers * BLOCK_TOKENS * cfg.n_kv_heads * cfg.head_dim \
        * torch.empty((), dtype=DTYPE).element_size()


def test_offload_and_prefix_load_bytes_by_shape(runs):
    cfg, _, on = runs
    d = on["deltas"]["prefill"]
    token = _block_bytes(cfg) // BLOCK_TOKENS
    assert d["offload_bytes"] == sum(PROMPTS) * token
    assert on["reused"] == 1
    assert d["prefix_load_bytes"] == on["reused"] * _block_bytes(cfg)


@pytest.mark.parametrize("counter,name", [
    ("prefix_load_bytes", "prefill.prefix_load"),
    ("offload_bytes", "prefill.offload"),
    ("stage_bytes", "prefill.stage"),
])
def test_counter_equals_its_spans_bytes(runs, counter, name):
    _, off, on = runs
    total = sum(s.nbytes for s in on["spans"] if s.name == name)
    assert total > 0
    assert on["deltas"]["prefill"][counter] == total
    assert off["deltas"]["prefill"][counter] == total   # counted when off too


def test_prefills_in_flight_sum(runs):
    """A prompt is in flight from the iteration after its arrival to the
    one of its last chunk; it arrives in the iteration of its first
    chunk, so it adds the iterations it advanced in, less one."""
    _, _, on = runs
    by_id = {s.sid: s for s in on["spans"]}

    def iteration(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s.sid

    advanced: dict = {}
    for s in on["spans"]:
        if s.name == "prefill.advance":
            advanced.setdefault(s.req_id, set()).add(iteration(s))
    d = on["deltas"]["loop"]
    assert d["iterations"] == sum(s.name == "loop.iteration"
                                  for s in on["spans"])
    assert d["prefills_in_flight_sum"] == sum(
        len(its) - 1 for its in advanced.values()) > 0


def test_stage_adopts_the_shared_block(runs):
    """The second prompt's staging adopts the registered first block and
    writes only the rest; both joins take their staged run as it is."""
    cfg, _, on = runs
    token = _block_bytes(cfg) // BLOCK_TOKENS
    st = sorted((s for s in on["spans"] if s.name == "prefill.stage"),
                key=lambda s: s.req_id)
    assert [s.nbytes for s in st] == [
        PROMPTS[0] * token, (PROMPTS[1] - BLOCK_TOKENS) * token]
    assert on["zero_copy"] == len(PROMPTS)


def test_nesting_is_per_thread_and_add_adopts_children():
    def elsewhere():
        with spans.span("t"):
            pass

    spans.take()
    spans.enable()
    try:
        with spans.span("outer", req_id=5):
            t0 = time.monotonic_ns()
            with spans.span("inner"):
                pass
            other = threading.Thread(target=elsewhere)
            other.start()
            other.join(10)
            spans.add("timed", t0, time.monotonic_ns())
    finally:
        spans.disable()
    got = {s.name: s for s in spans.take()}
    assert not other.is_alive()
    assert got["t"].parent is None and got["t"].thread != got["outer"].thread
    assert got["timed"].parent == got["outer"].sid
    assert got["inner"].parent == got["timed"].sid
    assert got["inner"].req_id == got["timed"].req_id == 5


def test_recorder_drops_past_capacity(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 3)
    spans.take()
    dropped = spans.dropped
    spans.enable()
    try:
        for _ in range(5):
            with spans.span("s"):
                pass
    finally:
        spans.disable()
    assert len(spans.take()) == 3 and spans.dropped == dropped + 2


def test_kept_spans_leave_the_collector():
    """Finished spans are plain tuples of numbers and strings, which a
    collection stops tracking, so a long recording does not lengthen
    the collector's passes."""
    spans.take()
    spans.enable()
    try:
        with spans.span("outer", req_id=3) as sp:
            sp.moved(1 << 40)
        spans.add("timed", 0, time.monotonic_ns())
    finally:
        spans.disable()
    gc.collect()
    assert len(spans._kept) == 2
    assert not any(gc.is_tracked(rec) for rec in spans._kept)
    got = spans.take()
    assert [s.nbytes for s in got] == [1 << 40, None]


def test_spans_module_imports_no_torch():
    spec = importlib.util.find_spec("repro_torch.serving.spans")
    code = ("import importlib.util, sys; "
            f"s = importlib.util.spec_from_file_location('s', {spec.origin!r}); "
            "m = sys.modules['s'] = importlib.util.module_from_spec(s); "
            "s.loader.exec_module(m); "
            "sys.exit('torch' in sys.modules)")
    done = subprocess.run([sys.executable, "-c", code], timeout=60)
    assert done.returncode == 0
