"""The paged decode step replayed as CUDA graphs (``serving/decode_graphs.py``
and ``DecodeWorker``), on the CPU.

Where the graphs are used: only on a CUDA device, unsharded, at one table
width a step and without experts (``decode_graphable``); the mesh, the
bucketed sub-batches, MoE decode, the plain-attention oracle and every CPU
step stay eager, count no capture or replay, and serve the tokens of the
dense-substrate oracle.

The bookkeeping: ``DecodeGraphs`` driven by a stand-in capture (it
replays by running the step again into the captured outputs) captures
each width once, fills the static buffers with exactly each step's host
table slice, lengths and tokens, and moves the kernel launch count from
the capture to the replays. A whole ``DecodeWorker`` with stand-in
graphs serves the eager worker's tokens and logits bit for bit through
``scenario``: joins mid-run, slots that finish, a shared tail page copied
on write, an idle slot, and the table width crossing powers of two. The
card runs the same scenario with real graphs
(``tests/test_torch_cuda.py::test_decode_graphs_serve_the_eager_tokens``).
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.launch.mesh import make_decode_mesh
from repro_torch.models.layers import plain_attention
from repro_torch.models.transformer import init_params
from repro_torch.serving import spans
from repro_torch.serving.decode_graphs import DecodeGraphs
from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                        PrefillWorker, decode_graphable)
from repro_torch.serving.paged_cache import DevicePagePool
from repro_torch.serving.request import ServingRequest

torch.set_num_threads(1)

PAGE = 64
CELL_ARCHS = ("phi3-mini-3.8b", "qwen3-14b")


class StandIn:
    """A capture that runs the step: its replay runs the step again and
    copies the results into the outputs it captured (with ``rerun``
    False, a replay does nothing, as a replay runs no Python)."""

    def __init__(self, rerun: bool = True) -> None:
        self.rerun = rerun
        self.warms = 0
        self.captures = 0

    def warm(self, fn):
        self.warms += 1
        return fn()

    def capture(self, fn):
        self.captures += 1
        outs = fn()

        def replay():
            for o, n in zip(outs, fn() if self.rerun else outs):
                o.copy_(n)
        return replay, outs


def eager(dw: DecodeWorker) -> DecodeWorker:
    """``dw`` without graphs: the eager step, wherever it runs."""
    dw._graphs = None
    return dw


def standin_graphs(dw: DecodeWorker) -> DecodeWorker:
    """``dw`` with stand-in graphs, as a CUDA device would give it."""
    dw._graphs = DecodeGraphs(dw._unsharded_step, dw.max_batch,
                              dw.max_pages, dw.device, StandIn())
    return dw


def _width(dw: DecodeWorker) -> int:
    need = max(int(dw.seq_lens[i]) // PAGE + 1
               for i, s in enumerate(dw.slots) if s is not None)
    return min(1 << (need - 1).bit_length(), dw.max_pages)


def scenario(cfg, params, device, graphs=eager, *, max_batch=4,
             max_len=1024, seed=3) -> dict:
    """Serve a fixed mix through ``DecodeWorker.step`` on a fresh pool:
    ``graphs(dw)`` gives the worker its graphs or, by default, strips
    them (the eager step). Slot 3 idles (length 0) until a prompt joins
    mid-run; two slots share one prefill result, so their shared tail
    page is copied on write; a 250-token prompt joining at step 20 takes
    the table from 2 to 4 pages, and its growth past 256 tokens to 8;
    slots finish and are refilled. Returns the streams, each step's width
    and its active slots' logits, the worker's counters and the widths
    captured."""
    rng = np.random.default_rng(seed)
    pp = DevicePagePool(cfg, n_pages=1 + (max_batch + 2) * max_len // PAGE,
                        page_tokens=PAGE, device=device)
    pw = PrefillWorker(params, cfg, HostKVPool(), prefill_chunk=128,
                       page_pool=pp)
    dw = graphs(DecodeWorker(params, cfg, max_batch=max_batch,
                             max_len=max_len, page_pool=pp))
    call = dw._paged_call
    logits = []

    def recorded(*a):
        out = call(*a)
        # the active rows' (an idle row writes and reads the null page,
        # which every idle row writes at once); a clone, since a
        # replay's logits are its graph's own tensor
        active = [i for i, s in enumerate(dw.slots) if s is not None]
        logits.append(out[0][active, -1].clone())
        return out
    dw._paged_call = recorded

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    # (step to join at, request id, prompt length, new tokens)
    joins = [(0, 0, 40, 30), (0, 1, 100, 90), (0, 2, 100, 70),
             (20, 3, 250, 75), (35, 4, 60, 40), (90, 5, 30, 20)]
    shared = pw(prompt(100))
    streams, widths, step = {}, [], 0
    while joins or dw.n_active:
        while joins and joins[0][0] <= step and dw.has_free_slot:
            _, rid, n, new = joins.pop(0)
            res = shared if rid in (1, 2) else pw(prompt(n))
            dw.join(ServingRequest(rid, None, new), res)
            streams[rid] = [res.first_token]
        if dw.n_active:
            widths.append(_width(dw))
            for rid, tok, _ in dw.step():
                streams[rid].append(tok)
        step += 1
    pp.check_leaks()
    return dict(streams=streams, logits=logits, widths=widths,
                counters=dict(dw.counters), cow=pp.stats()["cow_copies"],
                captured=[] if dw._graphs is None else sorted(dw._graphs._graphs))


def check_scenario(eager: dict, graphed: dict, *, logit_tol: float = 0.0):
    """The graphed run against the eager one: the same streams, logits
    within ``logit_tol`` (0: bit for bit), one capture per width met and a
    replay for every other step. Returns the widest logit gap."""
    assert graphed["streams"] == eager["streams"]
    assert graphed["widths"] == eager["widths"]
    assert len(graphed["logits"]) == len(eager["logits"])
    gap = max(float((g - e).abs().max())
              for g, e in zip(graphed["logits"], eager["logits"]))
    assert gap <= logit_tol
    widths = eager["widths"]
    assert len(widths) >= 80
    assert len({w for w in widths if w > 2}) >= 2     # 2 → 4 → 8
    assert eager["cow"] >= 1 and graphed["cow"] == eager["cow"]
    c = graphed["counters"]
    assert graphed["captured"] == sorted(set(widths))
    assert c["graph_captures"] == len(set(widths))
    assert c["graph_replays"] == c["steps"] - c["graph_captures"]
    assert c["steps"] == len(widths) == c["paged_calls"]
    assert eager["counters"]["graph_captures"] == 0
    assert eager["counters"]["graph_replays"] == 0
    return gap


def _params(arch: str):
    cfg = get_config(arch).reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


# ---------------------------------------------------------------------------
# where the graphs are used
# ---------------------------------------------------------------------------

CHOICES = {
    "cuda": (dict(), True),
    "cpu": (dict(device="cpu"), False),
    "mesh": (dict(mesh=make_decode_mesh(1, 1, device="cpu")), False),
    "width_buckets": (dict(width_buckets=2), False),
    "moe": (dict(arch="qwen3-moe-235b-a22b"), False),
}


@pytest.mark.parametrize("case", list(CHOICES))
def test_graph_choice(case):
    kw, want = CHOICES[case]
    cfg = get_config(kw.get("arch", "smollm-360m"))
    assert decode_graphable(cfg, torch.device(kw.get("device", "cuda")),
                            kw.get("mesh"), kw.get("width_buckets", 1)) \
        is want


def _served(cfg, params, *, mesh=None, **dw_kw):
    rng = np.random.default_rng(4)
    prompts = {i: rng.integers(0, cfg.vocab_size, n)
               for i, n in enumerate((40, 300, 130, 520))}
    pp = None
    if dw_kw.get("substrate") != "dense":
        pp = DevicePagePool(cfg, n_pages=1 + 6 * 1024 // PAGE,
                            page_tokens=PAGE, device="cpu", mesh=mesh)
    pw = PrefillWorker(params, cfg, HostKVPool(), prefill_chunk=64,
                       page_pool=pp)
    dw = DecodeWorker(params, cfg, max_batch=4, max_len=1024, page_pool=pp,
                      **dw_kw)
    out = {}
    for rid, toks in prompts.items():
        res = pw(toks)
        dw.join(ServingRequest(rid, toks, 10), res)
        out[rid] = [res.first_token]
    while dw.n_active:
        for rid, tok, _ in dw.step():
            out[rid].append(tok)
    return out, dw


EAGER = {
    "cpu": ("smollm-360m", dict(), contextlib.nullcontext),
    "mesh": ("smollm-360m",
             dict(mesh=make_decode_mesh(2, 1, device="cpu")),
             contextlib.nullcontext),
    "width_buckets": ("smollm-360m", dict(width_buckets=4),
                      contextlib.nullcontext),
    "moe": ("qwen3-moe-235b-a22b", dict(), contextlib.nullcontext),
    "plain_attention": ("smollm-360m", dict(), plain_attention),
}


@pytest.fixture(scope="module")
def weights():
    return {a: _params(a) for a in ("smollm-360m", "qwen3-moe-235b-a22b")}


@pytest.mark.parametrize("case", list(EAGER))
def test_eager_paths_stay_eager(weights, case):
    """Each path the graphs leave out runs eagerly: no graphs, no capture
    or replay counted, and the dense-substrate oracle's tokens."""
    arch, kw, ctx = EAGER[case]
    cfg, params = weights[arch]
    oracle, _ = _served(cfg, params, substrate="dense")
    with ctx():
        got, dw = _served(cfg, params, **kw)
    assert dw._graphs is None
    assert dw.counters["graph_captures"] == dw.counters["graph_replays"] == 0
    assert dw.counters["paged_calls"] >= dw.counters["steps"] > 0
    assert got == oracle


def test_plain_attention_bypasses_installed_graphs(weights):
    """Under the plain-attention oracle a worker that has graphs steps
    eagerly, and uses them again once the oracle is off."""
    cfg, params = weights["smollm-360m"]
    oracle, _ = _served(cfg, params, substrate="dense")
    real = DecodeWorker.__init__

    def with_graphs(self, *a, **k):
        real(self, *a, **k)
        standin_graphs(self)
    DecodeWorker.__init__ = with_graphs
    try:
        with plain_attention():
            plain, dw = _served(cfg, params)
        assert dw.counters["graph_captures"] == 0
        assert dw.counters["graph_replays"] == 0
        graphed, dw = _served(cfg, params)
    finally:
        DecodeWorker.__init__ = real
    assert dw.counters["graph_captures"] >= 1
    assert dw.counters["graph_replays"] >= 1
    assert plain == graphed == oracle


# ---------------------------------------------------------------------------
# the per-width bookkeeping
# ---------------------------------------------------------------------------

B, MAX_PAGES = 3, 16


def _recording_step(seen: list, layers: int = 0):
    def step(tokens, table, lens):
        seen.append((tokens.clone(), table.clone(), lens.clone()))
        paged_attention.launches += layers
        return (tokens[:, 0] * 1000 + table.sum(1) + lens,)
    return step


def test_each_width_is_captured_once_and_the_buffers_get_each_step():
    rng = np.random.default_rng(0)
    seen = []
    cap = StandIn()
    g = DecodeGraphs(_recording_step(seen), B, MAX_PAGES, "cpu", cap)
    host = rng.integers(1, 500, (B, MAX_PAGES)).astype(np.int32)
    replays = 0
    order = [1, 1, 2, 4, 2, 4, 8, 8, 16, 1, 16]
    for i, w in enumerate(order):
        lens = rng.integers(0, 900, B).astype(np.int32)
        tokens = torch.from_numpy(rng.integers(0, 50, (B, 1)))
        tbl = host[:, :w]                      # a view, as the worker's
        snap = torch.from_numpy(np.array(tbl))
        g.load(tokens, tbl, lens)
        host[:] = rng.integers(1, 500, (B, MAX_PAGES))   # later mutation
        assert g.table(w).is_contiguous()
        assert torch.equal(g.table(w), snap)
        assert np.array_equal(g.seq_lens.numpy(), lens)
        assert torch.equal(g.tokens, tokens)
        before = len(seen)
        (out,), replayed = g.run(w)
        replays += replayed
        assert replayed == (w in order[:i])
        want = tokens[:, 0] * 1000 + snap.sum(1) + torch.from_numpy(lens)
        assert torch.equal(out, want)
        # the step saw exactly this step's inputs (twice when captured)
        assert len(seen) - before == (1 if replayed else 2)
        for t, tb, ln in seen[before:]:
            assert torch.equal(t, tokens) and torch.equal(tb, snap)
            assert np.array_equal(ln.numpy(), lens)
    assert sorted(g._graphs) == [1, 2, 4, 8, 16]
    assert cap.captures == cap.warms == 5 and replays == 6


def test_kernel_launches_move_from_the_capture_to_the_replays():
    """A capture launches nothing on the card: ``paged_attention.launches``
    counts the warm step's launches, none of the capture's, and each
    replay's."""
    seen = []
    g = DecodeGraphs(_recording_step(seen, layers=5), B, MAX_PAGES, "cpu",
                     StandIn(rerun=False))
    n0 = paged_attention.launches
    try:
        for w in (2, 2, 2, 4):
            g.load(torch.zeros((B, 1), dtype=torch.int64),
                   np.ones((B, w), np.int32), np.zeros(B, np.int32))
            g.run(w)
        assert paged_attention.launches - n0 == 5 * 4
        assert len(seen) == 2 + 2      # two warm steps, two captures
    finally:
        paged_attention.launches = n0


# ---------------------------------------------------------------------------
# a whole worker with stand-in graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", CELL_ARCHS)
def test_standin_graphs_serve_the_eager_tokens(arch):
    cfg, params = _params(arch)
    eager = scenario(cfg, params, "cpu")
    spans.take()
    spans.enable()
    try:
        graphed = scenario(cfg, params, "cpu", standin_graphs)
    finally:
        spans.disable()
    check_scenario(eager, graphed)
    names = [s.name for s in spans.take()]
    steps = graphed["counters"]["steps"]
    assert names.count("decode.tables") == steps
    assert names.count("decode.dispatch") == steps
