"""The one generator: deterministic by seed, one set of sizes and the
same arrivals for every seed in an order the seed draws, dealt in
balanced rounds, the stated distributions and reuse shares."""
import json

import numpy as np
import pytest

from bench import generator as g
from bench.spec import BENCH

CHAT = json.loads((BENCH / "traffic" / "chat-sessions.json").read_text())
DOCS = json.loads((BENCH / "traffic" / "long-docs.json").read_text())
SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 40 + 3)


def _open(seed, rate=0.4, horizon=60.0):
    return g.open_loop(CHAT, {"session_rate": rate, "round": 8}, horizon,
                       32064, seed)


def _shape(turns):
    return [(t.due, len(t.tokens), t.max_new) for t in turns]


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(seed):
    a, b = _open(seed), _open(seed)
    assert _shape(a) == _shape(b)
    assert all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))


def _session_shapes(seed, n=64):
    return [(s.system_prompt, tuple(len(t.tokens) for t in s.turns),
             tuple(t.max_new for t in s.turns))
            for s in g.build_sessions(CHAT, n, 32064, seed, 8)]


def test_seeds_draw_the_order_of_one_set_of_sizes():
    shapes = [_session_shapes(seed) for seed in SEEDS]
    assert all(sorted(s) == sorted(shapes[0]) for s in shapes)
    assert len({tuple(s) for s in shapes}) == len(SEEDS)
    a = g.build_sessions(CHAT, 64, 32064, SEEDS[0], 8)
    b = g.build_sessions(CHAT, 64, 32064, SEEDS[1], 8)
    assert not np.array_equal(a[0].turns[0].tokens[:64],
                              b[0].turns[0].tokens[:64])
    starts = [g.session_starts(0.4, 120.0, 60.0, CHAT["shape_seed"])
              for _ in SEEDS]
    assert all(np.array_equal(s, starts[0]) for s in starts)


@pytest.mark.parametrize("seed", SEEDS)
def test_every_round_takes_one_of_each_stratum(seed):
    work = np.random.default_rng(3).lognormal(8.9, 0.7, 96)
    order = g.balanced_order(list(work), 8, seed)
    assert sorted(order) == list(range(96))
    rank = np.empty(96, int)
    rank[np.argsort(work, kind="stable")] = np.arange(96)
    for r in range(12):
        assert sorted(rank[order[8 * r:8 * r + 8]] // 12) == list(range(8))
    assert order != g.balanced_order(list(work), 8, seed + 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_one_turn_rounds_pair_every_stratum(seed):
    shapes, _ = g._shapes(DOCS, 64)
    pairs = g.balanced_pairs(shapes, 8, seed)
    ins = sorted(sh.inputs[0] for sh in shapes)
    outs = sorted(sh.outputs[0] for sh in shapes)
    assert sorted(p.inputs[0] for p in pairs) == ins
    assert sorted(p.outputs[0] for p in pairs) == outs
    for r in range(8):         # one of each stratum: the k-th least of
        rnd = pairs[8 * r:8 * r + 8]     # a round lies in stratum k
        for k, (a, b) in enumerate(zip(sorted(p.inputs[0] for p in rnd),
                                       sorted(p.outputs[0] for p in rnd))):
            assert ins[8 * k] <= a <= ins[8 * k + 7]
            assert outs[8 * k] <= b <= outs[8 * k + 7]
    other = g.balanced_pairs(shapes, 8, seed + 1)
    assert [(p.inputs, p.outputs) for p in other] != \
        [(p.inputs, p.outputs) for p in pairs]


def test_closed_loop_rounds_hold_even_work():
    """Round r of the closed loop (each client's r-th document) holds
    nearly the same work on every seed, though one document's spreads
    by half its mean."""
    for seed in SEEDS:
        cl = g.closed_loop(DOCS, {"clients": 8, "sessions_per_client": 24},
                           151936, seed)
        w = np.array([sum(len(c[r].tokens) + c[r].max_new for c in cl)
                      for r in range(24)])
        assert w.std() / w.mean() < 0.05


def test_closed_loop_same_documents_every_seed():
    lens = [sorted(len(t.tokens) for c in g.closed_loop(
        DOCS, {"clients": 16, "sessions_per_client": 8}, 151936, s)
        for t in c) for s in SEEDS]
    assert all(x == lens[0] for x in lens)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_sessions_extend_their_prompts(seed):
    for s in g.build_sessions(CHAT, 40, 32064, seed, 8):
        for a, b in zip(s.turns, s.turns[1:]):
            assert np.array_equal(b.tokens[:len(a.tokens)], a.tokens)
            assert len(b.tokens) >= len(a.tokens) + a.max_new + 16
        for t in s.turns:
            assert len(t.tokens) + CHAT["output_reserve"] <= CHAT["context"]
            assert 16 <= t.max_new <= 512
            assert t.tokens.dtype == np.int32
            assert t.tokens.min() >= 0 and t.tokens.max() < 32064


def test_system_prompts_are_shared_whole_blocks():
    ss = g.build_sessions(CHAT, 200, 32064, 3, 8)
    by = {}
    for s in ss:
        if s.turns:
            by.setdefault(s.system_prompt, []).append(s.turns[0].tokens)
    counts = {k: len(v) for k, v in by.items()}
    assert max(counts, key=counts.get) == 0          # Zipf: the first is hot
    assert counts[0] > 0.3 * sum(counts.values())
    _, blocks = g._shapes(CHAT, 1)
    for k, toks in by.items():
        n = blocks[k] * g.BLOCK
        assert 1 <= blocks[k] <= 3
        assert all(np.array_equal(t[:n], toks[0][:n]) for t in toks)


def test_stated_distributions():
    ss = g.build_sessions(CHAT, 3000, 32064, 1, 8)
    outs = np.array([t.max_new for s in ss for t in s.turns])
    # lognormal(4.7, 1.0) clipped to 16..512: mean about 160
    assert 150 < outs.mean() < 170 and outs.min() >= 16 and outs.max() <= 512
    turns = np.array([len(s.turns) for s in ss])
    assert turns.max() <= 5 and 0.65 < np.mean(turns >= 2) < 0.8
    docs = [t for c in g.closed_loop(DOCS, {"clients": 16,
                                            "sessions_per_client": 40},
                                     151936, 1) for t in c]
    lens = np.array([len(t.tokens) for t in docs])
    # lognormal(8.9, 0.7): median 7,332, clipped to 4,096..15,872
    assert 6800 < np.median(lens) < 7800
    assert lens.min() >= 4096 and lens.max() <= 15872
    # summaries lognormal(4.4, 0.6) clipped to 32..256: mean about 96
    out = np.array([t.max_new for t in docs])
    assert out.min() >= 32 and out.max() <= 256 and 88 < out.mean() < 104
    assert (lens + out).max() <= DOCS["context"]


def test_open_loop_arrivals_are_steady():
    due = np.array([t.due for t in _open(5, rate=0.4, horizon=200.0)])
    assert due.min() >= 0 and due.max() < 200
    per = np.histogram(due, bins=4, range=(0, 200))[0]
    assert per.min() > 0.6 * per.max()
    # 0.4 sessions a second of 1-5 turns cut by the context: about one
    # request a second
    assert 0.8 < len(due) / 200 < 1.3


def test_reuse_shares():
    share = g.ideal_reuse_share(_open(9, horizon=120.0))
    assert 0.4 < share < 0.65
    cl = g.closed_loop(CHAT, {"clients": 16, "sessions_per_client": 40},
                       32064, 9)
    share = g.ideal_reuse_share([t for r in zip(*cl) for t in r])
    assert 0.5 < share < 0.75
    docs = [t for c in g.closed_loop(DOCS, {"clients": 16,
                                            "sessions_per_client": 4},
                                     151936, 9) for t in c]
    assert g.ideal_reuse_share(docs) == 0.0
