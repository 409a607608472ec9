"""``bench/metrics/decode_graph_share.py``: the share of the window's decode
steps replayed as a CUDA graph. None where the decode worker has no
``graph_replays`` counter (a program without graphs) or took no step;
the share where it has one. A traced rehearsal of the chat cell on the
CPU, whose decode worker is given stand-in graphs as a card would give it
real ones, reports the share from the counters in the result line."""
from types import SimpleNamespace

import torch

from bench import run
from bench.metrics import reader
from conftest import CELLS, reuses

NAME = "decode_graph_share.chat"


def _data(**decode):
    return SimpleNamespace(deltas={"decode": decode})


def test_none_without_the_counter_or_a_step():
    read = reader(NAME)
    assert read(_data(steps=120, paged_calls=120)) is None
    assert read(_data(steps=0, graph_replays=0, graph_captures=0)) is None


def test_share_of_the_steps_replayed():
    read = reader(NAME)
    assert read(_data(steps=200, graph_replays=196, graph_captures=4)) \
        == 98.0
    assert read(_data(steps=50, graph_replays=0, graph_captures=0)) == 0.0


class _StandIn:
    """Replays by running the step again into the captured outputs."""

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        outs = fn()

        def replay():
            for o, n in zip(outs, fn()):
                o.copy_(n)
        return replay, outs


def test_traced_rehearsal_reports_the_share(tiny_cell, monkeypatch):
    from repro_torch.serving.decode_graphs import DecodeGraphs
    from repro_torch.serving.engine import DecodeWorker
    real = DecodeWorker.__init__

    def with_graphs(self, *a, **k):
        real(self, *a, **k)
        self._graphs = DecodeGraphs(self._unsharded_step, self.max_batch,
                                    self.max_pages, self.device, _StandIn())
    monkeypatch.setattr(DecodeWorker, "__init__", with_graphs)
    name = next(c for c in CELLS if reuses(c))
    cell, cfg = tiny_cell(name)
    out = run.execute(cell, 2 ** 32 + 17, 3.0, True, torch.device("cpu"),
                      cfg=cfg, log=lambda s: None)
    assert out["correct"]
    share = out["metrics"][NAME]
    assert share["unit"] == "%" and 0.0 < share["value"] <= 100.0
