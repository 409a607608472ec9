"""A rehearsal of the whole run on the CPU: each cell cut to a
``.reduced()`` model and a light mix, driven end to end through
``bench.run.execute`` (the path ``python3 -m bench.run`` takes on the
card) with the plain kernels; the result line as the contract reads it.
The measuring path itself refuses to run without a card
(``test_bench_imports.py``)."""
import json
import threading

import pytest
import torch

from bench import run, spec
from conftest import CELLS, reuses


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(tiny_cell, name, trace):
    cell, cfg = tiny_cell(name)
    lines = []
    out = run.execute(cell, 2 ** 32 + 5, 3.0, trace, torch.device("cpu"),
                      cfg=cfg, log=lines.append)
    json.loads(json.dumps(out))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] and out["attempted"] > 0
    dev = out["device"]
    assert dev["count"] == 1 and dev["platform"] == "cpu"
    entries = spec.find_cell(name)
    want = {m["name"]: m["unit"] for m in
            (entries.per_layer if trace else entries.end_to_end)}
    got = {k: v["unit"] for k, v in out["metrics"].items()}
    assert set(got) <= set(want) and all(want[k] == u for k, u in got.items())
    if not trace:
        assert set(got) == set(want)          # every end-to-end metric
        assert all(v["value"] > 0 for v in out["metrics"].values())
    else:
        # on the CPU no profiler slice: the device-trace readers find
        # nothing and are left out; span and counter readers report
        base = {k.split(".")[0] for k in got}
        assert not {"device_idle_share", "paged_attention_roofline"} & base
        assert {"decode_step_ms", "loop_iteration_ms"} <= base
    assert any("attempted" in line for line in lines)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("bench-")]


def test_every_metric_has_a_reader():
    from bench.metrics import reader
    b = spec.benchmark()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(reader(m["name"]))
    for w in b["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        reports = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reports and len(reports) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reports


def test_open_loop_result_line(tiny_cell):
    """The open loop (each request sent when it is due, and timed from
    then), which a later cell can choose by its workload file alone."""
    name = next(c for c in CELLS if reuses(c))
    cell, cfg = tiny_cell(name, load={"loop": "open", "session_rate": 1.0,
                                      "round": 4})
    out = run.execute(cell, 2 ** 32 + 7, 3.0, False, torch.device("cpu"),
                      cfg=cfg, log=lambda s: None)
    assert out["correct"] and out["attempted"] > 0
    assert all(v["value"] > 0 for v in out["metrics"].values())
