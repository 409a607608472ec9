"""Fixtures of the benchmark's own tests (run with
``python -m pytest bench/tests``; the repository's tier-1 run collects
``tests/`` only). ``tiny_cell`` is a cell of ``BENCHMARK.json`` cut to a
``.reduced()`` model and a light mix, driven through the same
``bench.run.execute`` path the card runs, with the plain kernels."""
from __future__ import annotations

import copy
import os

import pytest
import torch

from bench import families, spec

TINY_LIMIT = 0.1       # widest logit gap allowed at the tiny size
CELLS = tuple(w["name"] for w in spec.benchmark()["workloads"])
#: every configuration file, each of some family: a test parametrised
#: over them runs on each family present
CONFIGS = tuple(sorted(p.stem
                       for p in (spec.BENCH / "configs").glob("*.json")))

# the tiny runs are timed: workers that share the host's cores each take
# their own share of them, so that none waits on another's threads
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def shares(mix: dict) -> bool:
    """Whether the mix shares prefixes (system prompts, turns)."""
    return mix["system_prompts"]["count"] > 0 or mix["turns"]["max"] > 1


def reuses(name: str) -> bool:
    return shares(spec.find_cell(name).traffic)


def config(name: str) -> dict:
    return spec.load_json(spec.BENCH / "configs" / f"{name}.json")


def tiny_config(name: str):
    """(file, port config) of a configuration at its family's tiny size."""
    c = config(name)
    return families.of(c).tiny(c)


def _tiny(name: str, **workload):
    return _tiny_cell(spec.find_cell(name), **workload)


def _tiny_cell(cell, **workload):
    """The cell cut to its family's tiny model and a light mix."""
    c, cfg = families.of(cell.config).tiny(cell.config)
    mix = copy.deepcopy(cell.traffic)
    wl = copy.deepcopy(cell.workload)
    reused = shares(mix)
    if reused:
        mix.update(context=1536, output_reserve=32, lead_s=6.0,
                   system_prompts=dict(mix["system_prompts"], blocks_max=1),
                   new_input=dict(mix["new_input"], mu=5.0, max=300),
                   output=dict(mix["output"], min=4, max=12),
                   turns=dict(mix["turns"], min=2),
                   think_s={"mean": 1.0, "per_output_token": 0.0})
    else:
        mix.update(context=1024, output_reserve=24,
                   new_input=dict(mix["new_input"], mu=6.2, min=300,
                                  max=900),
                   output=dict(mix["output"], min=4, max=12))
    if wl["load"]["loop"] == "open":
        wl["load"] = {"loop": "open", "session_rate": 1.0, "round": 4}
    else:
        wl["load"] = dict(wl["load"], clients=8 if reused else 4,
                          sessions_per_client=30, ramp_s=1.0)
    c["serving"] = {"page_tokens": 64, "max_len": mix["context"]}
    max_batch = 8
    wl.update(warm_s=2, trace_s=2, host_warm_gib=0)
    wl["loop"] = dict(wl["loop"], max_batch=max_batch, prefill_chunk=256,
                      host_pool_blocks=16,
                      page_pool_pages=1 + (max_batch + 1) * mix["context"] // 64)
    wl["check"] = dict(wl["check"], max_logit_gap=TINY_LIMIT)
    for k, v in workload.items():
        wl[k] = v
    cell.config, cell.traffic, cell.workload = c, mix, wl
    return cell, cfg


@pytest.fixture
def tiny_cell():
    return _tiny
