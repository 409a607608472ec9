"""Find a cell's files by the names ``BENCHMARK.json`` gives them."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclass
class Cell:
    """One cell: its entry, configuration, traffic mix, load and loop
    settings, and the metrics it reports."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list
    per_layer: list


def find_cell(name: str, bench: dict = None) -> Cell:
    bench = benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(entries)}")
    return load_cell(entries[name], bench)


def load_cell(entry: dict, bench: dict) -> Cell:
    """The cell of a ``workloads`` entry (one that ``BENCHMARK.json``
    holds, or one built the same way)."""
    name = entry["name"]
    config = load_json(BENCH / "configs" / f"{entry['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    return Cell(name=name, entry=entry, config=config, traffic=traffic,
                workload=workload,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])
