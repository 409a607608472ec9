"""Decode steps of the window replayed as a CUDA graph, over all its
decode steps (the decode worker's ``graph_replays`` and ``steps``
counters), in %. None where the program has no such counter."""


def read(data):
    d = data.deltas["decode"]
    if "graph_replays" not in d or not d.get("steps"):
        return None
    return 100.0 * d["graph_replays"] / d["steps"]
