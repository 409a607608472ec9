"""Prefills mid-chunks at an iteration's start, averaged over the
window's iterations (the loop's ``prefills_in_flight_sum`` and
``iterations`` counters): how many prompts share the chunk round-robin,
so how many iterations a prompt waits between its chunks. None where
the program has no such counter."""


def read(data):
    d = data.deltas["loop"]
    n = d.get("iterations", 0)
    if "prefills_in_flight_sum" not in d or not n:
        return None
    return d["prefills_in_flight_sum"] / n
