"""The window over the loop's iterations in it (``ServingLoop.stats()``
``iterations``), in ms."""


def read(data):
    n = data.deltas["loop"].get("iterations", 0)
    w0, w1 = data.window
    return (w1 - w0) * 1e3 / n if n else None
