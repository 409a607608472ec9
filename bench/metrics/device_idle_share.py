"""Share of the traced slice with no kernel, copy or set on the device
(``torch.profiler``), in %."""


def read(data):
    tr = data.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
