"""Faults planted in the program underneath a whole run, to show that
the check catches a broken timed path: a token altered where it is
produced, half of the decode batch left uncomputed, and wrong data in the
layers the check covers (prefix blocks restored from the host pool,
staging into pages). A decode step that leaves its state unchanged is
planted where the family writes it, so it is each family's own
(``FAULTS`` of ``bench/families/<family>.py``). The cells run on one
card, so no exchange between cards can be left out. ``plant(name,
cell)`` patches one in and gives it back on exit; the tests and
``bench.probe --faults`` use it."""
from __future__ import annotations

import contextlib
import importlib

from bench import families


def _half_batch(orig):
    """Every other active slot keeps its previous token: half of the
    batch left uncomputed."""
    def step_full(self, active):
        nxt = orig(self, active)
        for i in active[1::2]:
            nxt[i] = self.tokens[i, 0]
        return nxt
    return step_full


def _altered(orig):
    """Every third step, the first active slot's token moved by one."""
    calls = [0]

    def step_full(self, active):
        nxt = orig(self, active)
        calls[0] += 1
        if calls[0] % 3 == 0:
            i = active[0]
            nxt[i] = (nxt[i] + 1) % self.cfg.vocab_size
        return nxt
    return step_full


def _zero_get(orig):
    def get(self, hash_ids):
        import torch
        k, v = orig(self, hash_ids)
        return torch.zeros_like(k), torch.zeros_like(v)
    return get


def _zero_write(orig):
    def write_run(self, pages, k, v):
        import torch
        return orig(self, pages, torch.zeros_like(k), torch.zeros_like(v))
    return write_run


FAULTS = {
    "token_altered": ("repro_torch.serving.engine.DecodeWorker",
                      "_step_full", _altered),
    "half_batch_left_out": ("repro_torch.serving.engine.DecodeWorker",
                            "_step_full", _half_batch),
    "pool_prefix_wrong": ("repro_torch.serving.engine.HostKVPool", "get",
                          _zero_get),
    "staged_pages_wrong": ("repro_torch.serving.paged_cache.DevicePagePool",
                           "write_run", _zero_write),
}


def _target(path: str):
    mod, _, cls = path.rpartition(".")
    try:
        return getattr(importlib.import_module(mod), cls)
    except (ImportError, AttributeError):
        return importlib.import_module(path)


def points(cell) -> dict:
    """The faults a cell can have: the generic ones and its family's."""
    return dict(FAULTS, **families.of(cell.config).FAULTS)


@contextlib.contextmanager
def plant(name: str, cell):
    path, attr, make = points(cell)[name]
    target = _target(path)
    orig = getattr(target, attr)
    setattr(target, attr, make(orig))
    try:
        yield
    finally:
        setattr(target, attr, orig)
