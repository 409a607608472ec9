"""Model families: one module each, ``bench/families/<family>.py``, named
by the configuration file's ``family`` key (a ``-`` in it read as
``_``). The harness, the run, the check, the metrics and the faults meet
the model only through a family's hooks:

- ``port_config(config)``: the port's ``ModelConfig`` of the file, every
  width held equal to the port's registry except the keys the file lists
  in its ``reduced``, which are taken from the file;
- ``tiny(config) -> (config, cfg)``: the file and the port's config cut
  to a size the CPU tests run;
- ``draw(cfg, seed, device)``: the parameters, drawn from the seed on
  the device in the layout the port serves;
- ``reference(params, cfg, control=False)``: the plain reference (under
  ``bench/reference/``, importing nothing of the port), an object with
  ``logits(tokens, first)``; with ``control`` the reference in the
  precision below the configuration's, which the check must refuse;
- ``counts(config)``: the published model's operation counts, with
  ``layers``, ``chunk_flops(lo, hi, last)`` and ``decode_flops(batch,
  keys)``, put in ``RunData.arch`` for the metric readers;
- ``KERNELS``: the port's libraries built before the window;
- ``FAULTS``: the faults planted on the family's own code path, as
  ``bench/faults.py`` lists the generic ones.
"""
from __future__ import annotations

import importlib
import pkgutil


def present() -> list:
    """The families that have a module here."""
    return sorted(m.name for m in pkgutil.iter_modules(__path__))


def of(config: dict):
    """The family module the configuration file names."""
    name = config.get("family")
    if not name:
        raise ValueError(f"configuration {config.get('name')!r} names no "
                         f"family; add \"family\" with one of {present()}")
    return importlib.import_module(f"{__name__}.{name.replace('-', '_')}")
