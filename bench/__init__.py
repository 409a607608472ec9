"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python -m bench.run --workload <cell> --seed <n> --seconds <s> --trace 0|1``
serves one cell of ``BENCHMARK.json`` through ``repro_torch``'s
``ServingLoop`` and prints one JSON line. Everything a cell needs is
found by name: ``configs/<config>.json`` (the model and its sizes),
``families/<family>.py`` (the model family the configuration names: the
port's config, weights, plain reference, counts, kernels and fault
points), ``traffic/<traffic>.json`` (the mix, read by the one generator
in ``generator.py``), ``workloads/<cell>.json`` (load and loop settings,
the correctness limit) and ``metrics/<metric>.py`` (one reader per
metric; a suffix after the first dot selects the same reader).
``reference/`` holds each family's plain PyTorch model that decides
``correct``; it imports nothing of ``repro_torch``. Nothing here imports
``jax`` or the JAX package ``repro``.
"""
