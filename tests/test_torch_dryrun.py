"""The port's dry run (``repro_torch.launch.dryrun``) on its own terms:
the counting leaves the port's numerics bit for bit as they are and its
stand-in run makes the real step's products, the runs at cut depth on
the first rows give every reported position the counts of the whole
mesh run at full depth, the two production-mesh combinations of the
reference's slow tests run on the host CPU in under 60 s each, and the
module imports no jax.

The comparisons with the reference's dry run are in
``tests/test_torch_op_analysis.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import SRC
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun as DR
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.launch.mesh import (MAX_STANDINS, PRODUCTION_ROWS,
                                     make_decode_mesh, make_production_mesh,
                                     make_standin_mesh)
from repro_torch.launch.op_analysis import COLLECTIVES, OpAnalysis
from repro_torch.launch.shardings import shard_caches, shard_params
from repro_torch.launch.steps import (INPUT_SHAPES, ShapeSpec, cache_specs,
                                      loss_and_grads, make_dist,
                                      make_serve_step)
from repro_torch.models import layers
from repro_torch.models.transformer import init_caches, init_params

torch.set_num_threads(1)

PROD_LIMIT_S = 60.0
COUNTS = ("flops", "bytes", "transcendentals", "collective_bytes",
          "collective_counts", "collective_total", "output_bytes")


def _mesh(dims):
    return make_standin_mesh(dims, ("data", "model") if len(dims) == 2
                             else ("pod", "data", "model"))


# ------------------------------------------------------------ numerics --

# the shapes of the numerics cases: a batch of 4, a 32-token train step
# and a decode at position 63 of a 64-slot cache
NUMERICS_SHAPES = {"train": ShapeSpec("t", "train", 32, 4),
                   "decode": ShapeSpec("d", "decode", 64, 4)}


def _real_step(cfg, kind, mesh, seed=0):
    """A real CPU step of ``kind`` on ``mesh``: (step, arguments),
    ``_outputs`` flattens what it returns."""
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen, "cpu")
    sp = shard_params(cfg, params, mesh)
    shape = NUMERICS_SHAPES[kind]
    B, S = shape.batch, shape.seq
    dist = make_dist(mesh, shape)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32)
    if kind == "train":
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        return (lambda p, b: loss_and_grads(p, b, cfg, dist)), (sp, batch)
    caches = init_caches(cfg, B, S, device="cpu")
    caches = shard_caches(cfg, caches, cache_specs(cfg, shape, dist), mesh)
    return make_serve_step(cfg, dist, shape), (
        sp, tokens[:, :1], caches._replace(length=S - 1))


def _outputs(kind, out) -> list:
    if kind == "train":
        loss, grads = out
        return [loss] + [t for leaf in _leaves(grads)
                         for t in leaf.shards.values()]
    logits, new = out
    return [logits] + [t for leaf in new.kv for t in leaf.shards.values()]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class _Products(TorchDispatchMode):
    """Logs every product (an op ``flop_counter`` prices) with its
    arguments' shapes, in dispatch order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._overloadpacket in flop_registry:
            self.ops.append((str(func), [tuple(a.shape) for a in args
                                         if isinstance(a, torch.Tensor)]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("kind", ["decode", "train"])
def test_counting_leaves_the_numerics_bit_for_bit(arch, kind):
    """The serve step's logits and caches and ``loss_and_grads``' loss and
    gradients on a real CPU 2x2 mesh are bit for bit the same with the
    accounting mode on and off (it counts stand-in positions only, and
    passes a real tensor's op through untouched); and the same step run
    on stand-in positions (``step_call``, as the dry run runs it)
    dispatches the real step's products, of the same shapes in the same
    order, and counts the FLOPs ``FlopCounterMode`` counts in it."""
    cfg = get_config(arch).reduced()
    mesh = make_decode_mesh(2, 2, device="cpu")
    step, args = _real_step(cfg, kind, mesh)
    off = _outputs(kind, step(*args))
    mode = OpAnalysis()
    with mode:
        on = _outputs(kind, step(*args))
    assert mode.tallies == {}
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    flops = FlopCounterMode(display=False)
    with flops, _Products() as real:
        step(*args)
    smesh = _mesh((2, 2))
    held = DR._Params(cfg, smesh, kind == "train")
    sstep, call = DR.step_call(cfg, NUMERICS_SHAPES[kind], smesh, None, held)
    with OpAnalysis() as counted, _Products() as stand:
        sstep(*call)
    assert real.ops and stand.ops == real.ops
    assert sum(t.flops for t in counted.tallies.values()) \
        == flops.get_total_flops()


# ------------------------------------------------ reduced against whole --

# (arch, shape, mesh dims, cut depth units)
WHOLE_CASES = [
    ("smollm-360m", "train_4k", (2, 2, 2), 4),
    ("smollm-360m", "decode_32k", (2, 2), 4),
    ("llama2-70b", "prefill_32k", (2, 2, 2), 4),
    ("mamba2-2.7b", "prefill_32k", (2, 2, 2), 4),
    ("jamba-1.5-large-398b", "decode_32k", (2, 2, 2), 3),
    ("qwen3-moe-235b-a22b", "prefill_32k", (2, 2, 2), 4),
    ("mixtral-8x7b", "train_4k", (2, 2), 4),
    ("whisper-large-v3", "decode_32k", (2, 2, 2), 4),
]


@pytest.mark.parametrize("case", WHOLE_CASES,
                         ids=[f"{a}-{s}-{'x'.join(map(str, d))}"
                              for a, s, d, _ in WHOLE_CASES])
def test_reduced_runs_give_the_whole_mesh_counts(case, record_property):
    """``count``'s runs at 1-3 depth units on the first 1-3 rows,
    extrapolated, give every reported position (the first row) exactly
    the counts of the whole mesh run at full depth; the peak of live
    bytes (a bilinear estimate) within 25%."""
    arch, sname, dims, units = case
    shape = INPUT_SHAPES[sname]
    _hold_reduced_to_whole(arch, shape, dims, units,
                           256 if shape.kind == "decode" else 128,
                           record_property)


@pytest.mark.parametrize("dims", [(4, 2), (2, 4, 2)], ids=["4x2", "2x4x2"])
def test_remat_rows_are_counted_as_the_whole_mesh(dims, record_property):
    """A remat config's train step (smollm-360m.reduced() with ``remat``
    on: each layer recomputed in the backward pass) on 4 rows a pod: the
    cut runs, extrapolated, give each pod's first row the whole mesh's
    counts exactly — the recompute runs whole, so a row's counts do not
    depend on whether it is a run's last row — and the second pod's
    first row the first pod's, up to the controller's joins."""
    cfg = dataclasses.replace(DR.cut_depth(
        get_config("smollm-360m").reduced(), 4), remat=True)
    rows = int(np.prod(dims[:-1]))
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq=64,
                                batch=2 * rows)
    mesh = _mesh(dims)
    whole = DR.count(cfg, shape, mesh, whole=True)["per_position"]
    part = DR.count(cfg, shape, mesh)
    record_property("runs", part["runs"])
    assert len(part["per_position"]) == dims[-1] * (len(dims) - 1)
    for lab, rec in part["per_position"].items():
        for key in COUNTS:
            assert rec[key] == whole[lab][key], (lab, key)
    if len(dims) == 3:
        per = part["per_position"]
        assert per["(0, 0, 1)"]["collective_bytes"] \
            == per["(1, 0, 1)"]["collective_bytes"]


@pytest.mark.parametrize("start_s", [0.0, 1e9], ids=["workers", "here"])
def test_worker_processes_give_the_counts_of_one(start_s, monkeypatch):
    """``count``'s five runs of a train step made with ``workers=3`` —
    four in fresh interpreters when a worker starts at once, all in this
    process when its start-up outlasts them — give every reported
    position the counts, peaks and output bytes of one process, and the
    runs' seconds in plan order."""
    cfg = DR.cut_depth(get_config("smollm-360m").reduced(), 4)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq=64, batch=16)
    mesh = _mesh((2, 4, 2))
    one = DR.count(cfg, shape, mesh)
    monkeypatch.setattr(DR, "WORKER_START_S", start_s)
    many = DR.count(cfg, shape, mesh, workers=3)
    assert len(one["runs"]) == 5
    assert many["per_position"] == one["per_position"]
    assert many["classes"] == one["classes"]
    assert [[k, j] for k, j, _ in many["run_s"]] == one["runs"]


def test_counting_some_positions_leaves_theirs_as_they_are():
    """``OpAnalysis(only=...)``, as ``count`` uses it for the reported
    positions: those positions' counts, peaks and op tallies are what
    counting every position gives them; no other position is counted."""
    cfg = DR.cut_depth(get_config("smollm-360m").reduced(), 2)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq=64, batch=8)
    mesh = _mesh((2, 2, 2))
    held = DR._Params(cfg, mesh, True)
    keep = DR.first_rows(mesh)
    every, _, _ = DR._run(cfg, shape, mesh, 1, held, True)
    some, _, _ = DR._run(cfg, shape, mesh, 1, held, True, keep)
    assert set(some.tallies) == keep < set(every.tallies)
    for dev in keep:
        a, b = every.tallies[dev], some.tallies[dev]
        assert b.record() == a.record() and b.ops == a.ops
        assert (b.peak, b.held) == (a.peak, a.held)


# MoE steps of more than MOE_GLOBAL_DISPATCH_MAX_TOKENS tokens, whose cut
# runs have fewer: (arch, shape, mesh dims, cut depth units, seq, branch)
PAST_GLOBAL_CASES = [
    ("qwen3-moe-235b-a22b", "prefill_32k", (2, 2, 2), 4, 1024, "ep"),
    ("mixtral-8x7b", "train_4k", (2, 2), 4, 2048, "tp"),
]


@pytest.mark.parametrize("case", PAST_GLOBAL_CASES,
                         ids=[f"{a}-{s}-{'x'.join(map(str, d))}-{b}"
                              for a, s, d, _, _, b in PAST_GLOBAL_CASES])
def test_reduced_runs_past_the_global_dispatch(case, record_property):
    """A MoE step of 8,192 tokens takes the expert- or tensor-parallel
    dispatch; its runs on the first rows hold fewer tokens than
    ``MOE_GLOBAL_DISPATCH_MAX_TOKENS`` and still take that branch (the
    whole step's, through ``Dist.moe_global_max_tokens``), and their
    counts, extrapolated, equal the whole mesh run's."""
    arch, sname, dims, units, seq, branch = case
    shape = INPUT_SHAPES[sname]
    rows = int(np.prod(dims[:-1]))
    assert 2 * rows * seq > layers.MOE_GLOBAL_DISPATCH_MAX_TOKENS >= 2 * seq
    cfg = DR.cut_depth(get_config(arch).reduced(), 1)
    cut = dataclasses.replace(shape, seq=seq, batch=2 * rows)
    mesh = _mesh(dims)
    held = DR._Params(cfg, mesh, shape.kind == "train")
    for k in (None, 1):
        _, _, taken = DR._run(cfg, cut, mesh, k, held, False)
        assert taken == [branch], (k, taken)
    _hold_reduced_to_whole(arch, shape, dims, units, seq, record_property)


def _hold_reduced_to_whole(arch, shape, dims, units, seq, record_property):
    cfg = DR.cut_depth(get_config(arch).reduced(), units)
    rows = int(np.prod(dims[:-1]))
    shape = dataclasses.replace(shape, seq=seq, batch=2 * rows)
    mesh = _mesh(dims)
    whole = DR.count(cfg, shape, mesh, whole=True)["per_position"]
    part = DR.count(cfg, shape, mesh)
    record_property("runs", part["runs"])
    assert part["per_position"]
    for lab, rec in part["per_position"].items():
        for key in COUNTS:
            assert rec[key] == whole[lab][key], (lab, key)
        w = whole[lab]["peak_over_arguments"]
        assert abs(rec["peak_over_arguments"] - w) <= 0.25 * w, lab


# global dispatches whose experts used to run on owners outside the first
# row; now every position runs a share of each: (arch, shape, mesh dims,
# cut depth units, seq)
OWNER_CASES = [
    ("qwen3-moe-235b-a22b", "decode_32k", (4, 2), 2, 256),
    ("mixtral-8x7b", "decode_32k", (4, 2), 2, 256),
    ("jamba-1.5-large-398b", "decode_32k", (2, 2, 2), 3, 256),
    ("mixtral-8x7b", "train_4k", (4, 2), 3, 64),
    ("jamba-1.5-large-398b", "train_4k", (4, 2), 3, 64),
]


@pytest.mark.parametrize("case", OWNER_CASES,
                         ids=[f"{a}-{s}-{'x'.join(map(str, d))}"
                              for a, s, d, _, _ in OWNER_CASES])
def test_the_dispatch_owners_are_counted_as_the_whole_mesh(case,
                                                           record_property):
    """The global dispatch splits every expert's products over the
    positions that hold its weights (every position of the first pod),
    so the reported positions — each pod's first row — are counted, by
    the cut runs and the dispatch's correction, exactly as the whole
    mesh run counts them (the peak within 25%); every position of the
    mesh does a share of each dispatch (``_moe_dispatch_cost`` at the
    step's tokens), and the one that receives the most bytes of it is
    among those reported."""
    arch, sname, dims, units, seq = case
    _hold_reduced_to_whole(arch, INPUT_SHAPES[sname], dims, units, seq,
                           record_property)
    cfg = DR.cut_depth(get_config(arch).reduced(), units)
    rows = int(np.prod(dims[:-1]))
    shape = dataclasses.replace(INPUT_SHAPES[sname], seq=seq, batch=2 * rows)
    mesh = _mesh(dims)
    part = DR.count(cfg, shape, mesh)["per_position"]
    train = shape.kind == "train"
    tokens = shape.batch * (1 if shape.kind == "decode" else shape.seq)
    got = DR._moe_dispatch_cost(cfg, tokens, train,
                                DR._moe_layer(cfg, mesh, train), mesh)
    labels = DR.position_labels(mesh)
    pod0 = [d for d in mesh.distinct_devices()
            if labels[d][0][0] == 0 or len(dims) == 2]
    assert set(pod0) <= set(got)
    for dev in pod0:
        assert got[dev]["flops"] > 0, labels[dev]
    most = max(got, key=lambda d: sum(v for k, v in got[d].items()
                                      if k.startswith("coll:")))
    assert DR._label(labels[most][0]) in part


def test_the_second_pod_reads_its_own_replica(record_property):
    """smollm-360m.reduced()'s ``decode_32k`` (8 slots of 256) run whole
    on a (2, 2, 2) mesh: every parameter slice has a replica in each pod,
    so the second pod's first position (1, 0, 0) receives what the first
    pod's (0, 0, 0) receives, less the controller's joins — the other
    three rows' fp32 logits into (0, 0, 0), its row's int32 tokens into
    (1, 0, 0) — and every other position what its first-pod counterpart
    receives; the reduced count reports both pods' first rows."""
    cfg = DR.cut_depth(get_config("smollm-360m").reduced(), 4)
    shape = dataclasses.replace(INPUT_SHAPES["decode_32k"], seq=256, batch=8)
    mesh = _mesh((2, 2, 2))
    per = DR.count(cfg, shape, mesh, whole=True)["per_position"]
    b = shape.batch // 4
    joins = 3 * b * cfg.padded_vocab * 4 - b * 4
    got = {lab: r["collective_total"] for lab, r in per.items()}
    record_property("received", got)
    assert got["(0, 0, 0)"] - got["(1, 0, 0)"] == joins
    for d, m in ((1, 0), (0, 1), (1, 1)):
        assert per[f"(0, {d}, {m})"]["collective_bytes"] \
            == per[f"(1, {d}, {m})"]["collective_bytes"], (d, m)
    wide = dataclasses.replace(shape, batch=16)
    part = DR.count(cfg, wide, _mesh((2, 4, 2)))["per_position"]
    assert set(part) == {"(0, 0, 0)", "(0, 0, 1)", "(1, 0, 0)", "(1, 0, 1)"}


def test_the_dispatch_owners_on_a_production_mesh(record_property):
    """mixtral-8x7b's (TP) and qwen3-moe's (EP) ``decode_32k`` on 16x16:
    every position runs its share of each expert's products; a reported
    position (0, m) past the first receives, every MoE layer, only
    activations — the D_d columns of its experts' (cap, D) slabs
    (all-to-all), the other data positions' fp32 partials of its chunk
    of F and the bf16 chunks of the SwiGLU back ("tp" also the other
    model positions' fp32 partials of its chunk of D_d): no weight. The
    busiest position is reported."""
    mesh = make_production_mesh()
    shape = INPUT_SHAPES["decode_32k"]
    Dd = M = 16
    for arch in ("mixtral-8x7b", "qwen3-moe-235b-a22b"):
        cfg = get_config(arch)
        moe = cfg.moe
        rec = DR.dry_run(cfg, shape, mesh)
        per = rec["analysis"]["per_position"]
        cap = layers.moe_capacity(cfg, shape.batch)
        n_moe = cfg.n_layers // moe.every
        ep = moe.parallelism == "ep"
        E = moe.n_experts // M if ep else moe.n_experts
        F = moe.d_ff_expert if ep else moe.d_ff_expert // M
        D_d = cfg.d_model // Dd
        sums = 2 * (Dd - 1) * E * cap * F // Dd * 4 \
            + (Dd - 1) * E * cap * F // Dd * 2
        if not ep:
            sums += (M - 1) * E * cap * D_d // M * 4
        for m in range(1, M):
            r = per[f"(0, {m})"]
            assert r["collective_held"]["all-reduce"] == n_moe * sums, m
            assert r["collective_bytes"]["all-to-all"] \
                == n_moe * E * cap * D_d * 2, m
        assert "all-reduce" in rec["analysis"]["own_kinds"] + [
            c for c in COLLECTIVES
            if c not in rec["analysis"]["held_kinds"]]
        assert rec["analysis"]["position"] in per
        record_property(arch, {"position": rec["analysis"]["position"],
                               "roofline": rec["roofline"]})


def test_the_plan_extrapolates_rows_and_depth():
    """The runs of a production count: one and two rows (a Mamba2 prefill
    too: its states stay on their rows; a remat train step too: its
    recompute runs whole), 1-2 depth units (1-3 to train),
    weights that reproduce a polynomial exactly; a prefill's peak is fit
    through 2 and 3 units on one row (a run whose counts weigh 0) plus
    the rows' increment through 1 and 2."""
    mesh = make_production_mesh()
    cfg = get_config("smollm-360m")
    train = DR.plan(cfg, INPUT_SHAPES["train_4k"], mesh)
    assert cfg.remat
    assert sorted((k, j) for k, j, _, _ in train) == [
        (1, 1), (1, 2), (1, 3), (2, 1), (2, 2)]
    # the count weights evaluate A(L) + 15 B(L) at L = 32
    A = lambda j: 7 + 3 * j + 2 * j * j
    B = lambda j: 5 + 11 * j
    f = lambda k, j: A(j) + (k - 1) * B(j)
    assert sum(w * f(k, j) for k, j, w, _ in train) == A(32) + 15 * B(32)
    pre = DR.plan(cfg, INPUT_SHAPES["prefill_32k"], mesh)
    assert sorted((k, j) for k, j, _, _ in pre) == [
        (1, 1), (1, 2), (1, 3), (2, 1), (2, 2)]
    assert {j: w for k, j, w, _ in pre if k == 1}[3] == 0
    P = lambda j: 11 + 5 * j
    dP = lambda j: 3 + 2 * j
    peak = lambda k, j: P(j) + (k - 1) * dP(j) + (j == 1) * 99
    assert sum(pw * peak(k, j) for k, j, _, pw in pre) == P(32) + 15 * dP(32)
    ssm = DR.plan(get_config("mamba2-2.7b"), INPUT_SHAPES["prefill_32k"],
                  mesh)
    assert {k for k, _, _, _ in ssm} == {1, 2}
    long = DR.plan(cfg, INPUT_SHAPES["long_500k"], mesh)
    assert {k for k, _, _, _ in long} == {None}


# ------------------------------------------------------------ the meshes --

def test_production_meshes_are_stand_in_positions():
    """(16, 16) over (data, model) and (2, 16, 16) over (pod, data,
    model), as the reference's; the first ``PRODUCTION_ROWS`` rows of
    each pod — every row the plan runs a step on — each position its own
    ``cpu:k``, the later rows one stand-in per model index."""
    assert PRODUCTION_ROWS == 3 > DR.ROW_NODES[-1]
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16}
    assert m.devices[0, 3] == torch.device("cpu", 3)
    assert len(m.distinct_devices()) == 64
    assert m.devices[3, 0] == m.devices[15, 0] != m.devices[2, 0]
    m3 = make_production_mesh(multi_pod=True)
    assert m3.shape == {"pod": 2, "data": 16, "model": 16}
    assert len(m3.distinct_devices()) == 112
    assert m3.devices[1, 5, 2] == m3.devices[0, 9, 2]
    assert len({m3.devices[p, d, 2] for p in (0, 1) for d in (0, 1, 2)}) == 6
    labels = DR.position_labels(m3)
    assert labels[torch.device("cpu", 18)] == ((0, 1, 2), 1)
    assert labels[torch.device("cpu", 50)] == ((1, 0, 2), 1)
    assert labels[m3.devices[1, 5, 2]] == (("*", "*", 2), 32 - 6)
    with pytest.raises(ValueError):
        make_standin_mesh((16, 16), ("data", "model"), rows=MAX_STANDINS)


def test_count_refuses_rows_that_share_stand_ins():
    """A count runs on the first two rows (``ROW_NODES``); on a mesh whose
    first and second rows share stand-ins ``count`` refuses to merge
    them."""
    cfg = DR.cut_depth(get_config("mamba2-2.7b").reduced(), 1)
    shape = ShapeSpec("p", "prefill", 64, 8)
    assert DR.ROW_NODES == (1, 2)
    mesh = make_standin_mesh((4, 2), ("data", "model"), rows=0)
    with pytest.raises(ValueError, match="share stand-in devices"):
        DR.count(cfg, shape, mesh)


def test_row_mesh_takes_the_first_rows_in_order():
    """The first k data rows of each pod, in order; the first row of
    each pod is what a reduced count reports."""
    m = make_standin_mesh((2, 3, 4), ("pod", "data", "model"))
    sub = DR.row_mesh(m, 2)
    assert sub.shape == {"pod": 2, "data": 2, "model": 4}
    assert list(sub.devices[1, 0]) == list(m.devices[1, 0])
    assert list(sub.devices[0, 1]) == list(m.devices[0, 1])
    assert DR.first_rows(m) == set(m.devices[0, 0]) | set(m.devices[1, 0])


# ------------------------------------------------- the production meshes --

@pytest.mark.parametrize("args", [("decode_32k", False), ("train_4k", True)],
                         ids=["decode_32k-16x16", "train_4k-2x16x16"])
def test_lower_one_on_a_production_mesh(args, record_property):
    """The reference's two slow production-mesh tests: smollm-360m's
    ``decode_32k`` on 16x16 and ``train_4k`` on 2x16x16, each counted
    in under 60 s on the host CPU, the record in the reference's keys."""
    shape, multi = args
    t0 = time.time()
    rec = DR.lower_one("smollm-360m", shape, multi_pod=multi, verbose=False)
    took = time.time() - t0
    record_property("seconds", took)
    # each step run's own seconds, by (depth units, rows a pod): the runs
    # share the CPUs (``lower_one``'s workers), so ``seconds`` is about
    # the longest of them
    for k, j, s in rec["run_s"]:
        record_property(f"run_{j}_units_{k}_rows_s", float(s))
    record_property("runs_s", float(sum(s for _, _, s in rec["run_s"])))
    assert took < PROD_LIMIT_S
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    assert rec["n_devices"] == (512 if multi else 256)
    assert rec["analysis"]["flops"] > 0 and rec["cost"]["flops"] > 0
    assert set(rec["analysis"]["collective_bytes"]) == set(COLLECTIVES)
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    mem = rec["memory"]
    assert rec["path"] == "plain"
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    lo, hi = mem["peak_range"]
    assert lo <= mem["peak_bytes"] <= hi
    assert mem["fits"] == ("yes" if hi <= 80e9 else "no" if lo > 80e9
                           else "unsure")
    per = rec["analysis"]["per_position"]
    assert len(per) == (32 if multi else 16)


def test_main_reports_skips_and_writes_json(tmp_path, capsys):
    """``main`` with the reference's flags: a shape that does not apply is
    a ``skipped`` record, the JSON is written, the exit code 0."""
    out = tmp_path / "r.json"
    rc = DR.main(["--arch", "whisper-large-v3", "--shape", "long_500k",
                  "--json-out", str(out)])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert recs[0]["skipped"].startswith("decoder architecturally capped")
    assert "1 skipped, 0 failed" in capsys.readouterr().out


def test_op_tallies_add_up_to_the_counts():
    """``ops=True``: each position's op tally sums to its FLOPs and
    bytes."""
    cfg = DR.cut_depth(get_config("smollm-360m").reduced(), 2)
    shape = ShapeSpec("p", "prefill", 64, 4)
    got = DR.count(cfg, shape, _mesh((2, 2)), ops=True, whole=True)
    for lab, tally in got["ops"].items():
        rec = got["per_position"][lab]
        assert sum(r.get("flops", 0) for r in tally.values()) == rec["flops"]
        assert sum(r.get("bytes", 0) for r in tally.values()) == rec["bytes"]


def test_the_dry_run_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import repro_torch.launch.dryrun, "
         "repro_torch.launch.op_analysis; "
         "print('jax' in sys.modules)"],
        env=dict(os.environ, PYTHONPATH=SRC),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
