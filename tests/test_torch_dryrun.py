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


# global dispatches whose expert owners all sit outside the first row:
# (arch, shape, mesh dims, cut depth units, seq)
OWNER_CASES = [
    ("qwen3-moe-235b-a22b", "decode_32k", (4, 2), 2, 256),
    ("mixtral-8x7b", "decode_32k", (4, 2), 2, 256),
    ("jamba-1.5-large-398b", "decode_32k", (2, 2, 2), 3, 256),
    ("mixtral-8x7b", "train_4k", (4, 2), 3, 64),
    ("jamba-1.5-large-398b", "train_4k", (4, 2), 3, 64),
]


def _owner_groups(cfg, mesh, train) -> dict:
    """{label of the first: labels of all} of the global dispatch's
    owners outside the first row, by model index and experts run."""
    p = DR._moe_layer(cfg, mesh, train)
    coords = [tuple(c.get(a, 0) for a in mesh.axis_names)
              for c in layers.owner_coords(p["w1"])]
    groups: dict = {}
    for c, e in zip(coords, layers.owner_experts(cfg.moe.n_experts,
                                                 len(coords))):
        r, col = DR._row_col(mesh, c)
        if r and e.stop > e.start:
            groups.setdefault((col, e.stop - e.start), []).append(c)
    return {DR._label(min(m, key=lambda c: DR._row_col(mesh, c))):
            [DR._label(c) for c in m] for m in groups.values()}


@pytest.mark.parametrize("case", OWNER_CASES,
                         ids=[f"{a}-{s}-{'x'.join(map(str, d))}"
                              for a, s, d, _, _ in OWNER_CASES])
def test_the_dispatch_owners_are_counted_as_the_whole_mesh(case,
                                                           record_property):
    """``count`` reports the owners of the global dispatch's experts
    outside the first row — the first of each model index, with how many
    experts it runs and how many owners are alike — and each one's
    counts, extrapolated, are those of the whole mesh run at every owner
    alike (the peak within 25%); the position that receives the most
    bytes of one global dispatch (``_moe_dispatch_cost`` at the step's
    tokens) is among those reported."""
    arch, sname, dims, units, seq = case
    _hold_reduced_to_whole(arch, INPUT_SHAPES[sname], dims, units, seq,
                           record_property)
    cfg = DR.cut_depth(get_config(arch).reduced(), units)
    rows = int(np.prod(dims[:-1]))
    shape = dataclasses.replace(INPUT_SHAPES[sname], seq=seq, batch=2 * rows)
    mesh = _mesh(dims)
    whole = DR.count(cfg, shape, mesh, whole=True)["per_position"]
    part = DR.count(cfg, shape, mesh)["per_position"]
    groups = _owner_groups(cfg, mesh, shape.kind == "train")
    assert groups
    for first, members in groups.items():
        rec = part[first]
        assert rec["alike"] == len(members) and rec["experts"] >= 1
        for lab in members:
            for key in COUNTS:
                assert whole[lab][key] == rec[key], (lab, key)
    reported = set(part) | {lab for m in groups.values() for lab in m}
    train = shape.kind == "train"
    tokens = shape.batch * (1 if shape.kind == "decode" else shape.seq)
    got = DR._moe_dispatch_cost(cfg, tokens, train,
                                DR._moe_layer(cfg, mesh, train),
                                mesh.devices[(0,) * len(dims)])
    labels = DR.position_labels(mesh)
    most = max(got, key=lambda d: sum(v for k, v in got[d].items()
                                      if k.startswith("coll:")))
    assert DR._label(labels[most][0]) in reported


def test_the_dispatch_owners_on_a_production_mesh(record_property):
    """mixtral-8x7b's (TP) and qwen3-moe's (EP) ``decode_32k`` on 16x16:
    every expert runs on a position outside the first row; each owner is
    reported, its row's work (its first-row position at that model
    index, past the first: (0, 0) holds the controller's joins) plus, every MoE layer, the (cap, D) slabs of its experts in
    and the experts' weights it does not hold gathered — the whole
    expert less its own shard of it. The busiest position is an owner."""
    mesh = make_production_mesh()
    shape = INPUT_SHAPES["decode_32k"]
    for arch, held in (("mixtral-8x7b", 256), ("qwen3-moe-235b-a22b", 16)):
        cfg = get_config(arch)
        rec = DR.dry_run(cfg, shape, mesh)
        per = rec["analysis"]["per_position"]
        groups = _owner_groups(cfg, mesh, False)
        assert sum(len(m) for m in groups.values()) == min(
            cfg.moe.n_experts, 256)
        cap = layers.moe_capacity(cfg, shape.batch)
        n_moe = cfg.n_layers // cfg.moe.every
        expert = 3 * cfg.d_model * cfg.moe.d_ff_expert * 2
        for first, members in groups.items():
            r = per[first]
            col = first.split(", ")[-1].rstrip(")")
            if col == "0":      # (0, 0) holds the controller's joins too
                continue
            row = per[f"(0, {col})"]
            got = {k: r["collective_bytes"][k]
                   - row["collective_bytes"][k] for k in COLLECTIVES}
            assert got["all-to-all"] == n_moe * r["experts"] * cap \
                * cfg.d_model * 2
            assert got["all-gather"] == n_moe * r["experts"] * (
                expert - expert // held)
        assert rec["analysis"]["position"] in groups
        record_property(arch, {"position": rec["analysis"]["position"],
                               "roofline": rec["roofline"]})


def test_the_plan_extrapolates_rows_and_depth():
    """The runs of a production count: one and two rows (a Mamba2 prefill
    too: its states stay on their rows), 1-2 depth units (1-3 to train),
    weights that reproduce a polynomial exactly."""
    mesh = make_production_mesh()
    cfg = get_config("smollm-360m")
    train = DR.plan(cfg, INPUT_SHAPES["train_4k"], mesh)
    assert sorted((k, j) for k, j, _, _ in train) == [
        (1, 1), (1, 2), (1, 3), (2, 1), (2, 2)]
    # the count weights evaluate A(L) + 15 B(L) at L = 32
    A = lambda j: 7 + 3 * j + 2 * j * j
    B = lambda j: 5 + 11 * j
    f = lambda k, j: A(j) + (k - 1) * B(j)
    assert sum(w * f(k, j) for k, j, w, _ in train) == A(32) + 15 * B(32)
    ssm = DR.plan(get_config("mamba2-2.7b"), INPUT_SHAPES["prefill_32k"],
                  mesh)
    assert {k for k, _, _, _ in ssm} == {1, 2}
    long = DR.plan(cfg, INPUT_SHAPES["long_500k"], mesh)
    assert {k for k, _, _, _ in long} == {None}


# ------------------------------------------------------------ the meshes --

def test_production_meshes_are_stand_in_positions():
    """(16, 16) over (data, model) and (2, 16, 16) over (pod, data,
    model), as the reference's; the first ``PRODUCTION_ROWS`` rows —
    every row the plan runs a step on — each position its own ``cpu:k``,
    the later rows one stand-in per model index."""
    assert PRODUCTION_ROWS == 3
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16}
    assert m.devices[0, 3] == torch.device("cpu", 3)
    assert len(m.distinct_devices()) == 64
    assert m.devices[3, 0] == m.devices[15, 0] != m.devices[2, 0]
    m3 = make_production_mesh(multi_pod=True)
    assert m3.shape == {"pod": 2, "data": 16, "model": 16}
    assert len(m3.distinct_devices()) == 64
    assert m3.devices[1, 5, 2] == m3.devices[0, 9, 2]
    labels = DR.position_labels(m3)
    assert labels[torch.device("cpu", 18)] == ((0, 1, 2), 1)
    assert labels[m3.devices[1, 5, 2]] == (("*", "*", 2), 32 - 3)
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
    m = make_standin_mesh((2, 2, 4), ("pod", "data", "model"))
    sub = DR.row_mesh(m, 3)
    assert sub.shape == {"pod": 1, "data": 3, "model": 4}
    assert list(sub.devices[0, 2]) == list(m.devices[1, 0])


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
    assert len(rec["analysis"]["per_position"]) == 16


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
