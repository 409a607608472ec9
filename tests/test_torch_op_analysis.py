"""The port's dry-run accounting (``repro_torch.launch.op_analysis`` and
``launch.dryrun``) against the reference's (``repro/launch/dryrun.py``,
``hlo_analysis.py``): the mirrors of ``tests/test_infra.py``'s HLO
analysis tests, the dot FLOPs of every family's train, prefill and
decode steps without a mesh, and on a 2x2 (and one 2x2x2) mesh the
argument bytes and every position's FLOPs against the reference's
per-device numbers.

The reference lowers and compiles its steps in ONE subprocess on 8
forced host devices, started first and read when needed; it reports
``analyze(compiled.as_text())``'s FLOPs and collectives and
``memory_analysis().argument_size_in_bytes``. The port counts its own
steps on stand-in positions (``dry_run``), run whole.

Every difference is named, with its FLOPs or bytes and the position
that has it:

  * without a mesh, Mamba2's SSD scan to train: the reference's
    gradient of the chunks' C·Bᵀ contraction takes six products of the
    forward's size (four of it and one of twice it) where autograd takes
    two, so the port counts 4 × F_cb fewer FLOPs a Mamba2 layer
    (F_cb = 2·B·(S/chunk)·chunk²·d_state);
  * argument bytes: the port's step takes the whole batch's inputs on
    the mesh's first position, where it splits them into data rows (the
    reference's in-shardings give each device its row's share), and a
    decode's cache length is a Python int where the reference passes an
    int32 scalar; jit drops arguments a step never reads
    (``keep_unused=False``: whisper's encoder in a decode);
  * per position (2x2): the K and V projections of the KV heads each
    model position's query heads read — position 0 reads two of the
    reduced configs' KV heads (whisper's four), the reference's split
    gives each device one (two); a Mamba2 mixer's in_proj columns of B
    and C, which every model position projects whole, and its chunks'
    C·Bᵀ, computed at every model position of a row (the reference
    splits both over 'model'); the MoE global dispatch's router (at most
    4,096 tokens), which routes every row's tokens on the first position
    where a reference device does its share as XLA partitions it — its
    expert products run where their weights are, a reference device's
    share (``_moe_global``); whisper's encoder, cross-attention
    K/V and cross-attention, whole on each row's first position where a
    reference device does 1/M of them (``_encoder_whole``). Each in the
    forward, and in the train step also in its two gradient products.

ROADMAP §3 records these with the measured FLOPs.

Collective bytes are not held against the reference's: XLA's
partitioner picks the reference's collectives (it also gathers
activations and reshards attention with all-to-all and permutes), the
port's are the copies its mesh code makes. The per-position test
records both side by side; the collectives test holds the port's kinds
to the copies the model makes, in closed form.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import SRC
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import op_analysis as OA
from repro_torch.launch.mesh import make_standin_mesh
from repro_torch.launch.steps import ShapeSpec
from repro_torch.models.layers import _head_stripes

torch.set_num_threads(1)

FAMILIES = ("smollm-360m", "phi3-mini-3.8b", "qwen3-moe-235b-a22b",
            "mixtral-8x7b", "mamba2-2.7b", "jamba-1.5-large-398b",
            "whisper-large-v3", "internvl2-26b")
KINDS = ("train", "prefill", "decode")
MESH_FAMILIES = ("smollm-360m", "qwen3-14b", "mixtral-8x7b",
                 "qwen3-moe-235b-a22b", "whisper-large-v3", "mamba2-2.7b",
                 "jamba-1.5-large-398b")

# (tag, arch, reduced, kind, batch, seq, mesh dims or None)
NO_MESH = [(f"{a}-{k}", a, True, k, 2, 128 if k == "decode" else 64, None)
           for a in FAMILIES for k in KINDS]
# full-width smollm-360m: train 2 x 512, prefill 1 x 1024, decode 4 x 2048
FULL = [("full-train", "smollm-360m", False, "train", 2, 512, None),
        ("full-prefill", "smollm-360m", False, "prefill", 1, 1024, None),
        ("full-decode", "smollm-360m", False, "decode", 4, 2048, None)]
MESH = [(f"{a}-{k}-2x2", a, True, k, 4, 256 if k == "decode" else 128,
         (2, 2)) for a in MESH_FAMILIES for k in KINDS]
MESH3 = [("smollm-360m-train-2x2x2", "smollm-360m", True, "train", 8, 128,
          (2, 2, 2))]
CASES = NO_MESH + FULL + MESH + MESH3

REFERENCE = r'''
import json
import sys

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs.base import get_config
from repro.launch.hlo_analysis import analyze
from repro.launch.shardings import param_specs
from repro.launch.steps import (ShapeSpec, cache_specs, input_specs,
                                make_dist, make_prefill_step,
                                make_serve_step, make_train_step,
                                opt_state_shapes, opt_state_specs)
from repro.models.layers import NO_DIST
from repro.models.transformer import init_params


def lower(cfg, shape, dims):
    p_shapes = jax.eval_shape(lambda k: init_params(cfg, k),
                              jax.random.PRNGKey(0))
    o_shapes = opt_state_shapes(cfg, p_shapes)
    if dims is None:
        args, _ = input_specs(cfg, shape, NO_DIST)
        extra = {k: v for k, v in args.items()
                 if k not in ("tokens", "caches")}
        if shape.kind == "train":
            low = jax.jit(make_train_step(cfg, NO_DIST)).lower(
                p_shapes, o_shapes, args["batch"])
        elif shape.kind == "prefill":
            low = jax.jit(make_prefill_step(cfg, NO_DIST)).lower(
                p_shapes, args["tokens"], extra)
        else:
            low = jax.jit(make_serve_step(cfg, NO_DIST, shape)).lower(
                p_shapes, args["tokens"], args["caches"])
        comp = low.compile()
    else:
        axes = ("data", "model") if len(dims) == 2 \
            else ("pod", "data", "model")
        n = int(np.prod(dims))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(dims), axes)
        dist = make_dist(mesh, shape)
        ns = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                    is_leaf=lambda s: isinstance(s, P))
        p_specs = param_specs(cfg, p_shapes)
        args, a_specs = input_specs(cfg, shape, dist)
        a_shard = ns(a_specs)
        rep = NamedSharding(mesh, P())
        with mesh:
            if shape.kind == "train":
                o_shard = ns(opt_state_specs(cfg, p_specs, p_shapes))
                low = jax.jit(
                    make_train_step(cfg, dist),
                    in_shardings=(ns(p_specs), o_shard, a_shard["batch"]),
                    out_shardings=(rep, ns(p_specs), o_shard)).lower(
                    p_shapes, o_shapes, args["batch"])
            elif shape.kind == "prefill":
                extra = {k: v for k, v in args.items() if k != "tokens"}
                low = jax.jit(
                    make_prefill_step(cfg, dist),
                    in_shardings=(ns(p_specs), a_shard["tokens"],
                                  {k: a_shard[k] for k in extra}),
                    out_shardings=(rep, ns(cache_specs(cfg, shape, dist)))
                ).lower(p_shapes, args["tokens"], extra)
            else:
                c_shard = ns(a_specs["caches"])
                low = jax.jit(
                    make_serve_step(cfg, dist, shape),
                    in_shardings=(ns(p_specs), a_shard["tokens"], c_shard),
                    out_shardings=(rep, c_shard)).lower(
                    p_shapes, args["tokens"], args["caches"])
            comp = low.compile()
    a = analyze(comp.as_text())
    return {"flops": a["flops"],
            "collective_bytes": a["collective_bytes"],
            "collective_counts": a["collective_counts"],
            "argument_bytes": int(
                comp.memory_analysis().argument_size_in_bytes)}


out = {}
for tag, arch, reduced, kind, batch, seq, dims in json.loads(sys.argv[1]):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    out[tag] = lower(cfg, ShapeSpec(tag, kind, seq, batch), dims)
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's counts of every case (one subprocess, 8 forced
    host devices), read when first needed."""
    path = str(tmp_path_factory.mktemp("dryrun_ref") / "ref.json")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(CASES), path],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    got = {}

    def result(tag):
        if not got:
            _, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, err[-3000:]
            with open(path) as f:
                got.update(json.load(f))
        return got[tag]
    try:
        yield result
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def _port(case, *, ops=False):
    tag, arch, reduced, kind, batch, seq, dims = case
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    mesh = None if dims is None else make_standin_mesh(
        dims, ("data", "model") if len(dims) == 2
        else ("pod", "data", "model"))
    return cfg, DR.dry_run(cfg, ShapeSpec(tag, kind, seq, batch), mesh,
                           ops=ops, whole=True)


# --------------------------------------------------- test_infra mirrors --

def test_a_loop_of_products_counts_every_step():
    """``test_hlo_analysis_counts_scan_trips``: a 7-step loop of 64³
    products counts 2·64³·7 FLOPs (eager: the loop dispatches 7
    products)."""
    W = OA.standin((7, 64, 64), torch.float32, "cpu:0")
    x = OA.standin((64, 64), torch.float32, "cpu:0")

    def g(x):
        for i in range(7):
            x = x @ W[i]
        return x
    r = OA.analyze(g, x)
    assert r["flops"] == 2 * 64 * 64 * 64 * 7
    assert list(r["per_position"]) == ["cpu:0"]


def test_roofline_terms_take_the_h100_peaks():
    """``test_hlo_analysis_roofline_terms`` on the H100 defaults: 989e12
    FLOPs take 1 s, 3.35e12 bytes take 1 s, 450e9 collective bytes 1 s."""
    r = OA.roofline_terms({"flops": 989e12, "bytes": 3.35e12,
                           "collective_total": 0.0})
    assert r["t_compute_s"] == pytest.approx(1.0)
    assert r["t_memory_s"] == pytest.approx(1.0)
    assert r["bottleneck"] in ("compute", "memory")
    r = OA.roofline_terms({"flops": 0.0, "bytes": 0.0,
                           "collective_total": 450e9})
    assert r["t_collective_s"] == pytest.approx(1.0)
    assert r["bottleneck"] == "collective" and r["t_bound_s"] == r[
        "t_collective_s"]


# ------------------------------------------------- FLOPs without a mesh --

def _ssd_train_gap(cfg, batch, seq) -> int:
    """The FLOPs autograd's SSD gradient takes fewer than the
    reference's: 4·F_cb a Mamba2 layer (module docstring)."""
    if cfg.ssm is None or cfg.kind not in ("ssm", "hybrid"):
        return 0
    chunk, n = cfg.ssm.chunk, cfg.ssm.d_state
    f_cb = 2 * batch * (-(-seq // chunk)) * chunk * chunk * n
    mamba_layers = cfg.n_layers - (cfg.n_layers // cfg.attn_every
                                   if cfg.attn_every else 0)
    return 4 * f_cb * mamba_layers


@pytest.mark.parametrize("case", NO_MESH + FULL, ids=[c[0] for c in
                                                      NO_MESH + FULL])
def test_flops_without_a_mesh_equal_the_reference(reference, case,
                                                  record_property):
    """The unsharded step's dot FLOPs equal the reference's compiled
    step's, to the FLOP — less the named SSD gradient gap to train."""
    cfg, rec = _port(case)
    ref = reference(case[0])
    gap = _ssd_train_gap(cfg, case[4], case[5]) if case[3] == "train" \
        else 0
    record_property("flops", (rec["cost"]["flops"], ref["flops"], gap))
    assert rec["cost"]["flops"] == ref["flops"] - gap


# ------------------------------------------------ argument bytes on 2x2 --

def _input_bytes(cfg, kind, batch, seq) -> tuple:
    """(token bytes, frame or patch bytes) of a step's inputs."""
    frontend = 4 * batch * cfg.frontend_tokens * cfg.d_model \
        if cfg.frontend in ("patch", "audio") and kind != "decode" else 0
    per = {"train": 2 * seq, "prefill": seq, "decode": 1}[kind]
    return 4 * batch * per, frontend


# leaves a decode never reads: the encoder, and the cross-attention's
# K/V projections (its K/V are the caches' ``enc_kv``)
UNREAD = ("enc_attn", "enc_mlp", "enc_final_ln", ("cross_attn", "wk"),
          ("cross_attn", "wv"), ("cross_attn", "bk"), ("cross_attn", "bv"))


def _unread_bytes(cfg, mesh) -> int:
    """The first position's bytes of the leaves a decode never reads."""
    from repro_torch.launch.shardings import (_tree_paths, param_shapes,
                                              param_specs)
    shapes = param_shapes(cfg)
    specs = param_specs(cfg, shapes)
    acc: dict = {}
    for (path, meta), (_, spec) in zip(_tree_paths(shapes),
                                       _tree_paths(specs)):
        if path[0] in UNREAD or path[:2] in UNREAD:
            DR._place(acc, mesh, spec, meta)
    return acc.get((0,) * len(mesh.axis_names), 0)


@pytest.mark.parametrize("case", MESH + MESH3, ids=[c[0] for c in
                                                    MESH + MESH3])
def test_argument_bytes_on_a_mesh_equal_the_reference(reference, case,
                                                      record_property):
    """The first position's argument bytes (its shards, every replicated
    leaf, the caches' stripes) equal the reference's per-device argument
    bytes, with the named differences: the port's first position holds
    every row's inputs (the reference's device its row's share; a frame
    or patch input the reference also splits over 'model'), the
    reference passes a decode's cache length as an int32 scalar, and
    its jit drops arguments the step never reads (whisper's encoder and
    cross-attention K/V weights in a decode)."""
    tag, arch, _, kind, batch, seq, dims = case
    cfg, rec = _port(case)
    ref = reference(tag)
    mesh = make_standin_mesh(dims, ("data", "model") if len(dims) == 2
                             else ("pod", "data", "model"))
    rows = DR.n_rows(mesh)
    first = "(" + ", ".join("0" for _ in dims) + ")"
    port = rec["analysis"]["per_position"][first]["argument_bytes"]
    tokens, frontend = _input_bytes(cfg, kind, batch, seq)
    named = tokens - tokens // rows + frontend - frontend // (
        rows * dims[-1])
    if kind == "decode":
        named -= 4
        named += _unread_bytes(cfg, mesh)
    record_property("bytes", (port, ref["argument_bytes"], named))
    assert port == ref["argument_bytes"] + named
    assert rec["memory"]["argument_bytes"] == max(
        r["argument_bytes"] for r in rec["analysis"]["per_position"].values())


# --------------------------------------------- per-position FLOPs (2x2) --

def _named_extra(cfg, kind, batch, seq, dims, r, m) -> int:
    """The FLOPs position (r, m) does beyond the reference's per-device
    count (module docstring), summed over the layers."""
    rows, M = dims[0], dims[1]
    b = batch // rows
    t = b * (1 if kind == "decode" else seq)
    passes = 3 if kind == "train" else 1
    D, Dh = cfg.d_model, cfg.head_dim
    extra = 0
    if cfg.attention_layers:
        # the K and V projections of the KV heads this position reads
        used = len(_head_stripes(cfg, M)[m][0])
        extra += passes * 2 * 2 * t * D * Dh * (used * M - cfg.n_kv_heads) \
            // M * cfg.attention_layers
    if cfg.ssm is not None and cfg.kind in ("ssm", "hybrid"):
        # in_proj's B and C columns and the chunks' C·Bᵀ at every position
        n, chunk = cfg.ssm.d_state, cfg.ssm.chunk
        mix = passes * 2 * t * D * 2 * n * (M - 1) // M
        if kind != "decode":
            f_cb = 2 * b * (seq // chunk) * chunk * chunk * n
            mix += f_cb * (M - 1) // M if kind == "prefill" \
                else 3 * f_cb - 7 * f_cb // M
        extra += mix * (cfg.n_layers - cfg.attention_layers)
    if cfg.moe is not None:
        extra += _moe_global(cfg, kind, batch, t * rows, dims, r, m)
    if cfg.encoder_layers:
        extra += _encoder_whole(cfg, kind, b, seq, dims, m)
    return extra


def _moe_global(cfg, kind, batch, T, dims, r, m) -> int:
    """The MoE global dispatch (all T ≤ 4,096 tokens): the port's first
    position routes every row's tokens, R (the router's 2·T·D·E; to
    train also its two gradient products), where a reference device
    does R / D (prefill: the row's router, replicated over 'model'),
    R / (D·M) (decode) or 2·R / D + R / (D·M) (train: the forward and
    input gradient replicated, the weight gradient split), as XLA
    partitions it. The expert products are not named: each position
    runs the experts (EP) or hidden columns (TP) it holds, G / (D·M) of
    G = 3·2·E·C·D·F at capacity C, as a reference device does."""
    from repro_torch.models.layers import MOE_GLOBAL_DISPATCH_MAX_TOKENS
    assert T <= MOE_GLOBAL_DISPATCH_MAX_TOKENS    # the global branch
    moe = cfg.moe
    rows, M = dims
    n_moe = cfg.n_layers // moe.every if cfg.attn_every else cfg.n_layers
    R = 2 * T * cfg.d_model * moe.n_experts * n_moe
    P = rows * M
    ref = {"prefill": R // rows, "decode": R // P,
           "train": 2 * R // rows + R // P}[kind]
    first = (r, m) == (0, 0)
    return (3 if kind == "train" else 1) * R * first - ref


def _encoder_whole(cfg, kind, b, seq, dims, m) -> int:
    """The encoder, the cross-attention K/V and the cross-attention run
    whole on a row's first position (a reference device does 1/M of
    them): X·(M−1)/M there, −X/M at the others; X over the row's b
    sequences of F frames and, for the decoder's T tokens, every layer's
    projections, scores and PV (train: three passes)."""
    M = dims[1]
    D, Dh, F = cfg.d_model, cfg.head_dim, cfg.frontend_tokens
    hq, hkv, ff = cfg.padded_heads * Dh, cfg.n_kv_heads * Dh, cfg.d_ff
    t_f, t_d = b * F, b * (1 if kind == "decode" else seq)
    s_d = 1 if kind == "decode" else seq
    cross = 2 * t_d * D * hq * 2 + 2 * 2 * b * cfg.padded_heads * s_d \
        * F * Dh
    X = cross * cfg.n_layers
    if kind != "decode":
        enc = 2 * t_f * D * hq * 2 + 2 * 2 * t_f * D * hkv \
            + 2 * 2 * b * cfg.padded_heads * F * F * Dh + 3 * 2 * t_f * D * ff
        X += enc * cfg.encoder_layers + 2 * 2 * t_f * D * hkv * cfg.n_layers
    X *= 3 if kind == "train" else 1
    return X * (M - 1) // M if m == 0 else -X // M


@pytest.mark.parametrize("case", MESH, ids=[c[0] for c in MESH])
def test_per_position_flops_equal_the_reference_but_named_work(
        reference, case, record_property):
    """Every position's FLOPs on the 2x2 mesh equal the reference's
    per-device count plus the work the module docstring names, to the
    FLOP."""
    tag, arch, _, kind, batch, seq, dims = case
    cfg, rec = _port(case)
    ref = reference(tag)["flops"]
    got = {}
    for lab, r in rec["analysis"]["per_position"].items():
        row, m = (int(x) for x in lab.strip("()").split(", "))
        got[lab] = (r["flops"] - ref, _named_extra(cfg, kind, batch, seq,
                                                   dims, row, m))
    record_property("gaps", got)
    record_property("collectives", {
        "reference": {k: reference(tag)[k] for k in ("collective_bytes",
                                                     "collective_counts")},
        "port": {lab: {k: r[k] for k in ("collective_bytes",
                                         "collective_counts")}
                 for lab, r in rec["analysis"]["per_position"].items()}})
    assert len(got) == 4
    for lab, (gap, named) in got.items():
        assert gap == named, (lab, gap, named)


# --------------------------------------------- the port's collectives --

# (arch, seq): a batch of 4 prefilled on 2x2 — dense, and a MoE step of
# 8,192 tokens, past the global dispatch, expert-parallel
COLLECTIVE_CASES = [("smollm-360m", 128), ("qwen3-14b", 128),
                    ("qwen3-moe-235b-a22b", 2048)]


@pytest.mark.parametrize("case", COLLECTIVE_CASES,
                         ids=[a for a, _ in COLLECTIVE_CASES])
def test_collectives_are_the_copies_the_mesh_code_makes(case):
    """Every position's all-reduce, all-to-all, reduce-scatter and
    collective-permute bytes and counts in a prefill on 2x2 are those of
    the copies the mesh code names (``shardings.collective``): a row's
    first position takes M − 1 partials of its row's t × D activations
    for the embedding and each row-parallel projection (attention's
    output, a dense MLP's down projection), and the first position 4
    bytes of each other position's MoE aux loss a layer; the
    expert-parallel dispatch sends each position a slab of E/ep · C
    rows from each other position and one back, and its t/ep tokens
    from (and, on the row's first position, to) the row's first
    position; nothing is a reduce-scatter or a permute."""
    from repro_torch.models.layers import (MOE_GLOBAL_DISPATCH_MAX_TOKENS,
                                           moe_capacity)
    arch, seq = case
    rows, M, batch = 2, 2, 4
    cfg, rec = _port((arch, arch, True, "prefill", batch, seq, (rows, M)))
    D, t = cfg.d_model, batch // rows * seq
    moe = cfg.moe is not None
    assert moe == (rows * t > MOE_GLOBAL_DISPATCH_MAX_TOKENS)
    sums = 1 + cfg.n_layers * (1 if moe else 2)
    for lab, r in rec["analysis"]["per_position"].items():
        row, m = (int(x) for x in lab.strip("()").split(", "))
        want = {c: (0, 0) for c in OA.COLLECTIVES if c != "all-gather"}
        n = sums * (M - 1) if m == 0 else 0
        want["all-reduce"] = (n * t * D * 2, n)
        if moe:
            E_loc, t_loc = cfg.moe.n_experts // M, t // M
            cap = moe_capacity(cfg, t_loc)
            aux = (rows * M - 1) * cfg.n_layers if (row, m) == (0, 0) \
                else 0
            want["all-reduce"] = (want["all-reduce"][0] + 4 * aux,
                                  want["all-reduce"][1] + aux)
            parts = M - 1 if m == 0 else 1
            want["all-to-all"] = (
                cfg.n_layers * (2 * (M - 1) * E_loc * cap + parts * t_loc)
                * D * 2, cfg.n_layers * (2 * (M - 1) + parts))
        got = {c: (r["collective_bytes"][c], r["collective_counts"][c])
               for c in want}
        assert got == want, lab
