"""Where a mesh step keeps what it makes, on a 2x2 CPU mesh at reduced
widths:

* a mesh prefill's caches are ``Sharded`` by ``launch.steps.cache_specs``
  (the reference's ``out_shardings``): gathered, bit for bit the caches
  the prefill used to join on the mesh's first position (``_joined``
  keeps that form here), for every family; each position holds its
  stripe of the KV and no more; ``make_serve_step`` decodes from them as
  they are, within the serve step's rule (``_bound``) of the unsharded
  prefill-then-decode chain; the dry run's production prefill keeps one
  stripe a position, and its peak estimate, fitted past the first
  layer's one-off growth, is within 5% of a direct run at full depth (a
  decode's too);
* the MoE global dispatch splits each expert's products where
  ``shard_params`` put its weights (fp32 partials summed once): within 2
  bf16 ulps of the dispatch it replaces (all of it on the first
  position, ``_global_whole`` here) for "ep" and "tp" configs alike, and
  no position reads a slice of ``w1``, ``w2`` or ``w3`` it does not
  hold."""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_serve_step import _bound, _ulp
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import shardings as SH
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import make_decode_mesh, make_production_mesh
from repro_torch.launch.shardings import Sharded, gather, shard_params
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import NO_DIST, Dist
from repro_torch.models.mamba import MambaState

torch.set_num_threads(1)

FAMILIES = ["smollm-360m", "qwen3-moe-235b-a22b", "mixtral-8x7b",
            "mamba2-2.7b", "jamba-1.5-large-398b", "whisper-large-v3",
            "internvl2-26b"]
B, S = 4, 48


def _mesh():
    return make_decode_mesh(2, 2, device="cpu")


def _setup(name, batch=B, seq=S):
    cfg = get_config(name).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(7)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    extra = {}
    if cfg.encoder_layers:
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "patch":
        extra["patches"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    return cfg, params, tok, extra


def _joined(params, tokens, cfg, dist, extra):
    """The caches a mesh prefill used to return: every data row's KV and
    encoder K/V joined on the mesh's first position, the Mamba2 states
    gathered whole there."""
    with torch.no_grad():
        x = T._embed(params, tokens, cfg, dist)
        enc_kv = None
        if cfg.encoder_layers:
            enc_kv = T._encoder_kv(params, extra["frames"], cfg, dist,
                                   train=False)
        elif "patches" in extra:
            x = T._prepend(x, extra["patches"], dist)
        _, _, kvs, ssm = T._run_stack(
            params, x, cfg, mode="prefill",
            caches=T.Caches(kv=None, length=0, enc_kv=enc_kv), dist=dist)
    dev = dist.grid()[0, 0]
    kv = None
    if kvs:
        kv = T.KVCache(*(torch.stack([L.join_rows([p[i] for p in rows], dev)
                                      for rows in kvs]) for i in range(2)))
    if ssm is not None:
        ssm = MambaState(ssm=gather(ssm.ssm, dev), conv=gather(ssm.conv, dev))
    if enc_kv is not None:
        enc_kv = T.KVCache(*(torch.cat([e[i].to(dev) for e in enc_kv], 1)
                             for i in range(2)))
    return T.Caches(kv=kv, length=x[0].shape[1], ssm=ssm, enc_kv=enc_kv)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_caches_stay_on_their_stripes(name):
    """The caches come back ``Sharded`` with ``cache_specs``' specs;
    gathered, they equal the joined form bit for bit; the logits are on
    the first position; each KV shard holds 1/4 of the KV (two rows x
    two model stripes), each Mamba2 shard its row's half of the heads."""
    cfg, params, tok, extra = _setup(name)
    mesh = _mesh()
    dist = Dist(mesh=mesh, batch_axes=("data",))
    sp = shard_params(cfg, params, mesh)
    logits, c = STEPS.make_prefill_step(cfg, dist)(sp, tok, extra)
    want = _joined(sp, tok, cfg, dist, extra)
    specs = STEPS.cache_specs(cfg, None, dist)
    assert logits.device == dist.grid()[0, 0] and c.length == want.length
    for f in ("kv", "ssm", "enc_kv"):
        got, ref, spec = getattr(c, f), getattr(want, f), getattr(specs, f)
        assert (got is None) == (ref is None) == (spec is None), f
        for a, b, s in zip(got or (), ref or (), spec or ()):
            assert isinstance(a, Sharded) and a.spec == tuple(s), (f, a.spec)
            assert torch.equal(gather(a, "cpu"), b), f
            n = len(a.shards)
            assert all(t.numel() * n == b.numel() for t in a.shards.values())
    if c.kv is not None:
        assert len(c.kv.k.shards) == 4


def test_a_batch_of_one_stripes_over_every_position():
    """A batch of one (``make_dist`` drops the batch axes): the KV
    sequence stripes over all four positions, data-major, each stripe
    the contiguous quarter of the sequence."""
    cfg, params, tok, _ = _setup("smollm-360m", batch=1, seq=64)
    mesh = _mesh()
    sh = dataclasses.replace(STEPS.INPUT_SHAPES["prefill_32k"], batch=1,
                             seq=64)
    dist = STEPS.make_dist(mesh, sh)
    _, c = STEPS.make_prefill_step(cfg, dist)(shard_params(cfg, params, mesh),
                                              tok, {})
    _, whole = T.prefill(params, tok, cfg)
    k = c.kv.k
    assert k.spec == (None, None, ("data", "model"), None, None)
    for key, t in k.shards.items():
        co = k.coords(key)
        j = 2 * co["data"] + co["model"]
        assert t.shape[2] == 16
        assert (t.float() - whole.kv.k[:, :, 16 * j:16 * (j + 1)].float()
                ).abs().max() <= 2e-2 * whole.kv.k.float().abs().max()


def test_a_prefill_that_does_not_split_is_refused():
    """47 tokens over two model stripes: refused, as ``shard_caches`` and
    the reference's ``out_shardings`` refuse it. The serve step's room
    for decode (``pad_seq``) lays 48 striped slots out as 64, gathered
    the prefill's KV then zeros, each shard a quarter; 49 slots, which
    do not split, are refused."""
    cfg, params, tok, _ = _setup("smollm-360m", seq=48)
    mesh = _mesh()
    dist = Dist(mesh=mesh, batch_axes=("data",))
    sp = shard_params(cfg, params, mesh)
    with pytest.raises(ValueError, match="does not split evenly"):
        STEPS.make_prefill_step(cfg, dist)(sp, tok[:, :47], {})
    _, c = STEPS.make_prefill_step(cfg, dist)(sp, tok, {})
    k = SH.pad_seq(c.kv.k, 64, 2)
    assert k.spec == c.kv.k.spec and k.shape[2] == 64
    assert all(t.shape[2] == 32 for t in k.shards.values())
    whole = gather(k, "cpu")
    assert torch.equal(whole[:, :, :48], gather(c.kv.k, "cpu"))
    assert not whole[:, :, 48:].any()
    with pytest.raises(ValueError, match="does not split evenly"):
        SH.pad_seq(c.kv.k, 49, 2)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_then_serve_equals_the_unsharded_chain(name,
                                                       record_property):
    """``make_prefill_step`` on 2x2 then 8 serve steps of
    ``make_serve_step`` (a shape 8 tokens longer) on its caches as they
    are, against the unsharded ``prefill`` then ``make_serve_step``
    chain, both teacher-forced
    on the unsharded stream, the MoE layers under the unsharded run's
    routing: the prefill logits within 2e-2 of their scale
    (``test_make_prefill_step_matches_the_unsharded_prefill``'s rule;
    jamba's 4e-2), every serve step's within ``_bound`` (the serve step's
    rule: 4 bf16 ulps, 6 for the routed families, 8e-2 of the scale for
    the hybrid), argmax equal wherever the top-2 gap exceeds twice
    that."""
    cfg, params, tok, extra = _setup(name)
    mesh = _mesh()
    n = S + (cfg.frontend_tokens if "patches" in extra else 0)
    sh = dataclasses.replace(STEPS.INPUT_SHAPES["decode_32k"], batch=B,
                             seq=n + 8)
    dist = STEPS.make_dist(mesh, sh)
    sp = shard_params(cfg, params, mesh)
    with L.record_routing() as routes, torch.no_grad():
        lw, caches = T.prefill(params, tok, cfg, frames=extra.get("frames"),
                               patches=extra.get("patches"))
    with L.replay_routing(routes):
        lm, sc = STEPS.make_prefill_step(cfg, dist)(sp, tok, extra)
    tol = 4e-2 if cfg.attn_every else 2e-2
    assert (lm - lw).abs().max() <= tol * lw.abs().max()
    step, whole = (STEPS.make_serve_step(cfg, d, sh) for d in (dist, NO_DIST))
    nxt = lw.argmax(-1)[:, None].to(torch.int32)
    worst = 0.0
    for _ in range(8):
        with L.record_routing() as routes:
            lw, caches = whole(params, nxt, caches)
        with L.replay_routing(routes):
            lm, sc = step(sp, nxt, sc)
        scale = lw.abs().max().item()
        err = (lm - lw).abs().max().item()
        bound = _bound(cfg, scale)
        assert err <= bound, (err, bound)
        worst = max(worst, err / _ulp(scale))
        top2 = lw.topk(2, dim=-1).values
        decisive = (top2[..., 0] - top2[..., 1]) > 2 * bound
        assert torch.equal(lm.argmax(-1)[decisive], lw.argmax(-1)[decisive])
        nxt = lw.argmax(-1).to(torch.int32)
    assert sc.length == caches.length == n + 8
    record_property("worst_ulps", worst)


def _one_row_peaks(cfg, shape, mesh, depths) -> dict:
    """{depth: the peak over the arguments at (0, 0)} of the step run on
    the mesh's first row at each depth."""
    peaks = {}
    for depth in depths:
        c = DR.cut_depth(cfg, depth)
        mode, _, _ = DR._run(c, shape, mesh, 1, DR._Params(c, mesh, False),
                             False)
        t = mode.tallies[mesh.devices[0, 0]]
        peaks[depth] = t.peak - t.held
    return peaks


def _fit(peaks: dict, depth: int) -> float:
    """The plan's one-row peak fit, affine through 2 and 3 units, at
    ``depth``."""
    return sum(w * peaks[j] for j, w in zip((2, 3),
                                            DR.lagrange((2, 3), depth)))


def test_the_production_prefill_keeps_one_stripe_a_position(
        record_property):
    """The dry run of phi3-mini's ``prefill_32k`` on 16x16: every
    reported position's outputs are its stripe of the 412 GB KV
    (1/256 of it; the logits besides at (0, 0)), and the (0, 0) peak is
    below one data row's KV (25.8 GB), where the joined caches of all 16
    rows made it 417 GB. The same step run on one row at 1, 2, 3 and all
    32 layers (``peaks``): the plan's fit at one row (through 2 and 3
    layers: the first layer's one-off growth, the embedding's output,
    is not taken for every layer) is within 5% of the full-depth run,
    and the 16-row estimate no lower than that run, which too stays
    below one row's KV."""
    cfg = get_config("phi3-mini-3.8b")
    shape = STEPS.INPUT_SHAPES["prefill_32k"]
    mesh = make_production_mesh()
    rec = DR.count(cfg, shape, mesh)
    kv = 2 * cfg.n_layers * shape.batch * shape.seq * cfg.n_kv_heads \
        * cfg.head_dim * 2
    logits = shape.batch * cfg.padded_vocab * 4
    per = rec["per_position"]
    assert len(per) == 16
    for lab, r in per.items():
        assert r["output_bytes"] == kv // 256 + logits * (lab == "(0, 0)"), lab
    estimate = per["(0, 0)"]["peak_over_arguments"]
    assert estimate < kv // 16
    peaks = _one_row_peaks(cfg, shape, mesh, (1, 2, 3, cfg.n_layers))
    fit = _fit(peaks, cfg.n_layers)
    record_property("peaks", {"estimate": estimate, "one_row_fit": fit,
                              "one_row": peaks})
    assert abs(fit - peaks[cfg.n_layers]) <= 0.05 * peaks[cfg.n_layers]
    assert peaks[cfg.n_layers] <= estimate and peaks[cfg.n_layers] < kv // 16


def test_the_production_decode_peak_fit_is_within_five_percent(
        record_property):
    """llama2-70b's ``decode_32k`` on 16x16, on one row: the plan's peak
    fit through 2 and 3 layers, evaluated at all 80, within 5% of the
    step run at 80 layers (``peaks``)."""
    cfg = get_config("llama2-70b")
    shape = STEPS.INPUT_SHAPES["decode_32k"]
    mesh = make_production_mesh()
    peaks = _one_row_peaks(cfg, shape, mesh, (2, 3, cfg.n_layers))
    fit = _fit(peaks, cfg.n_layers)
    record_property("peaks", {"one_row_fit": fit, "one_row": peaks})
    assert abs(fit - peaks[cfg.n_layers]) <= 0.05 * peaks[cfg.n_layers]


# ------------------------------------------------- the MoE global dispatch --

def _global_whole(hs, p, cfg, dev, T_total):
    """The global dispatch the port used to run: every row's tokens and
    every expert's weights on the first position."""
    h = torch.cat([t.to(dev) for t in hs])
    return L._moe_dispatch_compute(
        h, gather(p["router"], dev), gather(p["w1"], dev),
        gather(p["w2"], dev), gather(p["w3"], dev), cfg.moe.top_k,
        L.moe_capacity(cfg, T_total))


def _moe_layer(cfg, sp):
    if cfg.attn_every:
        return T._layer(T._layer(sp["ffn_moe"], 0), 0)
    return T._layer(sp["moe"], 0)


def _span(index, shape) -> tuple:
    return tuple(s.indices(n)[:2] for s, n in
                 zip(tuple(index) + (slice(None),) * (len(shape)
                                                      - len(index)), shape))


@pytest.mark.parametrize("tokens", [48, 1000])
@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b"])
def test_global_dispatch_runs_where_the_experts_are(name, tokens,
                                                    monkeypatch,
                                                    record_property):
    """4 rows' worth of tokens (2 data rows x ``tokens`` x 2 sequences)
    through ``moe_block``'s global branch: aux bitwise the whole
    dispatch's on the first position and y within 2 bf16 ulps of its
    largest (``_moe_tp``'s bound; the split sums fp32 partials, rounded
    once: the share of outputs that differ is recorded), for "ep" and
    for "tp"; every ``take`` of ``w1``, ``w2`` or ``w3`` is one shard's
    block, read on the position that holds it — no weight crosses
    positions. At 1,000 tokens a capacity factor of 1 drops choices."""
    cfg = get_config(name).reduced()
    if tokens > 500:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = _mesh()
    dist = Dist(mesh=mesh, batch_axes=("data",))
    p = _moe_layer(cfg, shard_params(cfg, params, mesh))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, tokens, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    taken = []

    def spy(fn, kind):
        def wrapped(leaf, device, *a, **kw):
            for n in ("w1", "w2", "w3"):
                if leaf is p[n]:
                    taken.append((n, kind, device, a))
            return fn(leaf, device, *a, **kw)
        return wrapped
    monkeypatch.setattr(L, "take", spy(SH.take, "take"))
    monkeypatch.setattr(L, "gather", spy(SH.gather, "gather"))
    with L.record_moe_branches() as branch:
        y, aux = L.moe_block(x, p, cfg, dist)
    monkeypatch.undo()
    assert branch == ["global"]
    assert taken and all(kind == "take" for _, kind, _, _ in taken)
    for n, _, device, (index,) in taken:
        leaf = p[n]
        holders = [k for k in leaf.shards
                   if _span(leaf.index(k), leaf.shape)
                   == _span(index, leaf.shape)]
        assert len(holders) == 1, (n, index)
        assert SH.position_device(mesh, leaf.coords(holders[0])) == device
    rows = L.split_rows(x, dist)
    hs = [L.rms_norm(r, gather(p["ln"], r.device), cfg.norm_eps)
          .reshape(-1, cfg.d_model) for r in rows]
    want, want_aux = _global_whole(hs, p, cfg, dist.grid()[0, 0],
                                   4 * tokens)
    want = want.view(x.shape)
    assert torch.equal(aux, want_aux)
    scale = want.float().abs().max().item()
    err = (y.float() - want.float()).abs().max().item()
    record_property("ulps", err / _ulp(scale))
    record_property("differ", (y != want).float().mean().item())
    assert err <= 2 * _ulp(scale)


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "mixtral-8x7b"])
def test_global_dispatch_turns_off_a_callers_tf32(name, monkeypatch):
    """A caller's ``set_float32_matmul_precision("medium")`` (TF32, or
    bf16 products on a CPU that has them) does not reach the router's
    and the split's fp32 products: the split runs at "highest", y is bit
    for bit the default run's, and the caller's setting is back after
    the call."""
    cfg = get_config(name).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = _mesh()
    dist = Dist(mesh=mesh, batch_axes=("data",))
    p = _moe_layer(cfg, shard_params(cfg, params, mesh))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 48, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    want, _ = L.moe_block(x, p, cfg, dist)
    seen = []
    split = L._expert_split

    def spy(*a, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return split(*a, **kw)
    monkeypatch.setattr(L, "_expert_split", spy)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        y, _ = L.moe_block(x, p, cfg, dist)
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen == ["highest"] and after == "medium"
    assert torch.equal(y, want)


def _dispatch_counts(cfg, hs, p, mesh, T_total, fn=None) -> dict:
    """{position: op-analysis record} of the global dispatch (or of
    ``fn``) on stand-ins."""
    from repro_torch.launch.op_analysis import OpAnalysis
    mode = OpAnalysis()
    with mode, torch.no_grad():
        if fn is None:
            L._moe_global(hs, p, cfg, mesh, mesh.devices[0, 0], T_total)
        else:
            fn()
    return {d: t.record() for d, t in mode.tallies.items()}


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "mixtral-8x7b"])
def test_expert_owners_follow_the_weights(name):
    """Every position of a 2x2 stand-in mesh runs the share of the
    expert products whose weights it holds — "ep": its block of experts
    over its 'data' quarter of D for w1 and w3 and its D_d outputs of
    w2; "tp": its F_m columns and D_d rows — so each position's FLOPs
    are a quarter of the whole expert FFN's, G = 3·2·E·cap·D·F, and the
    first position also routes (2·T·D·E)."""
    from repro_torch.launch.mesh import make_standin_mesh
    from repro_torch.launch.op_analysis import standin
    cfg = get_config(name).reduced()
    mesh = make_standin_mesh((2, 2), ("data", "model"))
    grid = mesh.devices
    p = DR._moe_layer(cfg, mesh, False)
    hs = [standin((64, cfg.d_model), L.DTYPE, grid[r, 0]) for r in range(2)]
    got = _dispatch_counts(cfg, hs, p, mesh, 128)
    moe = cfg.moe
    G = 3 * 2 * moe.n_experts * L.moe_capacity(cfg, 128) * cfg.d_model \
        * moe.d_ff_expert
    router = 2 * 128 * cfg.d_model * moe.n_experts
    assert len(got) == 4
    for dev, rec in got.items():
        assert rec["flops"] == G // 4 + router * (dev == grid[0, 0]), dev


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "mixtral-8x7b"])
def test_global_dispatch_copies_no_whole_expert_weights(name):
    """Counted by the op analysis on a 2x2 stand-in mesh (2 rows x 64
    tokens): the global dispatch copies no byte of ``w1``, ``w2`` or
    ``w3`` between positions — every plain gather (all-gather) is the
    router's other half and the second row's tokens into (0, 0) and its
    gates back out — where the one-position dispatch copied into (0, 0)
    the three quarters of them it did not hold; the expert slabs and
    outputs are all-to-alls, the partial sums all-reduces."""
    from repro_torch.launch.mesh import make_standin_mesh
    from repro_torch.launch.op_analysis import standin
    cfg = get_config(name).reduced()
    mesh = make_standin_mesh((2, 2), ("data", "model"))
    grid = mesh.devices
    p = DR._moe_layer(cfg, mesh, False)
    weights = sum(p[n].numel() * 2 for n in ("w1", "w2", "w3"))
    hs = [standin((64, cfg.d_model), L.DTYPE, grid[r, 0]) for r in range(2)]
    split = _dispatch_counts(cfg, hs, p, mesh, 128)
    whole = _dispatch_counts(cfg, hs, p, mesh, 128, lambda: _global_whole(
        hs, p, cfg, grid[0, 0], 128))
    D, E, k = cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k
    gathered = {grid[0, 0]: D // 2 * E * 2 + 64 * D * 2,
                grid[1, 0]: 64 * k * 2}
    for dev, rec in split.items():
        assert rec["collective_bytes"]["all-gather"] == gathered.get(
            dev, 0), dev
    assert whole[grid[0, 0]]["collective_bytes"]["all-gather"] \
        >= 3 * weights // 4
    for kind in ("all-to-all", "all-reduce"):
        assert sum(r["collective_bytes"][kind] for r in split.values()) > 0
