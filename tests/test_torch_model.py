"""The port's model forwards against the reference's, with the reference's
``init_params`` weights passed across by ``bridge.params_from_jax``:
first-token logits, 16 teacher-forced decode steps through the dense
per-slot path and the paged path, and the greedy rule (tokens equal
wherever the reference's top-1/top-2 gap exceeds 4e-2; near-ties are
counted and reported). Plus the port's own exactness properties:
chunked prefill equals one-shot prefill, paged equals dense, and the
weight bridge and ``init_params`` layout.

Logits agree within 2e-2 of the logit scale (max |logit|, at least 1):
both sides round logits to bf16, whose ulp at the largest logits here
(3.7–4.1) is 0.016–0.031, so an element-wise 2e-2 would sit below one
ulp; the observed differences are 1–2 ulps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
import repro_torch.models.transformer as TT
from repro_torch.bridge import params_from_jax, tensor_to_numpy
from repro_torch.configs.base import get_config

# small shapes: one intra-op thread keeps parallel test workers from
# oversubscribing the CPU
torch.set_num_threads(1)

TOL = 2e-2
GAP = 4e-2
STEPS = 16
PAGE = 16
PROMPTS = (70, 37)           # two slots at different depths


@pytest.fixture(scope="module", params=["smollm-360m", "qwen2.5-3b"])
def model(request):
    jcfg = jax_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    forced = rng.integers(0, cfg.vocab_size,
                          (len(PROMPTS), STEPS)).astype(np.int32)
    return jcfg, cfg, jp, tp, prompts, forced


def _close_logits(port: torch.Tensor, ref: np.ndarray, what: str) -> None:
    err = np.abs(tensor_to_numpy(port) - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), (what, err)


def _greedy_rule(ref: np.ndarray, port: np.ndarray) -> int:
    """Assert top-1 equality where the reference is decisive; return the
    number of near-ties skipped."""
    top2 = np.sort(ref, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > GAP
    assert (ref.argmax(-1)[decisive] == port.argmax(-1)[decisive]).all()
    return int((~decisive).sum())


def _jax_run(jcfg, jp, prompts, forced, paged: bool):
    """Reference: prefill each prompt, then STEPS teacher-forced decode
    steps of the 2-slot batch. Returns first-token and per-step logits."""
    firsts, kvs = [], []
    for p in prompts:
        lg, c = JT.prefill(jp, jnp.asarray(p[None]), jcfg)
        firsts.append(np.asarray(lg[0]))
        kvs.append((np.asarray(c.kv.k[:, 0], np.float32),
                    np.asarray(c.kv.v[:, 0], np.float32)))
    B, L = len(prompts), jcfg.n_layers
    lens = np.asarray([len(p) for p in prompts], np.int32)
    max_len = int(lens.max()) + STEPS
    steps = []
    if paged:
        mp = -(-max_len // PAGE)
        P = 1 + B * mp
        kp = np.zeros((L, P, PAGE) + kvs[0][0].shape[2:], np.float32)
        vp = np.zeros_like(kp)
        table = np.zeros((B, mp), np.int32)
        for b, (k, v) in enumerate(kvs):
            table[b] = 1 + b * mp + np.arange(mp)
            n = k.shape[1]
            kf = kp[:, table[b]].reshape(L, mp * PAGE, *k.shape[2:])
            vf = vp[:, table[b]].reshape(L, mp * PAGE, *k.shape[2:])
            kf[:, :n], vf[:, :n] = k, v
            kp[:, table[b]] = kf.reshape(L, mp, PAGE, *k.shape[2:])
            vp[:, table[b]] = vf.reshape(L, mp, PAGE, *k.shape[2:])
        step = jax.jit(lambda t, kp, vp, tbl, ln: JT.decode_step_paged(
            jp, t, kp, vp, tbl, ln, jcfg))
        kp, vp = (jnp.asarray(a, jnp.bfloat16) for a in (kp, vp))
        for s in range(STEPS):
            lg, kp, vp = step(jnp.asarray(forced[:, s:s + 1]), kp, vp,
                              jnp.asarray(table), jnp.asarray(lens + s))
            steps.append(np.asarray(lg[:, 0]))
    else:
        c = JT.init_caches(jcfg, B, max_len)
        k, v = np.zeros(c.kv.k.shape, np.float32), np.zeros(c.kv.v.shape,
                                                            np.float32)
        for b, (kb, vb) in enumerate(kvs):
            k[:, b, :kb.shape[1]], v[:, b, :vb.shape[1]] = kb, vb
        c = c._replace(kv=JT.KVCache(jnp.asarray(k, jnp.bfloat16),
                                     jnp.asarray(v, jnp.bfloat16)),
                       length=jnp.asarray(lens))
        step = jax.jit(lambda t, c: JT.decode_step(jp, t, c, jcfg))
        for s in range(STEPS):
            lg, c = step(jnp.asarray(forced[:, s:s + 1]), c)
            steps.append(np.asarray(lg[:, 0]))
    return np.stack(firsts), np.stack(steps)


def _port_run(cfg, tp, prompts, forced, paged: bool):
    firsts, kvs = [], []
    for p in prompts:
        lg, c = TT.prefill(tp, torch.from_numpy(p[None]), cfg)
        firsts.append(lg[0])
        kvs.append((c.kv.k[:, 0], c.kv.v[:, 0]))
    B, L = len(prompts), cfg.n_layers
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    max_len = int(lens.max()) + STEPS
    tokens = torch.from_numpy(forced).long()
    steps = []
    if paged:
        mp = -(-max_len // PAGE)
        kp = torch.zeros((L, 1 + B * mp, PAGE) + kvs[0][0].shape[2:],
                         dtype=torch.bfloat16)
        vp = torch.zeros_like(kp)
        table = torch.zeros((B, mp), dtype=torch.int32)
        for b, (k, v) in enumerate(kvs):
            table[b] = 1 + b * mp + torch.arange(mp)
            n = k.shape[1]
            for t0 in range(0, n, PAGE):
                pid = int(table[b, t0 // PAGE])
                m = min(PAGE, n - t0)
                kp[:, pid, :m], vp[:, pid, :m] = k[:, t0:t0 + m], v[:, t0:t0 + m]
        for s in range(STEPS):
            lg, _, _ = TT.decode_step_paged(tp, tokens[:, s:s + 1], kp, vp,
                                            table, lens + s, cfg)
            steps.append(lg[:, 0])
    else:
        c = TT.init_caches(cfg, B, max_len, device="cpu")
        for b, (k, v) in enumerate(kvs):
            c.kv.k[:, b, :k.shape[1]], c.kv.v[:, b, :v.shape[1]] = k, v
        c = c._replace(length=lens.clone())
        for s in range(STEPS):
            lg, c = TT.decode_step(tp, tokens[:, s:s + 1], c, cfg)
            steps.append(lg[:, 0])
    return torch.stack(firsts), torch.stack(steps)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_and_teacher_forced_decode_match_reference(model, paged,
                                                           record_property):
    jcfg, cfg, jp, tp, prompts, forced = model
    jf, js = _jax_run(jcfg, jp, prompts, forced, paged)
    tf, ts = _port_run(cfg, tp, prompts, forced, paged)
    _close_logits(tf, jf, "first token")
    for s in range(STEPS):
        _close_logits(ts[s], js[s], f"decode step {s}")
    ties = _greedy_rule(np.concatenate([jf[None], js]),
                        tensor_to_numpy(torch.cat([tf[None], ts])))
    record_property("near_ties_skipped", ties)
    print(f"{cfg.name} {'paged' if paged else 'dense'}: {ties} near-ties "
          f"skipped of {(STEPS + 1) * len(prompts)} positions")


def test_paged_equals_dense_inside_the_port(model):
    _, cfg, _, tp, prompts, forced = model
    _, dense = _port_run(cfg, tp, prompts, forced, paged=False)
    _, paged = _port_run(cfg, tp, prompts, forced, paged=True)
    assert torch.equal(paged, dense)        # bit-exact on the CPU


def test_chunked_prefill_equals_one_shot(model):
    _, cfg, _, tp, prompts, _ = model
    p = torch.from_numpy(prompts[0][None])
    one, c1 = TT.prefill(tp, p, cfg)
    c = TT.init_caches(cfg, 1, p.shape[1], device="cpu")
    for lo in range(0, p.shape[1], 32):
        lg, c = TT.decode_step(tp, p[:, lo:lo + 32], c, cfg)
    assert c.length == p.shape[1]
    assert torch.equal(lg[:, -1], one)
    assert torch.equal(c.kv.k, c1.kv.k) and torch.equal(c.kv.v, c1.kv.v)


def test_bridge_is_bit_exact(model):
    jcfg, cfg, jp, tp, _, _ = model
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16 and tuple(node.shape) == leaf.shape
        assert np.array_equal(node.view(torch.int16).numpy(),
                              np.asarray(leaf).view(np.int16)), path


def test_init_params_matches_reference_layout(model):
    jcfg, cfg, jp, _, _, _ = model
    tp = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                        for k, v in t.items()}
    assert shapes(tp) == jax.tree.map(lambda a: tuple(a.shape), jp,
                                      is_leaf=lambda a: hasattr(a, "shape"))
    Hp, Dh = cfg.padded_heads, cfg.head_dim
    pad_cols = tp["attn"]["wq"][:, :, cfg.n_heads * Dh:Hp * Dh]
    assert pad_cols.abs().max() == 0                      # padded heads: q=0
    assert tp["attn"]["wq"][:, :, :cfg.n_heads * Dh].abs().max() > 0
    n_port = sum(t.numel() for stack in (tp, tp["attn"], tp["mlp"])
                 for t in stack.values() if isinstance(t, torch.Tensor))
    assert n_port == sum(a.size for a in jax.tree.leaves(jp))


def test_cuda_device_requested_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = get_config("smollm-360m").reduced()
    with pytest.raises(RuntimeError, match="no GPU"):
        TT.init_caches(cfg, 1, 8)
