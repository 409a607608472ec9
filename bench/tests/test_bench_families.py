"""A model family is a file: a configuration names its family, and the
harness, the run, the check, the metrics and the faults meet the model
only through the family's hooks (``bench/families/__init__.py``).

A throwaway family registered by the test, with a depth cut through the
configuration's ``reduced``, runs a whole rehearsal through the
unedited benchmark; no module outside the families, the reference and
the counts reads a shape key of the model; a configuration without a
family is refused; and the dense family gives what the code before the
families gave, bit for bit, pinned at the tiny sizes of both cells."""
import ast
import copy
import hashlib
import json
import shutil
import sys
import threading
import types

import pytest
import torch

from bench import faults, families, run, spec
from bench.families import dense
from conftest import CELLS, CONFIGS, _tiny, _tiny_cell, config

SHAPE_KEYS = {"hidden_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "head_dim", "intermediate_size",
              "qk_norm"}
#: where a module may read a shape key of the model
ALLOWED = (spec.BENCH / "families", spec.BENCH / "reference",
           spec.BENCH / "counts.py")
TEMPLATE = "phi3-mini.chat-sessions"


# ---- a throwaway family, through the unedited benchmark ----

def _cut_family(seen: dict):
    """The dense family with its depth cut to one layer through the
    configuration's ``reduced``; it notes the depth each hook sees."""
    fam = types.ModuleType("bench.families.cut_dense")

    def tiny(config):
        c, cfg = dense.tiny(config)
        c = dict(c, num_hidden_layers=1, reduced=["num_hidden_layers"])
        return c, dense.held(cfg, c)

    def draw(cfg, seed, device):
        seen["port"] = cfg.n_layers
        return dense.draw(cfg, seed, device)

    def reference(params, cfg, control=False):
        ref = dense.reference(params, cfg, control)
        seen.setdefault("reference", set()).add(ref.a["layers"])
        return ref

    def counts(config):
        a = dense.counts(config)
        seen["counts"] = a.layers
        return a
    fam.__dict__.update(port_config=dense.port_config, tiny=tiny, draw=draw,
                        reference=reference, counts=counts,
                        KERNELS=dense.KERNELS, FAULTS=dense.FAULTS)
    return fam


@pytest.fixture
def cut_cell(tmp_path, monkeypatch):
    """A cell of the throwaway family, its configuration, traffic and
    workload files written into a copy of ``bench/``."""
    seen: dict = {}
    monkeypatch.setitem(sys.modules, "bench.families.cut_dense",
                        _cut_family(seen))
    bench = tmp_path / "bench"
    shutil.copytree(spec.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = spec.find_cell(TEMPLATE)
    name = "phi3-mini-cut.chat-cut"
    files = {"configs/phi3-mini-cut.json": dict(
                base.config, name="phi3-mini-cut", family="cut-dense"),
             "traffic/chat-cut.json": base.traffic,
             f"workloads/{name}.json": base.workload}
    for rel, body in files.items():
        (bench / rel).write_text(json.dumps(body))
    monkeypatch.setattr(spec, "BENCH", bench)
    b = copy.deepcopy(spec.benchmark())
    entry = {"name": name, "config": "phi3-mini-cut", "traffic": "chat-cut",
             "chips": 1, "why": "the chat cell's mix on a cut dense stack"}
    b["workloads"].append(entry)
    for m in b["end_to_end"] + b["per_layer"]:
        if TEMPLATE in m.get("workloads", ()):
            m["workloads"].append(name)
    cell, cfg = _tiny_cell(spec.load_cell(entry, b))
    return cell, cfg, seen


@pytest.mark.parametrize("trace", [False, True])
def test_a_family_file_runs_a_whole_rehearsal(cut_cell, trace):
    cell, cfg, seen = cut_cell
    assert cell.config["reduced"] == ["num_hidden_layers"]
    assert cfg.n_layers == 1 and cell.config["num_hidden_layers"] == 1
    out = run.execute(cell, 2 ** 32 + 17, 3.0, trace, torch.device("cpu"),
                      cfg=cfg, log=lambda s: None)
    assert out["correct"] and out["attempted"] > 0, out["check"]
    assert out["check"]["sampled"]["value"] >= 2
    assert seen == {"port": 1, "reference": {1}, "counts": 1}
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(out["metrics"]) <= want
    if trace:
        assert {"mfu.chat", "decode_step_ms.chat"} <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == want
    assert not [t for t in threading.enumerate()
                if t.name.startswith("bench-")]


def test_a_family_files_fault_comes_out_not_correct(cut_cell):
    cell, cfg, _ = cut_cell
    assert set(faults.points(cell)) == set(faults.FAULTS) | set(dense.FAULTS)
    with faults.plant("step_state_unchanged", cell):
        out = run.execute(cell, 2 ** 32 + 19, 3.0, False,
                          torch.device("cpu"), cfg=cfg, log=lambda s: None)
    assert out["check"]["sampled"]["value"] >= 2
    assert not out["correct"], out["check"]


# ---- the shape keys stay in the families ----

def _shape_keys(path) -> list:
    return [(node.lineno, node.value)
            for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Constant) and node.value in SHAPE_KEYS]


def test_no_module_outside_the_families_reads_a_shape_key():
    found, allowed = {}, {}
    for p in sorted(spec.BENCH.rglob("*.py")):
        if "tests" in p.relative_to(spec.BENCH).parts:
            continue
        keys = _shape_keys(p)
        if any(p == a or a in p.parents for a in ALLOWED):
            allowed[p.name] = keys
        elif keys:
            found[str(p.relative_to(spec.BENCH))] = keys
    assert not found
    assert allowed["dense.py"] and allowed["counts.py"]     # the scan sees


# ---- a configuration names its family ----

def test_a_configuration_without_a_family_is_refused():
    c = config(CONFIGS[0])
    del c["family"]
    with pytest.raises(ValueError, match="names no family.*dense"):
        families.of(c)
    assert "dense" in families.present()


@pytest.mark.parametrize("name", CONFIGS)
def test_port_config_is_the_file(name):
    c = config(name)
    cfg = families.of(c).port_config(c)
    assert cfg.vocab_size == c["vocab_size"]
    assert cfg.norm_eps == float(c["rms_norm_eps"])


def test_dense_takes_only_the_listed_cut_from_the_file():
    c = dict(config("qwen3-14b"), num_hidden_layers=3)
    with pytest.raises(ValueError, match="not the configuration"):
        dense.port_config(c)
    cfg = dense.port_config(dict(c, reduced=["num_hidden_layers"]))
    assert cfg.n_layers == 3 and cfg.d_model == c["hidden_size"]
    with pytest.raises(ValueError, match="cannot take"):
        dense.port_config(dict(c, reduced=["num_experts"]))
    with pytest.raises(ValueError, match="not the configuration"):
        dense.port_config(dict(c, reduced=["num_hidden_layers"],
                               hidden_size=4096))


# ---- the dense family is the code before it, bit for bit ----

#: from the benchmark's code before the families, at each cell's tiny size
#: (conftest's): SHA-256 of the weights' bytes for two seeds, of the
#: reference's and the fp8 control's logits on a 300-token prompt, and the
#: counts on a grid of chunks and decode steps
SEEDS = (2 ** 31 + 5, 2 ** 40 + 3)
CHUNKS = ((0, 256, False), (0, 300, True), (256, 512, False),
          (768, 1000, True), (1024, 4096, True))
STEPS = ((1, 1), (3, 100), (8, 8000), (16, 65536))
PINS = {
    "phi3-mini.chat-sessions": dict(
        weights=("a65790140155e93fdf976dd365466ef9e8e9955a1e23daa615dc97eb050e074a",
                 "094b672f79aaff34ce152b3a1f5147c92ce105c432dd85ccca07e4e662e4fe4a"),
        logits="5c9854acaed568bfb85a9f25dede27b07dd4bc603e02fb1dffa3568aff615636",
        control="d4750a9f7f9a1c5de916a849c66cedfc81f0d95ea183acf509aee8675ba69ece",
        chunk=[570556416.0, 675641344.0, 637665280.0, 696930304.0,
               14497349632.0],
        decode=[2360320.0, 7180288.0, 27066368.0, 104857600.0]),
    "qwen3-14b.long-docs-backlog": dict(
        weights=("524e7b38aae60dd0bda0aa2cf6f6935d4fdc6b868defb861c2e7dd421f04e79f",
                 "5834754bf5a422357fcee16d5800b4c0d1c17d065e9f720b3e5f9543a3c59880"),
        logits="d08cb085bf1e22b6638059374c177d32cf7a44f16e805c0e11860261385d8ff5",
        control="7c6828151224a4562186ed28cbd2135c0e74ebedb6fca6aa6d184977e7178702",
        chunk=[537001984.0, 636319744.0, 604110848.0, 666521600.0,
               14094696448.0],
        decode=[2229248.0, 6787072.0, 26017792.0, 102760448.0]),
}


def _sha_tree(tree: dict) -> str:
    h = hashlib.sha256()

    def walk(node, pre):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k], pre + (k,))
            else:
                v = node[k].contiguous()
                h.update("/".join(pre + (k,)).encode())
                h.update(str(tuple(v.shape)).encode())
                h.update(v.view(torch.uint8).numpy().tobytes())
    walk(tree, ())
    return h.hexdigest()


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("name", CELLS)
def test_dense_is_the_code_before_the_families(name):
    pin = PINS[name]
    cell, cfg = _tiny(name)
    fam = families.of(cell.config)
    assert fam is dense
    assert tuple(_sha_tree(fam.draw(cfg, s, "cpu")) for s in SEEDS) == \
        pin["weights"]
    p = fam.draw(cfg, SEEDS[0], "cpu")
    toks = torch.randint(0, cfg.vocab_size, (300,),
                         generator=torch.Generator().manual_seed(7))
    assert _sha(fam.reference(p, cfg).logits(toks, 0)) == pin["logits"]
    assert _sha(fam.reference(p, cfg, control=True).logits(toks, 0)) == \
        pin["control"]
    a = fam.counts(cell.config)
    assert [a.chunk_flops(*c) for c in CHUNKS] == pin["chunk"]
    assert [a.decode_flops(*s) for s in STEPS] == pin["decode"]
