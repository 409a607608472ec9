"""What decides ``correct``: the served tokens of a sample of finished
requests, held against the plain reference.

Once the window has closed and the program's state is freed, a sample
drawn from the seed of the requests the run finished (the longest
among them, in a cell with prefix reuse one whose prefix came from the
host pool, and at least ``requests`` of them with ``min_tokens`` served
tokens in all) is run through the reference once, each request's prompt
with its served tokens. For every served token the gap by which its
reference logit lies below the reference's best at that position is
read; the widest gap over the sample is compared with the cell's limit.
Every sampled stream must also hold as many tokens as it asked for.

The reference and the control come from the configuration's family
(``bench/families/``). The control is the reference in the precision
below the configuration's (for the dense family, fp8) put in the
program's place: at the same positions it takes the token the control
puts first, and its widest gap (``control_gap``) is held to the same
limit through the same ``passes``, where it has to come out not correct.
"""
from __future__ import annotations

import numpy as np


def finished(data) -> list:
    """Records that finished on their own (not cut at the close), in the
    warm phase or the window."""
    return [r for r in data.records.values()
            if r.accepted and r.done and not r.cut]


def sample(data, seed: int, n: int, min_tokens: int = 0) -> list:
    """Finished requests drawn from ``seed``: the longest (prompt plus
    output), then one that reused pool blocks if any did, then at random
    until there are ``n`` and they served ``min_tokens`` tokens or more
    (or none is left)."""
    pool = finished(data)
    if not pool:
        return []
    pool = sorted(pool, key=lambda r: r.rid)
    chosen = [max(pool, key=lambda r: (r.prompt_len + len(r.tokens), r.rid))]
    reused = [r for r in pool if r.reused_blocks > 0 and r not in chosen]
    rng = np.random.default_rng([int(seed) % (1 << 32), int(seed) >> 32, 17])
    if reused:
        chosen.append(reused[int(rng.integers(len(reused)))])
    rest = [r for r in pool if r not in chosen]
    for i in rng.permutation(len(rest)):
        if len(chosen) >= n and \
                sum(len(r.tokens) for r in chosen) >= min_tokens:
            break
        chosen.append(rest[i])
    return chosen


def _teacher_forced(model, prompt, served, device):
    import torch
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(served[:-1], np.int64)])
    return model.logits(torch.as_tensor(seq, device=device), len(prompt) - 1)


def gaps(ref, data, recs: list, device, control=None) -> dict:
    """Per request: the widest gap of the served tokens under ``ref``,
    and with ``control`` the widest gap of the control's first choices
    (each an object with ``logits(tokens, first)`` over the published
    vocabulary)."""
    import torch
    out = {}
    for r in recs:
        served = np.asarray(r.tokens, np.int64)
        lg = _teacher_forced(ref, data.prompts[r.rid], served, device)
        V = lg.shape[-1]
        best = lg.max(dim=-1).values
        ok = torch.as_tensor(served < V, device=lg.device)
        idx = torch.as_tensor(np.minimum(served, V - 1), device=lg.device)
        g = best - lg.gather(1, idx[:, None])[:, 0]
        g = torch.where(ok, g, torch.full_like(g, float("inf")))
        row = {"served": float(g.max()), "tokens": int(len(served))}
        if control is not None:
            lc = _teacher_forced(control, data.prompts[r.rid], served, device)
            pick = lc.argmax(dim=-1)
            row["control"] = float((best - lg.gather(1, pick[:, None])[:, 0])
                                   .max())
            del lc
        out[r.rid] = row
        del lg
    return out


def decide(data, ref, seed: int, device, control=None) -> dict:
    """The numbers compared and their limits under the reference
    ``ref``; with the ``control`` reference also the control's
    reading."""
    chk = data.cell.workload["check"]
    recs = sample(data, seed, int(chk["requests"]),
                  int(chk.get("min_tokens", 0)))
    per = gaps(ref, data, recs, device, control)
    widest = max((v["served"] for v in per.values()), default=float("inf"))
    short = sum(1 for r in recs if len(r.tokens) != r.max_new)
    numbers = {
        "sampled": {"value": len(recs), "limit": 1, "at_least": True},
        "max_logit_gap": {"value": widest,
                          "limit": float(chk["max_logit_gap"])},
        "short_streams": {"value": short, "limit": 0},
    }
    out = {"numbers": numbers, "per_request": per,
           "reused_in_sample": sum(1 for r in recs if r.reused_blocks),
           "sampled_tokens": sum(len(r.tokens) for r in recs)}
    if control is not None:
        out["control_gap"] = max((v["control"] for v in per.values()),
                                 default=float("nan"))
        out["control_numbers"] = dict(numbers, max_logit_gap=dict(
            numbers["max_logit_gap"], value=out["control_gap"]),
            short_streams=dict(numbers["short_streams"], value=0))
    return out


def passes(numbers: dict) -> bool:
    for v in numbers.values():
        if v.get("at_least"):
            if not v["value"] >= v["limit"]:
                return False
        elif not v["value"] <= v["limit"]:
            return False
    return True
