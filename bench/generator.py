"""The one traffic generator: sessions of turns, read from a mix's data
file (``traffic/<name>.json``) and a cell's load (``workloads/<cell>.json``).

A mix is a set of sessions. A session may open with one of a few shared
system prompts (chosen Zipf-like, each a whole number of 512-token
blocks), then runs 1 or more turns: turn 1's prompt is the system prompt
plus new input; turn k+1's prompt is turn k's prompt, plus turn k's
output as this generator drew it (never the tokens the system served),
plus new input. A session ends after its turns, or before a turn whose
prompt plus ``output_reserve`` would pass ``context``. New input and
output lengths are clipped lognormals; the think time after a turn is
exponential plus a per-output-token term.

Every seed gets the same set of session shapes and the same arrival
times, in another order: the shapes come from the mix's ``shape_seed``
and the arrivals from the cell's load, while the run's seed draws the
order of the shapes and every token. The order is dealt in rounds
(``balanced_order``): the shapes are ranked by their work and cut into
as many strata as a round has sessions, and each round takes one shape
of every stratum, so that any stretch of a run holds nearly the same
mix whatever the seed. A mix of one-turn sessions balances its input
and its output lengths each on its own (``balanced_pairs``).

Load, open loop: sessions start as a Poisson process of
``session_rate`` a second; each turn is due at its session's start plus
the think times before it. Sessions also start in the mix's ``lead_s``
seconds before the traffic does, and only their turns due from time 0
on are sent, so the arrivals are steady from the first second. Closed
loop: ``clients`` clients each work through their own list of sessions
back to back, the next turn sent when the previous one completes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

BLOCK = 512          # the port's host-pool block (``core.trace.BLOCK_TOKENS``)


@dataclass
class Turn:
    """One request: its prompt, the tokens it asks for, and the think
    time before the session's next turn."""
    rid: int
    session: int
    tokens: np.ndarray          # int32 prompt
    max_new: int
    think_s: float
    due: Optional[float] = None  # open loop: seconds from traffic start


@dataclass
class Session:
    sid: int
    system_prompt: int           # index, or -1 for none
    turns: list = field(default_factory=list)


def _seed_words(seed: int) -> list:
    """A non-negative seed of any size as SeedSequence words."""
    seed = int(seed) % (1 << 64)
    return [seed & 0xFFFFFFFF, seed >> 32]


def _lognormal(rng, spec: dict, n: int) -> np.ndarray:
    x = rng.lognormal(spec["mu"], spec["sigma"], size=n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def _zipf_choice(rng, n: int, s: float, size: int) -> np.ndarray:
    p = np.arange(1, n + 1, dtype=np.float64) ** -s
    return rng.choice(n, size=size, p=p / p.sum())


@dataclass
class _Shape:
    """A session's sizes before tokens: system prompt, per-turn new input
    and output lengths, and think times."""
    system_prompt: int
    inputs: list
    outputs: list
    thinks: list


def _shapes(mix: dict, n: int) -> tuple[list, list]:
    """``n`` session shapes and the system prompts' block counts, from
    the mix's ``shape_seed`` alone."""
    rng = np.random.default_rng(int(mix["shape_seed"]))
    sp = mix.get("system_prompts") or {"count": 0}
    sys_blocks = [int(b) for b in rng.integers(
        sp.get("blocks_min", 1), sp.get("blocks_max", 1) + 1,
        size=int(sp["count"]))]
    t = mix["turns"]
    n_turns = rng.integers(t["min"], t["max"] + 1, size=n)
    sys_idx = (_zipf_choice(rng, sp["count"], sp["zipf_s"], n)
               if sp["count"] else np.full(n, -1))
    think = mix.get("think_s", {"mean": 0.0, "per_output_token": 0.0})
    shapes = []
    for i in range(n):
        k = int(n_turns[i])
        outs = _lognormal(rng, mix["output"], k)
        thinks = (rng.exponential(think["mean"], size=k)
                  if think["mean"] > 0 else np.zeros(k))
        thinks = thinks + think["per_output_token"] * outs
        shapes.append(_Shape(int(sys_idx[i]),
                             [int(x) for x in _lognormal(rng, mix["new_input"], k)],
                             [int(x) for x in outs],
                             [float(x) for x in thinks]))
    return shapes, sys_blocks


def _work(sh: _Shape) -> int:
    return sum(sh.inputs) + sum(sh.outputs)


def balanced_order(work: list, size: int, seed: int) -> list:
    """Every index of ``work`` once, in rounds of ``size``: the indices
    ranked by work are cut into ``size`` strata of nearly equal length,
    and round r holds one index of each stratum. Which one, and the order
    within the round, are drawn from ``seed``."""
    rng = np.random.default_rng(_seed_words(seed) + [7])
    strata = [rng.permutation(s) for s in
              np.array_split(np.argsort(work, kind="stable"), size)]
    order = []
    for r in range(max(len(s) for s in strata)):
        pick = [int(s[r]) for s in strata if r < len(s)]
        order.extend(pick[i] for i in rng.permutation(len(pick)))
    return order


def balanced_pairs(shapes: list, size: int, seed: int) -> list:
    """One-turn shapes in rounds of ``size``, balanced on both sizes:
    the inputs and the outputs are each cut into ``size`` strata by
    rank, and round r pairs one input of every stratum with one output
    of every stratum. Which ones, and how they pair, are drawn from
    ``seed``; the set of inputs and the set of outputs stay the mix's."""
    rng = np.random.default_rng(_seed_words(seed) + [11])

    def strata(xs):
        return [list(rng.permutation(s))
                for s in np.array_split(np.sort(np.asarray(xs)), size)]
    ins = strata([sh.inputs[0] for sh in shapes])
    outs = strata([sh.outputs[0] for sh in shapes])
    think = [sh.thinks[0] for sh in shapes]
    paired = []
    for r in range(max(len(s) for s in ins)):
        a = [int(s[r]) for s in ins if r < len(s)]
        b = [int(s[r]) for s in outs if r < len(s)]
        for x, y in zip(rng.permutation(a), rng.permutation(b)):
            paired.append(_Shape(-1, [int(x)], [int(y)],
                                 [think[len(paired)]]))
    return paired


def build_sessions(mix: dict, n_sessions: int, vocab: int, seed: int,
                   round_size: int) -> list:
    """``n_sessions`` sessions of the mix: the set of shapes fixed by the
    mix, their order (``balanced_order``, or ``balanced_pairs`` for a mix
    of one-turn sessions with no system prompt) and every token drawn
    from ``seed``."""
    shapes, sys_blocks = _shapes(mix, n_sessions)
    if mix["turns"]["max"] == 1 and not sys_blocks:
        shapes = balanced_pairs(shapes, round_size, seed)
    else:
        shapes = [shapes[i] for i in balanced_order(
            [_work(sh) for sh in shapes], round_size, seed)]
    rng = np.random.default_rng(_seed_words(seed))
    system = [rng.integers(0, vocab, b * BLOCK, dtype=np.int64)
              .astype(np.int32) for b in sys_blocks]
    context, reserve = int(mix["context"]), int(mix["output_reserve"])
    sessions, rid = [], 0
    for sid, sh in enumerate(shapes):
        s = Session(sid=sid, system_prompt=sh.system_prompt)
        prompt = (system[sh.system_prompt] if sh.system_prompt >= 0
                  else np.empty(0, np.int32))
        for n_in, n_out, think in zip(sh.inputs, sh.outputs, sh.thinks):
            new = rng.integers(0, vocab, n_in, dtype=np.int64).astype(np.int32)
            prompt = np.concatenate([prompt, new])
            if len(prompt) + reserve > context:
                break
            s.turns.append(Turn(rid=-1, session=sid, tokens=prompt,
                                max_new=n_out, think_s=think))
            out = rng.integers(0, vocab, n_out, dtype=np.int64).astype(np.int32)
            prompt = np.concatenate([prompt, out])
        sessions.append(s)
    for s in sessions:
        for t in s.turns:
            t.rid = rid
            rid += 1
    return sessions


def session_starts(rate: float, lead_s: float, horizon_s: float,
                   shape_seed: int) -> np.ndarray:
    """Poisson session starts in [-lead_s, horizon_s), fixed by the
    mix's shape seed and the rate (the same for every run seed)."""
    rng = np.random.default_rng([int(shape_seed), 1])
    span = lead_s + horizon_s
    n_max = int(rate * span * 2 + 50)
    t = np.cumsum(rng.exponential(1.0 / rate, size=n_max)) - lead_s
    return t[t < horizon_s]


def open_loop(mix: dict, load: dict, horizon_s: float, vocab: int,
              seed: int) -> list:
    """Every turn due in [0, horizon_s), in due order, with ``due`` set:
    a session's first turn at its start, each later one after the think
    time of the turn before. Sessions are dealt in rounds of
    ``load["round"]`` starts."""
    starts = session_starts(load["session_rate"], mix.get("lead_s", 0.0),
                            horizon_s, mix["shape_seed"])
    sessions = build_sessions(mix, len(starts), vocab, seed,
                              int(load["round"]))
    turns = []
    for s, t0 in zip(sessions, starts):
        due = float(t0)
        for t in s.turns:
            if due >= horizon_s:
                break
            if due >= 0.0:
                t.due = due
                turns.append(t)
            due += t.think_s
    turns.sort(key=lambda t: (t.due, t.rid))
    return turns


def closed_loop(mix: dict, load: dict, vocab: int, seed: int) -> list:
    """One list of turns per client: the client's sessions' turns in
    order, each round of ``balanced_order`` dealt one session a client."""
    n_clients = int(load["clients"])
    n = n_clients * int(load["sessions_per_client"])
    sessions = build_sessions(mix, n, vocab, seed, n_clients)
    return [[t for s in sessions[c::n_clients] for t in s.turns]
            for c in range(n_clients)]


def ideal_reuse_share(turns: list) -> float:
    """The share of prompt tokens an unbounded prefix cache would hold
    when each turn arrives, in the order given: whole 512-token blocks
    whose prefix some earlier prompt had (``PrefillWorker`` always
    computes a prompt's last block itself, as here)."""
    seen: set = set()
    hit = total = 0
    for t in turns:
        toks = t.tokens
        n_full = len(toks) // BLOCK
        keys = [hash(toks[:(i + 1) * BLOCK].tobytes()) for i in range(n_full)]
        n_hit = 0
        for k in keys:
            if k not in seen:
                break
            n_hit += 1
        if n_hit * BLOCK >= len(toks):
            n_hit = max((len(toks) - 1) // BLOCK, 0)
        hit += n_hit * BLOCK
        total += len(toks)
        seen.update(keys)
    return hit / total if total else 0.0
