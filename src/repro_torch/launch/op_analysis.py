"""Per-position op accounting of the port's steps: the counterpart of the
reference's ``repro/launch/hlo_analysis.py``.

The reference parses the compiled, partitioned HLO of a step. The port
has no HLO: its steps run eagerly, op by op, so this module counts the
ops a step dispatches, through one ``TorchDispatchMode``
(``OpAnalysis``), and tallies them per mesh position. A position is the
device an op runs on. The dry run (``launch.dryrun``) gives mesh
positions stand-in devices, ``cpu:k``, and runs the step on ``StandIn``
tensors there: a shape, a dtype and a device over a ``meta`` tensor, no
storage. So every op lands on the position that would run it on a real
mesh, and a copy between two positions (``.to(other)``) is an op the
mode sees. The port's code is the code a real mesh runs; nothing in it
knows it is being counted. The mode runs in Python for every op (about
1.3 M a production train count), so it caches an op's results and
counts by its kind, shapes and dtypes (``_META_CACHE``), takes a plain
view without walking its arguments, and counts only the positions it is
asked to (``only``).

Per position it returns:

  * ``flops``: the dot FLOPs, as ``torch.utils.flop_counter`` counts
    them (products, batched products, convolutions). Layers are eager,
    so there is no loop trip count to recover: a loop of n steps
    dispatches its ops n times;
  * ``bytes``: the HBM byte proxy. Every non-view op counts its result
    bytes; products, gathers, scatters, index ops, ``cat``/``stack``,
    ``pad``, reductions and sorts also count their operands (the
    reference's rule, ``hlo_analysis.py:186-213``). An in-place write
    (``copy_``, ``index_put_``, a slice assignment) counts the bytes it
    writes, not the whole destination. One difference: dtype casts and
    copies are counted. The reference drops them as XLA:CPU artifacts,
    but in eager PyTorch on the H100 each is a kernel that reads and
    writes memory (bf16 casts were 10.6 ms of smollm-360m's train step on
    the card, ``PERF.md`` §5);
  * ``transcendentals``: the elements of ``exp``, ``log``, ``tanh``,
    ``sigmoid``, ``rsqrt``, ``sqrt``, ``sin``/``cos``, ``erf`` and of the
    ops that hold one per element (softmax, log-softmax, logsumexp,
    SiLU, softplus, GELU);
  * ``collective_bytes`` / ``collective_counts``: the copies between
    positions, by the reference's kinds. The port's collectives are
    copies; the code that makes one names its kind with
    ``launch.shardings.collective`` (``_psum`` and the other sums of
    partials ``all-reduce``, each position's slice of such a sum
    ``reduce-scatter``, the slab copies of ``_moe_ep`` ``all-to-all``,
    a CPP stage's hand-off ``collective-permute``). A
    forward copy outside every scope (an FSDP or head gather by
    ``gather``/``take``, a row split or join, a value sent to a model
    position) is ``all-gather``, and a copy in the backward pass — a
    gradient sent back to the position that holds the shard — is
    ``reduce-scatter``. Bytes are what the receiving position takes in.
    There is no ring factor: the port's sum is a gather to one
    position (or, in the MoE global dispatch, a chunk of it to each).
    These are the port's own transfers; XLA's partitioner picks the
    reference's. ``collective_held`` is the part of each kind made under
    a held scope (``collective(kind, held=True)``): the copies whose
    counterparts in the reference have a fixed algorithm, which
    ``tests/test_torch_op_analysis.py`` holds per position against the
    reference's compiled collectives;
  * ``peak_bytes``: the most bytes live on the position at once, from
    the lifetimes of the storages it allocated (and what ``hold`` was
    given before the run).

``analyze`` returns the reference's keys (``flops``, ``bytes``,
``collective_bytes``, ``collective_counts``, ``collective_total``) for
the busiest position — the counterpart of XLA's per-device numbers —
plus ``transcendentals``, ``peak_bytes`` and ``per_position``.
``roofline_terms`` prices them on an H100 (``core.costmodel.H100``).

Host ops — on tensors of the plain ``cpu`` device, such as the small
index tables the mesh code builds and reads on the host — are not
device work: they run as they are and are not counted. A real host
tensor mixed into a stand-in position's op is taken for its shape (a
meta op reads no data).
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.costmodel import H100
from repro_torch.launch.shardings import (Sharded, collective_held,
                                          collective_kind)

aten = torch.ops.aten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# ops that also count their operands' bytes (products, gathers, scatters,
# index ops, concatenation, padding, reductions, sorts)
_READS = {getattr(aten, n) for n in (
    "mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution",
    "convolution_backward", "gather", "index_select", "index", "embedding",
    "embedding_dense_backward", "take", "scatter", "scatter_add",
    "index_put", "index_add", "index_copy", "masked_scatter", "cat",
    "stack", "constant_pad_nd", "pad", "sum", "mean", "amax", "amin",
    "max", "min", "prod", "var", "var_mean", "std", "norm",
    "linalg_vector_norm", "logsumexp", "cumsum", "argmax", "argmin",
    "sort", "topk", "_softmax", "_log_softmax", "any", "all",
    "select_backward", "slice_backward")}
# in-place writes that count what they write, not the whole destination
_WRITES = {getattr(aten, n) for n in (
    "copy_", "index_put_", "_index_put_impl_", "index_copy_",
    "index_add_", "scatter_", "scatter_add_", "masked_scatter_")}
_TRANSCENDENTAL = {getattr(aten, n) for n in (
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "erfinv",
    "_softmax", "_log_softmax", "silu", "silu_backward", "softplus",
    "gelu", "logsumexp")}
# ops that count their input's elements (a reduction's output is small)
_TRANSCENDENTAL_IN = {aten.logsumexp}
_COPIES = {aten._to_copy, aten.copy_}
# ops whose result aliases their input without being marked a view
_ALIASES = {aten._unsafe_view, aten.lift_fresh}


class _Op:
    """What the accounting needs to know of one op overload, worked out
    once."""

    __slots__ = ("func", "packet", "view", "mutates", "flop", "reads",
                 "writes", "trans", "trans_in", "copy", "name", "lean_view")

    def __init__(self, func) -> None:
        self.func = func        # kept alive: ``_OPS`` is keyed by its id
        if torch.Tag.inplace_view in func.tags:
            raise NotImplementedError(f"{func}: an in-place view")
        p = self.packet = func._overloadpacket
        self.view = func.is_view or p in _ALIASES
        args = func._schema.arguments
        self.mutates = bool(args) and args[0].alias_info is not None \
            and args[0].alias_info.is_write
        self.flop = flop_registry.get(p)
        self.reads, self.writes = p in _READS, p in _WRITES
        self.trans, self.trans_in = p in _TRANSCENDENTAL, \
            p in _TRANSCENDENTAL_IN
        self.copy = p in _COPIES
        self.name = str(p).replace("aten.", "")
        # a view that counts nothing but itself (``OpAnalysis._view``)
        self.lean_view = self.view and self.flop is None and \
            not (self.trans or self.copy or self.mutates)


# id(op overload) → _Op (an overload hashes in Python; its id does not)
_OPS: dict = {}


def _op(func) -> _Op:
    op = _OPS.get(id(func))
    if op is None:
        op = _OPS[id(func)] = _Op(func)
    return op


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _standin(dev) -> bool:
    """A stand-in position: a ``cpu:k`` device (the plain ``cpu`` is the
    host)."""
    got = _STANDIN.get(dev)
    if got is None:
        got = _STANDIN[dev] = dev is not None and dev.type == "cpu" \
            and dev.index is not None
    return got


_STANDIN: dict = {}


class Tally:
    """One position's counts."""

    __slots__ = ("flops", "bytes", "transcendentals", "coll", "counts",
                 "coll_held", "live", "peak", "held", "ops")

    def __init__(self) -> None:
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.coll = dict.fromkeys(COLLECTIVES, 0)
        self.counts = dict.fromkeys(COLLECTIVES, 0)
        self.coll_held = dict.fromkeys(COLLECTIVES, 0)
        self.live = 0
        self.peak = 0
        self.held = 0       # bytes given to ``hold``
        self.ops: Counter | None = None

    def record(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "transcendentals": self.transcendentals,
                "collective_bytes": dict(self.coll),
                "collective_counts": dict(self.counts),
                "collective_held": dict(self.coll_held),
                "collective_total": sum(self.coll.values()),
                "peak_bytes": self.peak}


class StandIn(torch.Tensor):
    """A tensor on a stand-in position: its shape, strides, dtype and a
    device ``cpu:k``, over a ``meta`` tensor that holds no storage.
    Every op on it runs on the meta tensors and returns stand-ins on the
    op's position (``_run_meta``): a copy ``.to(other)`` lands on
    ``other``. Views share their base's meta storage, so a storage's
    lifetime is the memory it would hold."""

    @staticmethod
    def __new__(cls, meta: torch.Tensor, device):
        t = _wrap(cls, meta.shape, strides=meta.stride(),
                  storage_offset=meta.storage_offset(), dtype=meta.dtype,
                  device=device, requires_grad=False)
        t._standin_meta = meta
        return t

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = _op(func)
        return _run_meta(func, op, args, kwargs, _device_of(
            op, args, kwargs, _tensors(args, kwargs)))[0]

    def __repr__(self) -> str:
        return (f"StandIn({tuple(self.shape)}, {self.dtype}, "
                f"{self.device})")


_wrap = torch.Tensor._make_wrapper_subclass
_META = torch.device("meta")


def _fresh(sig, dev) -> StandIn:
    """A stand-in over a new meta tensor of ``sig`` (size, stride, dtype):
    ``StandIn(torch.empty_strided(...), dev)``, without reading the
    metadata back."""
    size, stride, dtype = sig
    t = _wrap(StandIn, size, strides=stride, dtype=dtype, device=dev,
              requires_grad=False)
    t._standin_meta = torch.empty_strided(size, stride, dtype=dtype,
                                          device=_META)
    t._standin_sig = sig
    return t


def _sig_of(t: StandIn) -> tuple:
    """A stand-in's (size, stride, dtype), kept on it once read."""
    sig = getattr(t, "_standin_sig", None)
    if sig is None:
        sig = t._standin_sig = _meta_of(t._standin_meta)
    return sig


def standin(shape, dtype, device) -> StandIn:
    """An empty stand-in tensor of ``shape`` and ``dtype`` on ``device``."""
    return StandIn(torch.empty(shape, dtype=dtype, device="meta"),
                   torch.device(device))


def _device_of(op: _Op, args, kwargs, tensors):
    """The position an op runs on: a copy's destination, else its first
    (non-scalar) tensor argument's device, else its ``device``
    argument."""
    kw = kwargs.get("device")
    kw = torch.device(kw) if kw is not None else None
    if op.packet is aten._to_copy and kw is not None:
        return kw
    stand = [t for t in tensors if type(t) is StandIn]
    pick = stand or tensors
    if pick:
        return next((t.device for t in pick if t.dim()), pick[0].device)
    return kw


def _run_meta(func, op: _Op, args, kwargs, dev):
    """(results, cache entry) of ``func`` on the meta tensors behind its
    stand-in arguments (a real host tensor taken for its shape), the
    results stand-ins on ``dev``. An in-place op changes no metadata (a
    meta tensor has no data): it returns its first argument as it is. A
    non-view op's results are built from the shapes, strides and dtypes
    it gave the last time it met arguments of the same kinds (the meta
    kernels run in Python); its entry — [one tensor?, [(size, stride,
    dtype)], container, its (FLOPs, bytes, transcendentals) once worked
    out] — is None for a view or an in-place op."""
    if op.mutates:
        return args[0], None
    margs = [_unwrap(a) if not isinstance(a, (list, tuple))
             else type(a)(_unwrap(x) for x in a) for a in args]
    mkwargs = {k: _unwrap(v) for k, v in kwargs.items()} if kwargs else {}
    if "device" in mkwargs:
        mkwargs["device"] = _META
    key = None
    if not op.view:
        key = (op, tuple([_sig(a) for a in margs]),
               tuple([(k, _sig(v)) for k, v in mkwargs.items()])
               if mkwargs else ())
        hit = _META_CACHE.get(key)
        if hit is not None:
            return _outputs(hit, dev), hit
    out = func(*margs, **mkwargs)
    if len(_META_CACHE) > _META_CACHE_MAX:
        _META_CACHE.clear()
    if isinstance(out, torch.Tensor):
        entry = None
        if key is not None:
            entry = _META_CACHE[key] = [True, [_meta_of(out)], None, None]
        return StandIn(out, dev), entry
    if isinstance(out, (list, tuple)):
        entry = None
        if key is not None and all(isinstance(x, torch.Tensor) for x in out):
            entry = _META_CACHE[key] = [False, [_meta_of(x) for x in out],
                                        type(out)(), None]
        return type(out)(StandIn(x, dev) if isinstance(x, torch.Tensor)
                         else x for x in out), entry
    return out, None


def _outputs(entry, dev):
    """Fresh stand-ins on ``dev`` from a cache entry."""
    if entry[0]:
        return _fresh(entry[1][0], dev)
    return type(entry[2])(_fresh(sig, dev) for sig in entry[1])


def _scan(op: _Op, args, kwargs):
    """One pass over a call's arguments for the cached path: (its tensors,
    its position, its ``_META_CACHE`` key) — or None where the call takes
    the general path (an in-place op, a view, a real host tensor among
    the arguments, no stand-in argument). The key and the position are
    ``_run_meta``'s and ``_device_of``'s."""
    if op.mutates or op.view:
        return None
    tensors, sigs, dev = [], [], None
    for a in args:
        ta = type(a)
        if ta is StandIn:
            tensors.append(a)
            sig = _sig_of(a)
            sigs.append(sig)
            if dev is None and sig[0]:
                dev = a
        elif ta is list or ta is tuple:
            sub = []
            for x in a:
                if type(x) is StandIn:
                    tensors.append(x)
                    sig = _sig_of(x)
                    sub.append(sig)
                    if dev is None and sig[0]:
                        dev = x
                elif isinstance(x, torch.Tensor):
                    return None
                else:
                    sub.append(_sig(x))
            sigs.append(tuple(sub))
        elif isinstance(a, torch.Tensor):
            return None
        else:
            sigs.append(a)
    kw = ()
    if kwargs:
        items = []
        for k, v in kwargs.items():
            if k == "device":
                v = _META
            elif isinstance(v, (torch.Tensor, list, tuple)):
                return None
            items.append((k, v))
        kw = tuple(items)
        want = kwargs.get("device")
        if want is not None and op.packet is aten._to_copy:
            dev = torch.device(want)
    if not tensors:
        return None
    if dev is None:
        dev = tensors[0].device
    elif type(dev) is StandIn:
        dev = dev.device
    return tensors, dev, (op, tuple(sigs), kw)


def _no_tensor(args) -> bool:
    """No tensor among a call's arguments past the first (one level of
    lists)."""
    for a in args[1:]:
        if isinstance(a, torch.Tensor):
            return False
        if isinstance(a, (list, tuple)):
            for x in a:
                if isinstance(x, torch.Tensor):
                    return False
    return True


def _unwrap(x):
    if type(x) is StandIn:
        return x._standin_meta
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    return x


# (op, argument kinds) → [one tensor?, [(size, stride, dtype)], container,
# counts]
_META_CACHE: dict = {}
_META_CACHE_MAX = 200_000


def _meta_of(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype


def _sig(x):
    """A hashable stand-in for an argument: a tensor's shape, strides and
    dtype, a list's items, anything else as it is."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    return x


class OpAnalysis(TorchDispatchMode):
    """Counts every op dispatched inside it, per position (see the module
    docstring). An op with a stand-in position (``cpu:k``: a
    ``StandIn`` argument, a factory such as ``torch.arange(n,
    device=dev)``, a host table copied there) runs on meta tensors and
    returns stand-ins; a host op runs as it is, uncounted. ``ops``: keep
    each position's tally of op names (count, FLOPs, bytes). ``only``:
    the positions to count (all when None); an op elsewhere still runs on
    meta tensors and returns stand-ins, uncounted."""

    def __init__(self, *, ops: bool = False, only=None) -> None:
        super().__init__()
        self.keep_ops = ops
        self.only = None if only is None else frozenset(only)
        self.tallies: dict = {}
        self._live: dict = {}     # counted storages: key → weak reference

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing inside is compiled: no dynamo-disabling frame around
        # every op
        return False

    # -- positions ---------------------------------------------------------

    def tally(self, dev) -> Tally:
        t = self.tallies.get(dev)
        if t is None:
            t = self.tallies[dev] = Tally()
            if self.keep_ops:
                t.ops = Counter()
        return t

    def hold(self, tree) -> None:
        """Count the tensors of ``tree`` (the step's arguments) as live on
        their positions from now on, each storage once, until it dies;
        their bytes are each position's ``held``."""
        self.take(tree, held=True)

    def take(self, tree, held: bool = False) -> None:
        """Count the tensors of ``tree`` as allocated on their positions
        now (live until they die)."""
        for t in pytree.tree_leaves(tree, is_leaf=_is_sharded):
            for x in (t.shards.values() if isinstance(t, Sharded) else (t,)):
                if isinstance(x, torch.Tensor) and _standin(x.device) and \
                        (self.only is None or x.device in self.only):
                    self._alloc(x, held)

    def _alloc(self, t: torch.Tensor, held: bool = False,
               tl: Tally | None = None) -> None:
        """A storage counted live on t's position (its tally ``tl``) once,
        until it dies."""
        st = _storage(t)
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        if tl is None:
            tl = self.tally(t.device)
        if held:
            tl.held += n
        tl.live += n
        if tl.live > tl.peak:
            tl.peak = tl.live
        self._live[key] = weakref.ref(st, lambda _, tl=tl, n=n, key=key:
                                      self._free(tl, n, key))

    def _free(self, tl: Tally, n: int, key) -> None:
        tl.live -= n
        self._live.pop(key, None)

    # -- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = _OPS.get(id(func)) or _op(func)
        if op.lean_view and not kwargs and type(args[0]) is StandIn \
                and _no_tensor(args):
            return self._view(func, op, args)
        kwargs = kwargs or {}
        got = _scan(op, args, kwargs)
        entry = None
        if got is not None:
            tensors, dev, key = got
            entry = _META_CACHE.get(key)
        if entry is not None and _standin(dev):
            out = _outputs(entry, dev)
        else:
            tensors = _tensors(args, kwargs)
            dev = _device_of(op, args, kwargs, tensors)
            if not _standin(dev):
                return func(*args, **kwargs)
            out, entry = _run_meta(func, op, args, kwargs, dev)
        if self.only is None or dev in self.only:
            self._account(op, args, kwargs, tensors, out, dev, entry)
        return out

    def _view(self, func, op: _Op, args):
        """A view of one stand-in (its first argument, every other one no
        tensor): the general path's result and counts — the view on the
        stand-in's position, over the view of its meta tensor, counting
        only itself in the op tally — without its argument walks."""
        a = args[0]
        dev = a.device
        if not _standin(dev):
            return func(*args)
        out = func(a._standin_meta, *args[1:])
        out = StandIn(out, dev) if isinstance(out, torch.Tensor) else \
            type(out)(StandIn(x, dev) if isinstance(x, torch.Tensor) else x
                      for x in out)
        if self.only is None or dev in self.only:
            tl = self.tallies.get(dev) or self.tally(dev)
            if tl.ops is not None:
                tl.ops[(op.name, "n")] += 1
                tl.ops[(op.name, "flops")] += 0
                tl.ops[(op.name, "bytes")] += 0
        return out

    def _account(self, op: _Op, args, kwargs, tensors, out, dev,
                 entry=None) -> None:
        outs = [out] if isinstance(out, torch.Tensor) else \
            _tensors(out, {}) if isinstance(out, (list, tuple)) else []
        tl = self.tallies.get(dev) or self.tally(dev)
        counts = entry[3] if entry is not None else None
        if counts is None:
            counts = _counts(op, args, kwargs, tensors, out, outs)
            if entry is not None:       # the same for every such call
                entry[3] = counts
        flops, nbytes, trans = counts
        tl.flops += flops
        tl.bytes += nbytes
        tl.transcendentals += trans
        if op.copy:
            src = args[1] if op.packet is aten.copy_ else args[0]
            if isinstance(src, torch.Tensor) and src.device != dev \
                    and _standin(src.device):
                kind = _kind()
                n = _nbytes(outs[0]) if op.packet is aten._to_copy \
                    else _nbytes(src)
                tl.coll[kind] += n
                tl.counts[kind] += 1
                if kind != "reduce-scatter" and collective_held():
                    tl.coll_held[kind] += n
        if tl.ops is not None:
            tl.ops[(op.name, "n")] += 1
            tl.ops[(op.name, "flops")] += flops
            tl.ops[(op.name, "bytes")] += nbytes
        if not (op.view or op.writes or op.mutates):
            for t in outs:
                self._alloc(t, tl=tl)

    # -- results -----------------------------------------------------------

    def records(self, label=str) -> dict:
        """{label(device): that position's record} (``Tally.record``)."""
        return {label(d): t.record() for d, t in self.tallies.items()}

    def op_tallies(self, label=str) -> dict:
        """{label(device): {op: {n, flops, bytes}}} (``ops=True``)."""
        out = {}
        for d, t in self.tallies.items():
            rows: dict = {}
            for (name, what), v in sorted((t.ops or {}).items()):
                rows.setdefault(name, {})[what] = v
            out[label(d)] = rows
        return out


def _counts(op: _Op, args, kwargs, tensors, out, outs) -> tuple:
    """(FLOPs, bytes, transcendentals) of one op: they depend only on its
    arguments' shapes and dtypes."""
    flops = 0
    if op.flop is not None:
        flops = int(op.flop(*args, **kwargs, out_val=out))
    nbytes = 0
    if not op.view:
        if op.writes:
            nbytes = sum(_nbytes(t) for t in tensors[1:])
        else:
            nbytes = sum(_nbytes(t) for t in outs)
            if op.reads:
                nbytes += sum(_nbytes(t) for t in tensors)
    trans = 0
    if op.trans:
        trans = (args[0] if op.trans_in else outs[0]).numel()
    return flops, nbytes, trans


def _tensors(args, kwargs) -> list:
    """The tensors among a call's arguments (one level of lists)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def _storage(t: torch.Tensor):
    """The storage behind a tensor (a stand-in's meta storage)."""
    if type(t) is StandIn:
        return t._standin_meta.untyped_storage()
    return t.untyped_storage()


def _kind() -> str:
    """The collective kind of the copy being made: a copy made by the
    autograd engine is a backward copy; a forward copy takes the kind of
    the ``collective`` scope it is made in, a gather outside any."""
    if torch._C._current_autograd_node() is not None:
        return "reduce-scatter"
    return collective_kind() or "all-gather"


def summarize(records: dict) -> dict:
    """The reference's ``analyze`` keys for the busiest position (the
    most FLOPs, then bytes, then collective bytes) with ``per_position``
    holding every position's record."""
    if not records:
        rec = Tally().record()
    else:
        rec = max(records.values(), key=lambda r: (
            r["flops"], r["bytes"], r["collective_total"]))
    out = {k: rec[k] for k in ("flops", "bytes", "collective_bytes",
                               "collective_counts", "collective_total",
                               "transcendentals", "peak_bytes")}
    out["per_position"] = records
    return out


def analyze(fn, *args, label=str, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under ``OpAnalysis`` and return the
    counts (``summarize``); ``per_position`` is keyed by
    ``label(device)``."""
    mode = OpAnalysis()
    mode.hold((args, kwargs))
    with mode:
        fn(*args, **kwargs)
    return summarize(mode.records(label))


def roofline_terms(analysis: dict, *, peak_flops: float = H100.peak_flops,
                   hbm_bw: float = H100.hbm_bw,
                   link_bw: float = H100.ici_bw, links: int = 1) -> dict:
    """Three roofline terms in SECONDS for the busiest position, on an
    H100: bf16 dense peak, HBM3 bandwidth, and NVLink's 450e9 bytes/s a
    direction over one link term (``core.costmodel.H100``). A model axis
    of 16 spans two 8-GPU nodes, whose link is slower than NVLink, so on
    the production meshes the collective term is a lower bound."""
    t_compute = analysis["flops"] / peak_flops
    t_memory = analysis["bytes"] / hbm_bw
    t_coll = analysis["collective_total"] / (link_bw * links)
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": dom[1],
        "t_bound_s": dom[0],
    }
