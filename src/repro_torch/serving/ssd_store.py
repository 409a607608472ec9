"""File-backed SSD KVCache tier with async layer-wise prefetch (§5.2) —
the port's own copy of the reference's ``serving/ssd_store.py``, over
host (CPU) tensors instead of numpy arrays.

``SSDBlockStore`` is the byte store behind ``HostKVPool``'s SSD tier: one
data file of fixed-size slots, one 512-token block per slot, laid out
layer-major so a block can be read back layer by layer — the on-disk
mirror of the §5.2 load stream. Demotions are *staged* in memory and
written as one sequential batch every ``writeback_batch`` blocks; a crash
before the flush loses only staged blocks, which fall back to recompute.

The byte format is the reference's, so a store written by either package
is read by the other: slots of ``<4sQI`` (magic ``MKV1``, block key,
layer count) + one CRC32 per layer + the payload ``k[0] v[0] k[1] v[1]
…``, and a ``meta.json`` with ``shape``, ``dtype`` and ``slot_size``. A
bf16 block is written as its 16-bit patterns and named ``"bfloat16"``,
the name numpy gives the reference's bf16 arrays; the name maps back to
``torch.bfloat16`` here without ``ml_dtypes``.

Every read is truncation- and corruption-safe: a torn write, a truncated
file or flipped payload bits make ``read_block`` / ``read_layer`` return
``None`` — never wrong KV bytes. Every tensor a read returns owns its
memory (nothing aliases the file mapping or a staged block).

``AsyncPrefetcher`` is the §5.2 "launch the next layer's load" queue: a
daemon thread that services (block, layer) reads in layer-major order —
layer l of every requested block lands before layer l+1 — while the
prefill worker recomputes the head chunks of the prefix on the card.
``PrefetchHandle.wait()`` is the paper's wait-before-attend barrier. The
thread touches host memory only; the loaded tail crosses to the card on
the prefill worker's thread. ``read_bw`` throttles reads to a target
bandwidth (so the load-vs-compute split stays meaningful on hosts whose
page cache would otherwise hide the tier).
"""
from __future__ import annotations

import json
import mmap
import os
import queue
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Optional

import torch

_MAGIC = b"MKV1"
_HDR_FIXED = struct.Struct("<4sQI")     # magic, block key, n_layers


def dtype_name(dtype: torch.dtype) -> str:
    """The name ``meta.json`` records: numpy's name for the same dtype
    (``torch.bfloat16`` → ``"bfloat16"``, ``torch.float32`` → ``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def dtype_from_name(name: str) -> torch.dtype:
    """Inverse of ``dtype_name``; ValueError for a name torch lacks."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in meta.json")
    return dt


def _as_bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of a host tensor (any dtype, bf16 as its 16-bit
    patterns), row-major."""
    return t.detach().contiguous().view(torch.uint8).numpy().tobytes()


class SSDBlockStore:
    """Slotted, checksummed, file-backed KV block store.

    One block = the per-layer (k, v) tensors of 512 tokens, shape
    ``(L, T, KV, Dh)`` each. The slot payload is layer-major:
    ``k[0] v[0] k[1] v[1] ...`` so ``read_layer`` is one contiguous read.
    Shape and dtype come from the first ``put`` and persist to
    ``meta.json`` next to the data file.
    """

    def __init__(self, directory: str, *, writeback_batch: int = 8,
                 read_bw: Optional[float] = None,
                 write_bw: Optional[float] = None,
                 fsync: bool = False) -> None:
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.path = os.path.join(directory, "kvblocks.dat")
        self.writeback_batch = max(int(writeback_batch), 1)
        self.read_bw = read_bw
        self.write_bw = write_bw
        self.fsync = fsync
        self._fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
        self._lock = threading.RLock()
        self._mm: Optional[mmap.mmap] = None
        self._mm_size = 0
        #: guarded_by self._lock
        self._offsets: dict[int, int] = {}      # key -> slot offset (on disk)
        #: guarded_by self._lock
        self._free: list[int] = []              # reusable slot offsets
        #: guarded_by self._lock
        self._staged: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._shape: Optional[tuple] = None     # per-tensor (L, T, KV, Dh)
        self._dtype: Optional[torch.dtype] = None
        # stats
        self.blocks_written = 0
        self.blocks_read = 0
        self.layer_reads = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self.n_flushes = 0                      # batched write operations
        self.flush_s = 0.0                      # seconds spent in flushes
        self.read_failures = 0                  # checksum / truncation
        self._read_s_ema: Optional[float] = None  # seconds per block read
        self._recover()

    def _recover(self) -> None:
        """Reopen an existing store: restore geometry from ``meta.json``
        and re-index flushed slots by scanning their headers, so a crash
        loses only the STAGED blocks (payload validity is still checked
        per read by the layer CRCs). Slots with torn headers become free
        slots; an unreadable or absent meta.json means a fresh store."""
        meta_path = os.path.join(self.dir, "meta.json")
        size = os.fstat(self._fd).st_size
        if size == 0 or not os.path.exists(meta_path):
            return
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            shape = tuple(int(d) for d in meta["shape"])
            dtype = dtype_from_name(meta["dtype"])
        except (ValueError, KeyError, TypeError):
            return                              # torn meta: treat as fresh
        self._set_geometry(shape, dtype)
        with self._lock:
            for off in range(0, size - self._slot_size + 1, self._slot_size):
                raw = self._read_at(off, self._hdr_size)
                if raw is None:
                    break
                magic, key, L = _HDR_FIXED.unpack_from(raw)
                if magic == _MAGIC and L == shape[0] \
                        and key not in self._offsets:
                    self._offsets[key] = off
                else:
                    self._free.append(off)

    # ---- geometry ------------------------------------------------------
    def _set_geometry(self, shape: tuple, dtype: torch.dtype) -> None:
        self._shape = tuple(shape)
        self._dtype = dtype
        itemsize = torch.empty((), dtype=dtype).element_size()
        n = 1
        for d in self._shape[1:]:
            n *= d
        self._layer_bytes = n * itemsize
        L = self._shape[0]
        self._hdr_size = _HDR_FIXED.size + 4 * L    # + one CRC32 per layer
        self._slot_size = self._hdr_size + 2 * L * self._layer_bytes
        with open(os.path.join(self.dir, "meta.json"), "w") as f:
            json.dump(dict(shape=list(self._shape), dtype=dtype_name(dtype),
                           slot_size=self._slot_size), f)

    @property
    def n_layers(self) -> int:
        return self._shape[0] if self._shape else 0

    @property
    def block_bytes(self) -> int:
        """Payload bytes of one block (k + v, all layers)."""
        return 2 * self.n_layers * self._layer_bytes if self._shape else 0

    @property
    def read_s_ema(self) -> Optional[float]:
        """Measured seconds-per-block read EMA (None until the first
        blocking read)."""
        return self._read_s_ema

    def est_block_read_s(self, default_bw: float = 500e6) -> float:
        """Expected seconds to read one block: measured EMA when we have
        one, else the throttle bandwidth, else a SATA-class default."""
        if self._read_s_ema is not None:
            return self._read_s_ema
        if not self._shape:
            return 0.0
        bw = self.read_bw if self.read_bw else default_bw
        return self.block_bytes / bw

    # ---- residency -----------------------------------------------------
    def __contains__(self, key: int) -> bool:
        with self._lock:
            return key in self._offsets or key in self._staged

    def __len__(self) -> int:
        with self._lock:
            return len(self._offsets) + len(self._staged)

    @property
    def staged_blocks(self) -> int:
        with self._lock:
            return len(self._staged)

    def keys(self) -> list[int]:
        """Keys with flushed on-disk slots (staged blocks excluded)."""
        with self._lock:
            return list(self._offsets)

    # ---- write path ----------------------------------------------------
    def put(self, key: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Stage one block (host tensors) for write-back; flushes a full
        batch inline. The store keeps its own copies, so the caller may
        mutate ``k``/``v`` afterwards."""
        k = k.detach().to("cpu", copy=True).contiguous()
        v = v.detach().to("cpu", copy=True).contiguous()
        with self._lock:
            if self._shape is None:
                self._set_geometry(tuple(k.shape), k.dtype)
            elif tuple(k.shape) != self._shape or k.dtype != self._dtype \
                    or tuple(v.shape) != self._shape or v.dtype != self._dtype:
                raise ValueError(
                    f"block {key}: {tuple(k.shape)} {k.dtype} does not match "
                    f"the store's {self._shape} {self._dtype}")
            self._staged[key] = (k, v)
            if len(self._staged) >= self.writeback_batch:
                self._flush_locked()

    def flush(self) -> int:
        """Force the partial write-back batch out; returns blocks written."""
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        if not self._staged:
            return 0
        t0 = time.monotonic()
        staged, self._staged = self._staged, {}
        total = 0
        for key, (k, v) in staged.items():
            off = self._alloc_slot_locked()
            buf = self._encode(key, k, v)
            os.pwrite(self._fd, buf, off)
            self._offsets[key] = off
            self.blocks_written += 1
            total += len(buf)
        self.bytes_written += total
        self.n_flushes += 1
        if self.fsync:
            os.fsync(self._fd)
        if self.write_bw:
            time.sleep(total / self.write_bw)
        self.flush_s += time.monotonic() - t0
        return len(staged)

    def _alloc_slot_locked(self) -> int:
        """Next slot offset for a flush. Caller holds ``self._lock``."""
        if self._free:
            return self._free.pop()
        end = (max(self._offsets.values()) + self._slot_size
               if self._offsets else 0)
        return end

    def _encode(self, key: int, k: torch.Tensor, v: torch.Tensor) -> bytes:
        L = self._shape[0]
        parts, crcs = [], []
        for l in range(L):
            kb = _as_bytes(k[l])
            vb = _as_bytes(v[l])
            crcs.append(zlib.crc32(kb + vb) & 0xFFFFFFFF)
            parts.append(kb)
            parts.append(vb)
        hdr = _HDR_FIXED.pack(_MAGIC, key & (2**64 - 1), L) \
            + struct.pack(f"<{L}I", *crcs)
        return hdr + b"".join(parts)

    def delete(self, key: int) -> None:
        with self._lock:
            if self._staged.pop(key, None) is not None:
                return
            off = self._offsets.pop(key, None)
            if off is not None:
                self._free.append(off)

    # ---- read path -----------------------------------------------------
    def _read_at(self, off: int, n: int) -> Optional[bytearray]:
        """Owned copy of ``n`` bytes at ``off`` through the mmap (remapped
        as the file grows); a request past EOF is a truncated slot →
        None. Caller holds ``self._lock``."""
        end = off + n
        if end > self._mm_size:
            size = os.fstat(self._fd).st_size
            if end > size:
                return None
            if self._mm is not None:
                self._mm.close()
            self._mm = mmap.mmap(self._fd, size, prot=mmap.PROT_READ)
            self._mm_size = size
        with memoryview(self._mm) as mv:
            return bytearray(mv[off:end])

    def _slot_header_locked(self, key: int) \
            -> Optional[tuple[int, list[int]]]:
        """Validated (slot offset, per-layer CRCs) of an on-disk block.
        Caller holds ``self._lock``."""
        off = self._offsets.get(key)
        if off is None:
            return None
        raw = self._read_at(off, self._hdr_size)
        if raw is None:
            return None
        magic, hkey, L = _HDR_FIXED.unpack_from(raw)
        if magic != _MAGIC or hkey != key & (2**64 - 1) \
                or L != self._shape[0]:
            return None
        crcs = list(struct.unpack_from(f"<{L}I", raw, _HDR_FIXED.size))
        return off, crcs

    def _decode_layer(self, raw: bytearray) \
            -> tuple[torch.Tensor, torch.Tensor]:
        """One layer's verified bytes → (k, v) tensors that own ``raw``."""
        flat = torch.frombuffer(raw, dtype=torch.uint8).view(self._dtype)
        half = flat.numel() // 2
        shape = self._shape[1:]
        return flat[:half].view(shape), flat[half:].view(shape)

    def read_layer(self, key: int, layer: int) \
            -> Optional[tuple[torch.Tensor, torch.Tensor]]:
        """One layer's (k, v) of one block — the §5.2 load-stream unit.
        ``None`` on any integrity failure (missing, truncated, corrupt)."""
        t0 = time.monotonic()
        with self._lock:
            st = self._staged.get(key)
            if st is not None:
                k, v = st
                return k[layer].clone(), v[layer].clone()
            hdr = self._slot_header_locked(key)
            if hdr is None:
                if key in self._offsets:
                    self.read_failures += 1
                return None
            off, crcs = hdr
            pair = 2 * self._layer_bytes
            raw = self._read_at(off + self._hdr_size + layer * pair, pair)
            if raw is None or (zlib.crc32(raw) & 0xFFFFFFFF) != crcs[layer]:
                self.read_failures += 1
                return None
            self.layer_reads += 1
            self.bytes_read += pair
        self._throttle(pair, t0)
        return self._decode_layer(raw)

    def read_block(self, key: int) \
            -> Optional[tuple[torch.Tensor, torch.Tensor]]:
        """Whole-block (k, v), layer-verified; ``None`` on any failure."""
        L = self.n_layers
        if L == 0 or key not in self:
            return None
        t0 = time.monotonic()
        ks, vs = [], []
        for l in range(L):
            pair = self.read_layer(key, l)
            if pair is None:
                return None
            ks.append(pair[0])
            vs.append(pair[1])
        self.blocks_read += 1
        # feed the split-search EMA from BLOCKING reads only: here the wall
        # time is genuinely the store's cost. Prefetch-thread layer reads
        # deliberately don't count — their elapsed time includes the GIL /
        # scheduling gaps of the compute they overlap, which would inflate
        # the estimate and push the split toward pure recompute.
        self.note_measured_read(time.monotonic() - t0)
        return torch.stack(ks), torch.stack(vs)

    def _throttle(self, nbytes: int, t0: float) -> None:
        if self.read_bw:
            remain = nbytes / self.read_bw - (time.monotonic() - t0)
            if remain > 0:
                time.sleep(remain)

    def note_measured_read(self, seconds_per_block: float) -> None:
        """Fold one measured block-read time into the split-search EMA."""
        self._read_s_ema = seconds_per_block if self._read_s_ema is None \
            else 0.7 * self._read_s_ema + 0.3 * seconds_per_block

    # ---- reporting / lifecycle ----------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return dict(blocks=len(self._offsets), staged=len(self._staged),
                        blocks_written=self.blocks_written,
                        blocks_read=self.blocks_read,
                        layer_reads=self.layer_reads,
                        bytes_written=self.bytes_written,
                        bytes_read=self.bytes_read,
                        n_flushes=self.n_flushes, flush_s=self.flush_s,
                        read_failures=self.read_failures,
                        file_bytes=os.fstat(self._fd).st_size)

    def close(self) -> None:
        with self._lock:
            if self._fd < 0:
                return
            self._flush_locked()
            if self._mm is not None:
                self._mm.close()
                self._mm = None
            os.close(self._fd)
            self._fd = -1

    def __del__(self):  # best-effort; explicit close() preferred
        try:
            if getattr(self, "_fd", -1) >= 0:
                os.close(self._fd)
                self._fd = -1
        except OSError:
            pass


# ---------------------------------------------------------------------------
# async layer-wise prefetch
# ---------------------------------------------------------------------------


@dataclass
class PrefetchHandle:
    """In-flight layer-wise loads of one block set.

    ``result(key)`` is the assembled (k, v) for a fully verified block,
    ``None`` while loading or after any layer of it failed; ``failed``
    lists blocks that hit a checksum/truncation error. ``layer_log``
    records (key, layer, t_done) in completion order — the §5.2 timeline.
    """
    keys: list[int]
    _bufs: dict = field(default_factory=dict)      # key -> (k, v) buffers
    _layers_done: dict = field(default_factory=dict)
    failed: set = field(default_factory=set)
    layer_log: list = field(default_factory=list)
    sources: dict = field(default_factory=dict)    # key -> peer source
    _t0: float = field(default_factory=time.monotonic)
    _remaining: int = 0
    _done: threading.Event = field(default_factory=threading.Event)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def _deliver(self, key: int, layer: int, pair, n_layers: int) -> None:
        with self._lock:
            if pair is None:
                self.failed.add(key)
                self._bufs.pop(key, None)
            elif key not in self.failed:
                if key not in self._bufs:
                    k0 = pair[0]
                    shape = (n_layers,) + tuple(k0.shape)
                    self._bufs[key] = (torch.empty(shape, dtype=k0.dtype),
                                       torch.empty(shape, dtype=k0.dtype))
                self._bufs[key][0][layer] = pair[0]
                self._bufs[key][1][layer] = pair[1]
                self._layers_done[key] = self._layers_done.get(key, 0) + 1
            self.layer_log.append((key, layer,
                                   time.monotonic() - self._t0))
            self._remaining -= 1
            if self._remaining <= 0:
                self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """§5.2 wait-before-attend barrier for the whole fetch."""
        return self._done.wait(timeout)

    def result(self, key: int):
        """(k, v) for a complete, verified block; else None."""
        with self._lock:
            if key in self.failed:
                return None
            bufs = self._bufs.get(key)
            if bufs is None:
                return None
            n = self._layers_done.get(key, 0)
            return bufs if n == bufs[0].shape[0] else None


class AsyncPrefetcher:
    """Daemon thread servicing layer-major block loads off the store.

    ``fetch(keys)`` enqueues layer 0 of every block, then layer 1, … so
    arrival order matches the §5.2 load stream; the caller overlaps its
    head-chunk recompute and joins on ``PrefetchHandle.wait()``.

    ``sources`` maps a key to an alternative read source — any object
    with ``n_layers`` and ``read_layer(key, layer)`` — which is how a
    peer node's blocks stream through the SAME layer-major queue as local
    ones. Keys whose source reports zero layers fail immediately rather
    than hanging the handle.
    """

    def __init__(self, store: SSDBlockStore) -> None:
        self.store = store
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()   # serialises fetch() vs close()
        self._closed = False            #: guarded_by self._lock
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-torch-kv-prefetch")
        self._thread.start()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def fetch(self, keys: list[int],
              sources: Optional[dict] = None) -> PrefetchHandle:
        h = PrefetchHandle(keys=list(keys), sources=dict(sources or {}))
        tasks = []
        for key in keys:
            src = h.sources.get(key, self.store)
            L = src.n_layers
            if L == 0:
                h.failed.add(key)
                continue
            tasks.append((key, src, L))
        with self._lock:
            # a fetch against a closed prefetcher must FAIL the handle
            # immediately: its thread is (being) joined, so enqueued tasks
            # would never be serviced and wait() would hang forever
            if self._closed or not tasks:
                h.failed.update(k for k, _, _ in tasks)
                h._done.set()
                return h
            h._remaining = sum(L for _, _, L in tasks)
            for layer in range(max(L for _, _, L in tasks)):
                for key, src, L in tasks:
                    if layer < L:
                        self._q.put((h, key, layer, L, src))
        return h

    def _run(self) -> None:
        while True:
            task = self._q.get()
            if task is None:
                return
            h, key, layer, L, src = task
            # after close() the remaining queue drains as failures without
            # touching the store (it is about to be closed underneath us);
            # every in-flight handle still completes, degrading to recompute
            with self._lock:
                closed = self._closed
            if closed or key in h.failed:
                h._deliver(key, layer, None, L)
                continue
            try:
                pair = src.read_layer(key, layer)
            except Exception:            # never let the thread die mid-fetch
                pair = None
            h._deliver(key, layer, pair, L)

    def close(self) -> None:
        """Deterministic shutdown: mark closed (new fetches fail fast, the
        pending queue drains as failures instead of reading a store that is
        about to close), then join the thread. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)           # sentinel: queued work fails fast
        self._thread.join()
