"""CRC-framed wire protocol for cross-node KVCache transfer — the port's
own copy of the reference's ``serving/transport.py``, over host (CPU)
tensors instead of numpy arrays. Frames and ``LAYER`` payloads are
byte-identical to the reference's, so a server of either package serves
a client of the other (``tests/test_torch_wire.py``).

The Transfer-Engine role (§3 step 3): "peer fetch" reads a sibling
``HostKVPool`` in the same process (``InProcPeer``) or a peer process's
blocks over a socket (``BlockServer`` serving, ``SocketPeer`` fetching),
with the ``SSDBlockStore`` header discipline — a magic tag, an explicit
length, and a CRC32 over every frame — so a truncated stream, a torn
frame, or flipped bits produce a *typed error*, never wrong KV bytes.

One frame = ``MAGIC | msg-type | payload-len | crc32 | payload``, the CRC
over the header prefix and the payload. A ``FETCH_BLOCK`` is served
layer-major as one ``LAYER`` frame per layer (the frame CRC is that
layer's integrity check), exactly the unit ``AsyncPrefetcher.fetch``
consumes — a ``SocketPeer`` plugs into the engine's ``PeerSource``
unchanged and returns the host tensors an ``InProcPeer`` returns. A
``LAYER`` payload carries bf16 as its raw 16-bit patterns named
``"bfloat16"`` (numpy's name), as the SSD store does.

Error taxonomy, shared by the in-process and socket transports (the
engine maps these to the ``fallback_reasons`` it records; every failure
degrades to recompute upstream):

* ``PeerUnreachable`` — the node is gone (killed pool, dead process,
  refused/reset connection, timeout). Reason ``peer_unreachable``.
* ``StaleDirectory`` — the node is alive but no longer holds the block
  (the advisory directory lagged). Reason ``stale_directory``.
* ``TornFrame`` — bytes arrived but failed integrity (bad magic, CRC
  mismatch, mid-frame EOF, or the owner's own store rejected the slot).
  Reason ``verify_failed``.

``python -m repro_torch.serving.transport --store DIR`` runs a standalone
block node over an existing ``SSDBlockStore`` directory.
"""
from __future__ import annotations

import json
import math
import socket
import struct
import threading
import time
import zlib
from typing import Callable, Optional

import torch

from repro_torch.serving.ssd_store import (_as_bytes, dtype_from_name,
                                           dtype_name)

_WIRE_MAGIC = b"MKW1"
_FRAME_HDR = struct.Struct("<4sBII")    # magic, msg type, payload len, crc
_HDR_PREFIX = struct.Struct("<4sBI")    # the CRC'd part of the header
_MAX_PAYLOAD = 256 << 20                # sanity bound: beyond this = torn
_RECV_CHUNK = 1 << 16


def _frame_crc(mtype: int, n: int, payload: bytes) -> int:
    """CRC32 over header prefix (magic, type, length) AND payload: a bit
    flip anywhere in the frame — a mis-typed header is corruption too —
    must fail the check, not just flips inside the payload."""
    crc = zlib.crc32(_HDR_PREFIX.pack(_WIRE_MAGIC, mtype, n))
    return zlib.crc32(payload, crc) & 0xFFFFFFFF

# ---- message types ---------------------------------------------------------
MSG_GEOM = 1            # -> OK {"n_layers": L}
MSG_FETCH_LAYER = 2     # {"key": k, "layer": l} -> LAYER | ERR
MSG_LAYER = 3           # binary: json meta + k bytes + v bytes
MSG_OK = 4              # json reply
MSG_ERR = 5             # {"code": taxonomy, "msg": detail}
MSG_HELLO = 16          # {"node": id, "port": block server port}
MSG_PUBLISH = 17        # {"key": k, "node": id, "tier": t}
MSG_WITHDRAW = 18       # {"key": k, "node": id}
MSG_LOOKUP = 19         # {"key": k} -> OK {"holders": [[node, tier], ...]}
MSG_NODES = 20          # {} -> OK {"nodes": [[node, host, port], ...]}
MSG_BARRIER = 21        # {"name": s, "n": int} -> OK {"arrived": int}
MSG_STATS = 22          # {} -> OK {directory stats}


class PeerError(Exception):
    """Base of the cross-node transfer taxonomy."""


class PeerUnreachable(PeerError):
    """The peer is gone — killed, or its connection refused, reset or
    timed out."""


class TornFrame(PeerError):
    """Bytes arrived but failed integrity: bad magic, length out of
    bounds, CRC mismatch, EOF mid-frame, or a CRC-rejected store slot."""


class StaleDirectory(PeerError):
    """The peer is alive but does not hold the requested block — the
    advisory directory entry lagged reality."""


def fallback_reason(exc: PeerError) -> str:
    """Map a taxonomy error to the engine's ``fallback_reasons`` key."""
    if isinstance(exc, PeerUnreachable):
        return "peer_unreachable"
    if isinstance(exc, StaleDirectory):
        return "stale_directory"
    if isinstance(exc, TornFrame):
        return "verify_failed"
    return "peer_fetch_failed"


# ---------------------------------------------------------------------------
# frame codec
# ---------------------------------------------------------------------------

def encode_frame(mtype: int, payload: bytes) -> bytes:
    """One wire frame: header (magic, type, length, CRC32) + payload."""
    if not 0 <= mtype < 256:
        raise ValueError(f"msg type {mtype} out of range")
    crc = _frame_crc(mtype, len(payload), payload)
    return _FRAME_HDR.pack(_WIRE_MAGIC, mtype, len(payload), crc) + payload


class FrameReader:
    """Incremental frame parser with partial-read reassembly.

    ``feed(data)`` accepts bytes as they arrive off ``recv`` — at any
    fragmentation — and returns every COMPLETE ``(mtype, payload)``
    decoded so far.  Integrity failures (bad magic, oversized length,
    CRC mismatch) raise ``TornFrame``; call ``eof()`` when the stream
    ends to turn a buffered partial frame into ``TornFrame`` too
    (a connection that dies mid-frame must never look like a clean
    close)."""

    def __init__(self) -> None:
        self._buf = bytearray()

    @property
    def pending(self) -> int:
        """Bytes buffered toward an incomplete frame."""
        return len(self._buf)

    def feed(self, data: bytes) -> list:
        self._buf.extend(data)
        out = []
        while len(self._buf) >= _FRAME_HDR.size:
            magic, mtype, n, crc = _FRAME_HDR.unpack_from(self._buf)
            if magic != _WIRE_MAGIC:
                raise TornFrame(f"bad frame magic {bytes(magic)!r}")
            if n > _MAX_PAYLOAD:
                raise TornFrame(f"frame length {n} exceeds bound")
            end = _FRAME_HDR.size + n
            if len(self._buf) < end:
                break                   # wait for the rest of the payload
            payload = bytes(self._buf[_FRAME_HDR.size:end])
            del self._buf[:end]
            if _frame_crc(mtype, n, payload) != crc:
                raise TornFrame(f"frame CRC mismatch (type {mtype})")
            out.append((mtype, payload))
        return out

    def eof(self) -> None:
        """The stream closed: raise if it died mid-frame."""
        if self._buf:
            raise TornFrame(
                f"stream closed mid-frame ({len(self._buf)} bytes buffered)")


def _pack_json(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def _unpack_json(payload: bytes):
    try:
        return json.loads(payload.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise TornFrame(f"undecodable control payload: {e}") from None


def pack_layer(key: int, layer: int, k: torch.Tensor,
               v: torch.Tensor) -> bytes:
    """LAYER payload: length-prefixed json meta, then the raw k and v
    bytes of two host tensors (the frame CRC covers all of it — the
    per-layer integrity check)."""
    kb = _as_bytes(k)
    vb = _as_bytes(v)
    meta = _pack_json(dict(key=int(key), layer=int(layer),
                           shape=list(k.shape), dtype=dtype_name(k.dtype),
                           klen=len(kb)))
    return struct.pack("<I", len(meta)) + meta + kb + vb


def _tensor_from(buf: memoryview, dtype: torch.dtype, shape) -> torch.Tensor:
    """One owned, writable host tensor from received bytes (one copy: a
    tensor over the ``bytes`` itself would be read-only and alias it)."""
    return torch.frombuffer(bytearray(buf), dtype=torch.uint8) \
        .view(dtype).reshape(shape)


def unpack_layer(payload: bytes):
    """Inverse of ``pack_layer`` -> (meta dict, k, v)."""
    if len(payload) < 4:
        raise TornFrame("layer payload shorter than its meta prefix")
    (jlen,) = struct.unpack_from("<I", payload)
    if 4 + jlen > len(payload):
        raise TornFrame("layer meta length exceeds payload")
    meta = _unpack_json(payload[4:4 + jlen])
    try:
        shape = tuple(int(n) for n in meta["shape"])
        dtype = dtype_from_name(meta["dtype"])
        klen = int(meta["klen"])
    except (KeyError, TypeError, ValueError) as e:
        raise TornFrame(f"malformed layer meta: {e}") from None
    body = memoryview(payload)[4 + jlen:]
    itemsize = torch.empty((), dtype=dtype).element_size()
    if len(body) != klen + klen or klen != math.prod(shape) * itemsize:
        raise TornFrame("layer body size disagrees with its meta")
    k = _tensor_from(body[:klen], dtype, shape)
    v = _tensor_from(body[klen:], dtype, shape)
    return meta, k, v


class FrameConn:
    """A framed, blocking request/response connection over one socket.

    Raises the taxonomy instead of raw socket errors: OS-level failures
    (reset, refused, timeout, clean close while a reply is owed) become
    ``PeerUnreachable``; integrity failures become ``TornFrame``."""

    def __init__(self, sock: socket.socket, timeout: Optional[float] = 5.0):
        sock.settimeout(timeout)
        self._sock = sock
        self._reader = FrameReader()

    def settimeout(self, timeout: Optional[float]) -> None:
        """Adjust the read timeout (long-blocking RPCs like BARRIER wait
        server-side longer than an ordinary reply would)."""
        self._sock.settimeout(timeout)

    def send(self, mtype: int, payload: bytes) -> None:
        try:
            self._sock.sendall(encode_frame(mtype, payload))
        except OSError as e:
            raise PeerUnreachable(f"send failed: {e}") from None

    def recv(self):
        """Next (mtype, payload) frame; blocks up to the timeout."""
        while True:
            frames = self._reader.feed(b"")
            if frames:
                # feed() drains at most what's buffered; loop below reads
                return frames[0]
            try:
                data = self._sock.recv(_RECV_CHUNK)
            except socket.timeout:
                raise PeerUnreachable("peer read timed out") from None
            except OSError as e:
                raise PeerUnreachable(f"recv failed: {e}") from None
            if not data:
                self._reader.eof()      # mid-frame close -> TornFrame
                raise PeerUnreachable("peer closed the connection")
            frames = self._reader.feed(data)
            if frames:
                if len(frames) > 1:
                    # requests are strictly serial on a FrameConn; extra
                    # frames mean the stream desynced
                    raise TornFrame("unexpected pipelined frames")
                return frames[0]

    def request(self, mtype: int, payload: bytes):
        self.send(mtype, payload)
        return self.recv()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# peer backends: what a node serves its blocks FROM
# ---------------------------------------------------------------------------


class InProcPeer:
    """Peer backed by a sibling ``HostKVPool`` object in this process: a
    ``kill()``-ed pool raises ``PeerUnreachable``, a missing block
    ``StaleDirectory``, and a CRC-rejected store slot ``TornFrame``."""

    def __init__(self, pool) -> None:
        self.pool = pool

    def _check_alive(self) -> None:
        if self.pool is None or not self.pool.alive:
            raise PeerUnreachable("peer pool is dead (killed node)")

    @property
    def n_layers(self) -> int:
        self._check_alive()
        store = self.pool.store
        if store is not None and store.n_layers:
            return store.n_layers
        for kv in self.pool.data.values():
            return kv[0].shape[0]
        return 0

    def read_layer(self, key: int, layer: int):
        """One layer's (k, v) host tensors; the caller copies them before
        the owner may mutate or drop its block."""
        self._check_alive()
        kv = self.pool.data.get(key)
        if kv is not None:
            return kv[0][layer], kv[1][layer]
        store = self.pool.store
        if store is None or key not in store:
            raise StaleDirectory(f"peer no longer holds block {key}")
        pair = store.read_layer(key, layer)
        if pair is None:                # store CRC / truncation reject
            raise TornFrame(f"peer store rejected block {key} layer {layer}")
        return pair

    def close(self) -> None:
        pass


class StorePeer:
    """Peer backend over a bare ``SSDBlockStore`` (no pool)."""

    def __init__(self, store) -> None:
        self.store = store

    @property
    def n_layers(self) -> int:
        return self.store.n_layers

    def read_layer(self, key: int, layer: int):
        if key not in self.store:
            raise StaleDirectory(f"store has no block {key}")
        pair = self.store.read_layer(key, layer)
        if pair is None:
            raise TornFrame(f"store rejected block {key} layer {layer}")
        return pair

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# block server (the serving side of FETCH_BLOCK)
# ---------------------------------------------------------------------------


class BlockServer:
    """Serves ``GEOM``/``FETCH_LAYER`` for one node's blocks.

    Thread-per-connection over a listening TCP socket (loopback by
    default).  ``stall_s`` delays every LAYER frame — the chaos harness
    uses it to widen the mid-transfer window it kill -9's into — and
    ``mangle`` lets tests corrupt or truncate outgoing LAYER frames at
    exact byte boundaries (return ``None`` to drop the connection
    instead, simulating death mid-block)."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0, *,
                 stall_s: float = 0.0,
                 mangle: Optional[Callable[[bytes], Optional[bytes]]] = None,
                 timeout: float = 30.0) -> None:
        self.backend = backend
        self.stall_s = stall_s
        self.mangle = mangle
        self.timeout = timeout
        self._lock = threading.Lock()
        #: guarded_by self._lock
        self._conns: dict[int, socket.socket] = {}
        self._closed = False            #: guarded_by self._lock
        self._next_conn = 0             #: guarded_by self._lock
        self._threads: list[threading.Thread] = []  #: guarded_by self._lock
        self.frames_served = 0          #: guarded_by self._lock
        self.bytes_served = 0           #: guarded_by self._lock
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, port))
            sock.listen(32)
        except BaseException:
            sock.close()
            raise
        self._sock = sock
        self.host, self.port = sock.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="repro-torch-wire-accept")
        self._accept_thread.start()

    @property
    def addr(self) -> tuple:
        return (self.host, self.port)

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                  # listener closed -> shut down
            alive = self._adopt(conn)
            if not alive:
                return

    def _adopt(self, conn: socket.socket) -> bool:
        """Take ownership of an accepted conn: register it and spawn its
        serve thread, or close it if the server already shut down."""
        with self._lock:
            if self._closed:
                conn.close()
                return False
            cid = self._next_conn
            self._next_conn += 1
            self._conns[cid] = conn
            t = threading.Thread(target=self._serve, args=(conn, cid),
                                 daemon=True,
                                 name=f"repro-torch-wire-serve-{cid}")
            self._threads.append(t)
        t.start()
        return True

    def _reply_layer(self, conn: socket.socket, key: int, layer: int) -> None:
        k, v = self.backend.read_layer(key, layer)
        frame = encode_frame(MSG_LAYER, pack_layer(key, layer, k, v))
        if self.stall_s:
            time.sleep(self.stall_s)
        torn = False
        if self.mangle is not None:
            mangled = self.mangle(frame)
            if mangled is None:         # simulated death mid-block
                raise OSError("mangle dropped the connection")
            # a SHORTENED frame is a tear at a byte boundary: send the
            # partial bytes then kill the stream, so the client sees
            # exactly what a mid-frame crash produces (partial + EOF)
            torn = len(mangled) != len(frame)
            frame = mangled
        conn.sendall(frame)
        with self._lock:
            self.frames_served += 1
            self.bytes_served += len(frame)
        if torn:
            raise OSError("mangle tore the stream mid-frame")

    def _serve(self, conn: socket.socket, cid: int) -> None:
        reader = FrameReader()
        try:
            conn.settimeout(self.timeout)
            while True:
                data = conn.recv(_RECV_CHUNK)
                if not data:
                    return
                for mtype, payload in reader.feed(data):
                    if mtype == MSG_GEOM:
                        try:
                            L = self.backend.n_layers
                        except PeerError as e:
                            conn.sendall(encode_frame(MSG_ERR, _pack_json(
                                dict(code=fallback_reason(e), msg=str(e)))))
                            continue
                        conn.sendall(encode_frame(
                            MSG_OK, _pack_json(dict(n_layers=L))))
                    elif mtype == MSG_FETCH_LAYER:
                        req = _unpack_json(payload)
                        try:
                            self._reply_layer(conn, int(req["key"]),
                                              int(req["layer"]))
                        except PeerError as e:
                            conn.sendall(encode_frame(MSG_ERR, _pack_json(
                                dict(code=fallback_reason(e), msg=str(e)))))
                    else:
                        conn.sendall(encode_frame(MSG_ERR, _pack_json(
                            dict(code="peer_fetch_failed",
                                 msg=f"unknown request type {mtype}"))))
        except (OSError, PeerError):
            return                      # torn request stream / dead client
        finally:
            conn.close()
            with self._lock:
                self._conns.pop(cid, None)

    def stats(self) -> dict:
        with self._lock:
            return dict(frames_served=self.frames_served,
                        bytes_served=self.bytes_served,
                        open_conns=len(self._conns))

    def close(self) -> None:
        """Deterministic shutdown: stop accepting, drop every open
        connection, join every serve thread. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns.values())
            threads = list(self._threads)
        try:
            # closing the fd alone does NOT wake a thread blocked in
            # accept() on Linux; shutdown makes accept raise immediately
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()
        self._accept_thread.join()
        for t in threads:
            t.join()


# ---------------------------------------------------------------------------
# socket peer (the fetching side)
# ---------------------------------------------------------------------------


class SocketPeer:
    """Client over a peer's ``BlockServer`` — the socket-backed peer type
    for ``HostKVPool.add_peer``.

    Duck-types ``InProcPeer`` (``n_layers`` + ``read_layer`` raising the
    shared taxonomy), so the engine's ``PeerSource``/``AsyncPrefetcher``
    stream remote blocks through the same layer-major queue with zero
    changes.  Connections are lazy and re-established per call after a
    failure; a ``TornFrame`` drops the (desynced) connection before
    re-raising.  ``bw_ema`` is the measured payload bandwidth — what the
    Messenger's link calibration feeds on."""

    def __init__(self, addr, node=None, timeout: float = 5.0) -> None:
        self.addr = (addr[0], int(addr[1]))
        self.node = node
        self.timeout = timeout
        self._lock = threading.Lock()
        self._conn: Optional[FrameConn] = None  #: guarded_by self._lock
        self._n_layers: Optional[int] = None
        self.layer_reads = 0
        self.bytes_read = 0
        self._bw_ema: Optional[float] = None    # measured payload bytes/s

    # ---- connection management ----------------------------------------
    def _ensure_locked(self) -> FrameConn:
        if self._conn is None:
            try:
                sock = socket.create_connection(self.addr,
                                                timeout=self.timeout)
            except OSError as e:
                raise PeerUnreachable(
                    f"cannot connect to {self.addr}: {e}") from None
            self._conn = FrameConn(sock, timeout=self.timeout)
        return self._conn

    def _drop_locked(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def _rpc(self, mtype: int, payload: bytes):
        with self._lock:
            conn = self._ensure_locked()
            try:
                rtype, rpayload = conn.request(mtype, payload)
            except PeerError:
                self._drop_locked()     # dead or desynced either way
                raise
            if rtype == MSG_ERR:
                err = _unpack_json(rpayload)
                raise _ERR_TYPES.get(err.get("code"), PeerError)(
                    err.get("msg", "peer error"))
            return rtype, rpayload

    # ---- peer protocol -------------------------------------------------
    @property
    def n_layers(self) -> int:
        if self._n_layers is None:
            rtype, payload = self._rpc(MSG_GEOM, b"")
            if rtype != MSG_OK:
                raise TornFrame(f"GEOM answered with frame type {rtype}")
            self._n_layers = int(_unpack_json(payload).get("n_layers", 0))
        return self._n_layers

    def read_layer(self, key: int, layer: int):
        t0 = time.monotonic()
        rtype, payload = self._rpc(
            MSG_FETCH_LAYER, _pack_json(dict(key=int(key), layer=int(layer))))
        if rtype != MSG_LAYER:
            with self._lock:
                self._drop_locked()
            raise TornFrame(f"FETCH_LAYER answered with frame type {rtype}")
        meta, k, v = unpack_layer(payload)
        if meta["key"] != int(key) or meta["layer"] != int(layer):
            with self._lock:
                self._drop_locked()
            raise TornFrame(
                f"layer frame for ({meta['key']}, {meta['layer']}) "
                f"answered a fetch of ({key}, {layer})")
        dt = time.monotonic() - t0
        nbytes = len(payload)
        self.layer_reads += 1
        self.bytes_read += nbytes
        if dt > 0:
            bw = nbytes / dt
            self._bw_ema = bw if self._bw_ema is None \
                else 0.7 * self._bw_ema + 0.3 * bw
        return k, v

    @property
    def bw_ema(self) -> Optional[float]:
        """Measured wire bandwidth (payload bytes/s EMA; None until the
        first read) — feed it to ``Messenger.set_link_bw`` to calibrate
        the peer-fetch arm against reality instead of the spec sheet."""
        return self._bw_ema

    def close(self) -> None:
        with self._lock:
            self._drop_locked()


_ERR_TYPES = {
    "peer_unreachable": PeerUnreachable,
    "stale_directory": StaleDirectory,
    "verify_failed": TornFrame,
    "torn_frame": TornFrame,
}


# ---------------------------------------------------------------------------
# standalone block node: the chaos harness's kill -9 target
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.transport",
        description="standalone block node: serve an existing "
                    "SSDBlockStore directory over the wire protocol")
    ap.add_argument("--store", required=True,
                    help="SSDBlockStore directory to serve (read-only use)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--node-id", type=int, default=0)
    ap.add_argument("--directory", default=None,
                    help="host:port of the directory service to HELLO and "
                         "publish this store's keys to")
    ap.add_argument("--tier", default="ssd", choices=("dram", "ssd"))
    ap.add_argument("--stall", type=float, default=0.0,
                    help="seconds to stall before every LAYER frame "
                         "(chaos-window widening)")
    args = ap.parse_args(argv)

    from repro_torch.serving.ssd_store import SSDBlockStore
    store = SSDBlockStore(args.store)
    server = BlockServer(StorePeer(store), port=args.port,
                         stall_s=args.stall)
    rdir = None
    if args.directory:
        from repro_torch.serving.directory_service import RemoteDirectory
        host, port = args.directory.rsplit(":", 1)
        rdir = RemoteDirectory((host, int(port)), node_id=args.node_id,
                               block_port=server.port)
        for key in store.keys():
            rdir.register(key, args.node_id, args.tier)
    print(f"PORT {server.port}", flush=True)
    try:
        threading.Event().wait()        # until SIGTERM/SIGKILL
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        if rdir is not None:
            rdir.close()
        store.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
