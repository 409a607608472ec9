"""The port's wire against the reference's: the mirror of
``tests/test_transport.py`` (CRC framing delivers exactly the bytes sent
or raises a TYPED error, at any fragmentation, truncation or bit flip;
bf16 layers included), byte identity of frames and ``LAYER`` payloads
between the packages, and servers of each package serving clients of the
other — the block server both ways, the directory service both ways
(HELLO, PUBLISH, LOOKUP, NODES, BARRIER and the connection lease).

Layers cross the packages as numpy arrays (the reference's currency,
bf16 as ``ml_dtypes.bfloat16``) and torch host tensors (the port's);
bit equality is checked on the raw 16-/32-bit patterns. Every test
closes its servers and clients, so the conftest thread and fd checks
pass."""
import os
import random
import socket
import struct
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, strategies as st

import repro.serving.transport as JW
from repro.serving.directory_service import DirectoryServer as JDirServer
from repro.serving.directory_service import RemoteDirectory as JRemoteDir
from repro_torch.bridge import tensor_from_numpy
from repro_torch.serving.directory_service import (DirectoryServer,
                                                   RemoteDirectory)
from repro_torch.serving.ssd_store import SSDBlockStore
from repro_torch.serving.transport import (_FRAME_HDR, BlockServer, FrameConn,
                                           FrameReader, PeerError,
                                           PeerUnreachable, SocketPeer,
                                           StaleDirectory, TornFrame,
                                           encode_frame, fallback_reason,
                                           pack_layer, unpack_layer)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
DTYPES = [np.float32, jnp.bfloat16]


def _payload(rng: random.Random, n: int) -> bytes:
    return bytes(rng.randrange(256) for _ in range(n))


def _bits(x) -> np.ndarray:
    """Raw bit patterns of a numpy array or a host tensor."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.int16 if x.element_size() == 2
                      else torch.int32).numpy()
    x = np.ascontiguousarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def _layer_np(key: int, layer: int, dtype, shape=(1, 2, 8)):
    rng = np.random.default_rng(1000 * key + layer)
    a = rng.standard_normal(shape).astype(np.float32).astype(dtype)
    b = (a.astype(np.float32) + 1).astype(dtype)
    return a, b


# ---------------------------------------------------------------------------
# mirror of tests/test_transport.py: roundtrip + partial-read reassembly
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 3))
def test_roundtrip_any_fragmentation(seed, n_frames_extra):
    rng = random.Random(seed)
    frames = [(rng.randrange(256), _payload(rng, rng.randrange(0, 200)))
              for _ in range(1 + n_frames_extra)]
    wire = b"".join(encode_frame(t, p) for t, p in frames)
    reader = FrameReader()
    got = []
    i = 0
    while i < len(wire):
        step = rng.randrange(1, 17)
        got += reader.feed(wire[i:i + step])
        i += step
    assert got == frames
    assert reader.pending == 0
    reader.eof()


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_truncation_never_yields_a_frame(seed):
    rng = random.Random(seed)
    payload = _payload(rng, rng.randrange(1, 150))
    wire = encode_frame(3, payload)
    cut = rng.randrange(1, len(wire))
    reader = FrameReader()
    assert reader.feed(wire[:cut]) == []
    assert reader.pending == cut
    with pytest.raises(TornFrame):
        reader.eof()


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_bitflip_typed_error_never_silent_corruption(seed):
    rng = random.Random(seed)
    payload = _payload(rng, rng.randrange(1, 120))
    wire = bytearray(encode_frame(7, payload))
    pos = rng.randrange(len(wire))
    wire[pos] ^= 1 << rng.randrange(8)
    reader = FrameReader()
    try:
        frames = reader.feed(bytes(wire))
    except TornFrame:
        return
    assert frames == [], "silent corruption: a flipped frame decoded!"
    assert reader.pending
    with pytest.raises(TornFrame):
        reader.eof()


def test_oversized_length_is_torn():
    hdr = _FRAME_HDR.pack(b"MKW1", 1, 1 << 30, 0)
    with pytest.raises(TornFrame):
        FrameReader().feed(hdr)


def test_bad_magic_is_torn():
    with pytest.raises(TornFrame):
        FrameReader().feed(b"XXXX" + b"\0" * 16)


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_layer_roundtrip(seed):
    """Both dtypes the engine moves (f32, bf16) come back bit for bit,
    as owned, writable host tensors."""
    rng = np.random.default_rng(seed)
    shape = (1, int(rng.integers(1, 5)), int(rng.integers(1, 17)))
    for dtype in (torch.float32, torch.bfloat16):
        k = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
        v = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
        meta, k2, v2 = unpack_layer(pack_layer(seed, 3, k, v))
        assert meta["key"] == seed and meta["layer"] == 3
        assert k2.dtype == dtype and tuple(k2.shape) == shape
        assert np.array_equal(_bits(k), _bits(k2))
        assert np.array_equal(_bits(v), _bits(v2))
        k2.add_(1)                      # owned: writable, aliases nothing


def test_layer_meta_mismatch_is_torn():
    k = torch.zeros((1, 2, 4), dtype=torch.float32)
    payload = bytearray(pack_layer(5, 0, k, k))
    with pytest.raises(TornFrame):
        unpack_layer(bytes(payload[:-1]))
    with pytest.raises(TornFrame):
        unpack_layer(struct.pack("<I", 4) + b"nope")
    # a dtype name torch does not know is a malformed meta, not a crash
    meta = b'{"key":1,"layer":0,"shape":[1],"dtype":"nope","klen":4}'
    with pytest.raises(TornFrame):
        unpack_layer(struct.pack("<I", len(meta)) + meta + b"\0" * 8)


def test_frameconn_roundtrip_and_taxonomy():
    a, b = socket.socketpair()
    ca, cb = FrameConn(a, timeout=5.0), FrameConn(b, timeout=5.0)
    ca.send(9, b"ping")
    assert cb.recv() == (9, b"ping")
    b.sendall(encode_frame(2, b"x" * 50)[:10])
    cb.close()
    with pytest.raises(TornFrame):
        ca.recv()
    ca.close()


def test_frameconn_clean_close_is_unreachable():
    a, b = socket.socketpair()
    ca, cb = FrameConn(a, timeout=5.0), FrameConn(b, timeout=5.0)
    cb.close()
    with pytest.raises(PeerUnreachable):
        ca.recv()
    ca.close()


def test_fallback_reason_mapping():
    assert fallback_reason(PeerUnreachable("x")) == "peer_unreachable"
    assert fallback_reason(StaleDirectory("x")) == "stale_directory"
    assert fallback_reason(TornFrame("x")) == "verify_failed"
    assert fallback_reason(PeerError("x")) == "peer_fetch_failed"


class _TensorBackend:
    """Two layers of bf16 host tensors per key."""
    n_layers = 2

    def read_layer(self, key, layer):
        a, b = _layer_np(key, layer, jnp.bfloat16)
        return tensor_from_numpy(a, "cpu"), tensor_from_numpy(b, "cpu")


def test_socket_peer_survives_mangled_frames():
    state = dict(mode=None)

    def mangle(frame: bytes):
        if state["mode"] == "flip":
            f = bytearray(frame)
            f[-1] ^= 0xFF
            return bytes(f)
        if state["mode"] == "truncate":
            return frame[:len(frame) // 2]
        return frame

    srv = BlockServer(_TensorBackend(), mangle=mangle)
    peer = SocketPeer(srv.addr, node=0, timeout=5.0)
    try:
        k, v = peer.read_layer(1, 0)
        ref = _layer_np(1, 0, jnp.bfloat16)[0]
        assert k.dtype == torch.bfloat16
        assert np.array_equal(_bits(k), _bits(ref))
        state["mode"] = "flip"
        with pytest.raises(TornFrame):
            peer.read_layer(1, 0)
        state["mode"] = "truncate"
        with pytest.raises(TornFrame):
            peer.read_layer(1, 1)
        state["mode"] = None
        k2, _ = peer.read_layer(1, 0)
        assert np.array_equal(_bits(k2), _bits(ref))
        assert peer.bw_ema and peer.bw_ema > 0
    finally:
        peer.close()
        srv.close()


def test_socket_peer_concurrent_readers_one_server():
    srv = BlockServer(_TensorBackend())
    errs: list = []

    def fetch(key):
        p = SocketPeer(srv.addr, node=0, timeout=10.0)
        try:
            for layer in range(2):
                k, _ = p.read_layer(key, layer)
                ref = _layer_np(key, layer, jnp.bfloat16)[0]
                if not np.array_equal(_bits(k), _bits(ref)):
                    errs.append((key, layer))
        except PeerError as e:
            errs.append((key, repr(e)))
        finally:
            p.close()

    ts = [threading.Thread(target=fetch, args=(i,),
                           name=f"repro-torch-cl-{i}") for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    srv.close()
    assert not errs, errs


# ---------------------------------------------------------------------------
# byte identity with the reference
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_frames_byte_identical(seed):
    rng = random.Random(seed)
    for _ in range(4):
        mtype, p = rng.randrange(256), _payload(rng, rng.randrange(0, 300))
        assert encode_frame(mtype, p) == JW.encode_frame(mtype, p)
    obj = dict(key=rng.randrange(2**63), layer=rng.randrange(80))
    assert encode_frame(2, JW._pack_json(obj)) == \
        JW.encode_frame(2, JW._pack_json(obj))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_layer_payload_byte_identical(dtype):
    for key, layer, shape in ((7, 0, (1, 2, 8)), (2**63 + 5, 31, (512, 5, 64)),
                              (0, 3, (3, 1, 1))):
        k, v = _layer_np(key % 1000, layer, dtype, shape)
        ours = pack_layer(key, layer, tensor_from_numpy(k, "cpu"),
                          tensor_from_numpy(v, "cpu"))
        theirs = JW.pack_layer(key, layer, k, v)
        assert ours == theirs
        # each package reads the other's payload bit for bit
        meta, k2, v2 = unpack_layer(theirs)
        jmeta, jk, jv = JW.unpack_layer(ours)
        assert meta == jmeta
        assert np.array_equal(_bits(k2), _bits(k))
        assert np.array_equal(_bits(jv), _bits(v2))


# ---------------------------------------------------------------------------
# cross-package serving: block server both ways
# ---------------------------------------------------------------------------

class _NumpyBackend:
    n_layers = 3

    def read_layer(self, key, layer):
        return _layer_np(key, layer, jnp.bfloat16, (4, 2, 8))


class _TorchBackend:
    n_layers = 3

    def read_layer(self, key, layer):
        a, b = _layer_np(key, layer, jnp.bfloat16, (4, 2, 8))
        return tensor_from_numpy(a, "cpu"), tensor_from_numpy(b, "cpu")


def test_reference_server_serves_port_peer():
    srv = JW.BlockServer(_NumpyBackend())
    peer = SocketPeer(srv.addr, node=0)
    try:
        assert peer.n_layers == 3
        for key in (1, 9):
            for layer in range(3):
                k, v = peer.read_layer(key, layer)
                rk, rv = _layer_np(key, layer, jnp.bfloat16, (4, 2, 8))
                assert isinstance(k, torch.Tensor)
                assert k.dtype == torch.bfloat16
                assert np.array_equal(_bits(k), _bits(rk))
                assert np.array_equal(_bits(v), _bits(rv))
        assert peer.layer_reads == 6 and peer.bw_ema > 0
        peer.close()
        srv.close()         # joins the serve threads: the counts are final
        assert srv.stats()["frames_served"] == 6
    finally:
        peer.close()
        srv.close()


def test_port_server_serves_reference_peer():
    srv = BlockServer(_TorchBackend())
    peer = JW.SocketPeer(srv.addr, node=0)
    try:
        assert peer.n_layers == 3
        for key in (1, 9):
            for layer in range(3):
                k, v = peer.read_layer(key, layer)
                rk, rv = _layer_np(key, layer, jnp.bfloat16, (4, 2, 8))
                assert k.dtype == rk.dtype
                assert np.array_equal(_bits(k), _bits(rk))
                assert np.array_equal(_bits(v), _bits(rv))
        peer.close()
        srv.close()         # joins the serve threads: the counts are final
        st_ = srv.stats()
        assert st_["frames_served"] == 6 and st_["bytes_served"] > 6 * 256
    finally:
        peer.close()
        srv.close()


def test_errors_cross_the_packages():
    """A missing block is ``StaleDirectory`` on either client, whichever
    package serves it: the ERR codes are one vocabulary."""
    class Missing:
        n_layers = 1

        def read_layer(self, key, layer):
            raise StaleDirectory(f"no block {key}")

    class JMissing:
        n_layers = 1

        def read_layer(self, key, layer):
            raise JW.StaleDirectory(f"no block {key}")

    for Srv, backend, Peer, exc in (
            (BlockServer, Missing(), JW.SocketPeer, JW.StaleDirectory),
            (JW.BlockServer, JMissing(), SocketPeer, StaleDirectory)):
        srv = Srv(backend)
        peer = Peer(srv.addr, node=0)
        try:
            with pytest.raises(exc):
                peer.read_layer(3, 0)
        finally:
            peer.close()
            srv.close()


# ---------------------------------------------------------------------------
# cross-package serving: the directory service both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server_pkg", ["port", "reference"])
def test_directory_service_cross_package(server_pkg):
    """HELLO, PUBLISH, LOOKUP, NODES, BARRIER and STATS between a server
    of one package and clients of the other, then the lease: closing a
    node's connection drops every claim it published."""
    Server, Client = (DirectoryServer, JRemoteDir) \
        if server_pkg == "port" else (JDirServer, RemoteDirectory)
    ds = Server()
    a = Client(ds.addr, node_id=0, block_port=4100)
    b = Client(ds.addr, node_id=1, block_port=4101)
    c = Client(ds.addr)                 # a node-less observer
    try:
        a.register(11, 0, "dram")
        a.register(12, 0, "ssd")
        b.register(12, 1, "ssd")
        b.register(13, 1, "ssd")
        assert c.holders(11) == {0: "dram"}
        assert c.holders(12) == {0: "ssd", 1: "ssd"}
        assert c.nodes_with(12, tier="ssd") == [0, 1]
        assert c.nodes() == {0: ("127.0.0.1", 4100),
                             1: ("127.0.0.1", 4101)}
        assert c.best_ssd_extension([12, 13, 99], 0, exclude=()) == (2, 1)
        assert b.unregister(13, 1) and not b.unregister(13, 1)
        assert c.stats()["keys"] >= 2 and c.stats()["nodes"] == 2
        res = {}

        def arrive(cl, name):
            res[name] = cl.barrier("go", 2, timeout=20)

        t = threading.Thread(target=arrive, args=(a, "a"),
                             name="repro-torch-barrier")
        t.start()
        arrive(b, "b")
        t.join(timeout=30)
        assert not t.is_alive()
        assert res["a"]["met"] and res["b"]["met"]
        assert res["a"]["arrived"] >= 2
        a.close()                       # node 0's lease ends
        deadline = 50
        while deadline and 0 in ds.directory.holders(12):
            threading.Event().wait(0.05)
            deadline -= 1
        assert 0 not in ds.directory.holders(12)
        assert ds.directory.holders(11) == {}
        assert ds.directory.holders(12) == {1: "ssd"}
        assert c.nodes() == {1: ("127.0.0.1", 4101)}
    finally:
        for cl in (a, b, c):
            cl.close()
        ds.close()


# ---------------------------------------------------------------------------
# the standalone mains: a block node over a port store, HELLO'd to a
# directory service process
# ---------------------------------------------------------------------------

def _read_port(proc) -> int:
    line = proc.stdout.readline()
    assert line.startswith("PORT "), f"unexpected banner: {line!r}"
    return int(line.split()[1])


def test_standalone_block_node_and_directory(tmp_path):
    store = SSDBlockStore(str(tmp_path / "s"), writeback_batch=1)
    blocks = {}
    for key in (5, 6):
        k = torch.randn(2, 4, 1, 8).to(torch.bfloat16)
        blocks[key] = (k, k + 1)
        store.put(key, *blocks[key])
    store.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serving.directory_service"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env))
        dport = _read_port(procs[0])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serving.transport",
             "--store", str(tmp_path / "s"), "--node-id", "3",
             "--directory", f"127.0.0.1:{dport}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env))
        bport = _read_port(procs[1])
        rd = RemoteDirectory(("127.0.0.1", dport))
        peer = SocketPeer(("127.0.0.1", bport), node=3)
        try:
            assert rd.holders(5) == {3: "ssd"} and rd.holders(6) == {3: "ssd"}
            assert rd.nodes() == {3: ("127.0.0.1", bport)}
            assert peer.n_layers == 2
            for key, (k, v) in blocks.items():
                for layer in range(2):
                    gk, gv = peer.read_layer(key, layer)
                    assert torch.equal(gk.view(torch.int16),
                                       k[layer].view(torch.int16))
                    assert torch.equal(gv.view(torch.int16),
                                       v[layer].view(torch.int16))
            with pytest.raises(StaleDirectory):
                peer.read_layer(77, 0)
        finally:
            peer.close()
            rd.close()
    finally:
        for p in reversed(procs):
            p.kill()
            p.wait(timeout=30)
            p.stdout.close()
