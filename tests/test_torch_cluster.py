"""The port's wire and cluster processes against the reference's
(``smollm-360m.reduced()``, weights carried by ``bridge.params_from_jax``):

* the mirrors of the socket cases of ``tests/test_chaos_cluster.py``
  (dead owner, server death mid-block, torn frames, stale directory,
  directory partition, the full wire topology), each bit-exact against
  the port's own DRAM-only run with the right ``fallback_reasons``;
* a block a node demotes stays readable by a peer throughout the move;
* a 2-process ``--processes`` run bit-exact against its oracle, and the
  command line's refusals.

The launcher's in-process lanes (the Conductor lane against
``examples/serve_cluster.py``, global pool, loop, paged vs dense) are in
``tests/test_torch_cluster_lanes.py``. Every test closes its pools,
servers and clients, so the conftest thread and fd checks pass."""
import threading

import jax
import numpy as np
import pytest
import torch

import repro.models.transformer as JT
from repro.configs.base import get_config as jax_config
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.core.directory import GlobalBlockDirectory
from repro_torch.core.trace import BLOCK_TOKENS
from repro_torch.launch.serve_cluster import main as cluster_main
from repro_torch.launch.serve_cluster import serve_cluster
from repro_torch.serving.directory_service import (DirectoryServer,
                                                   RemoteDirectory)
from repro_torch.serving.engine import (DecodeWorker, HostKVPool,
                                        PrefillWorker, connect_pools,
                                        prefix_hash_ids)
from repro_torch.serving.request import ServingRequest
from repro_torch.serving.transport import BlockServer, InProcPeer, SocketPeer

torch.set_num_threads(1)

ARCH = "smollm-360m"


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def setup(weights):
    _, cfg, _, tp = weights
    rng = np.random.default_rng(42)
    doc = rng.integers(0, cfg.vocab_size, 2 * BLOCK_TOKENS)
    q1 = np.concatenate([doc, rng.integers(0, cfg.vocab_size, 48)])
    q2 = np.concatenate([doc, rng.integers(0, cfg.vocab_size, 48)])
    return cfg, tp, q1, q2


def _decode_tokens(params, cfg, pres, tokens, n=3):
    dw = DecodeWorker(params, cfg, max_batch=1,
                      max_len=pres.prompt_len + n + 4)
    dw.join(ServingRequest(req_id=0, tokens=tokens, max_new=n), pres)
    out = [pres.first_token]
    while dw.n_active:
        out.extend(tok for _rid, tok, _f in dw.step())
    return out


@pytest.fixture(scope="module")
def dram_reference(setup):
    cfg, params, q1, q2 = setup
    pool = HostKVPool()
    pw = PrefillWorker(params, cfg, pool, prefill_chunk=128)
    pw(q1)
    return _decode_tokens(params, cfg, pw(q2), q2)


def _socket_nodes(setup, tmp_path, *, stall_s=0.0, mangle=None):
    """A/B pair where B reaches A ONLY over the wire: A's pool sits
    behind a ``BlockServer`` and B holds a ``SocketPeer`` to it. A's doc
    is cold-prefilled and demoted to its store."""
    cfg, params, q1, _ = setup
    d = GlobalBlockDirectory()
    pa = HostKVPool(capacity_blocks=1, ssd_capacity_blocks=64,
                    ssd_dir=str(tmp_path / "a"), writeback_batch=1,
                    directory=d, node_id=0)
    pb = HostKVPool(capacity_blocks=None, ssd_capacity_blocks=64,
                    ssd_dir=str(tmp_path / "b"), directory=d, node_id=1)
    server = BlockServer(InProcPeer(pa), stall_s=stall_s, mangle=mangle)
    peer = SocketPeer(server.addr, node=0)
    pb.add_peer(0, peer)
    pw_a = PrefillWorker(params, cfg, pa, prefill_chunk=128)
    pw_b = PrefillWorker(params, cfg, pb, prefill_chunk=128,
                         ssd_mode="overlap")
    pw_a(q1)
    pa.store.flush()
    return d, pa, pb, pw_b, server, peer


def _teardown(pa, pb, server, peer):
    peer.close()
    server.close()
    pa.close()
    pb.close()


# ---------------------------------------------------------------------------
# mirrors of the socket cases of tests/test_chaos_cluster.py
# ---------------------------------------------------------------------------

def test_socket_fetch_bit_exact(setup, dram_reference, tmp_path):
    cfg, params, _, q2 = setup
    d, pa, pb, pw_b, server, peer = _socket_nodes(setup, tmp_path)
    pres = pw_b(q2)
    assert pres.peer_blocks == 2 and pres.reused_blocks == 2
    assert _decode_tokens(params, cfg, pres, q2) == dram_reference
    assert not pb.fallback_reasons and pb.peer_fetch_failures == 0
    assert peer.bw_ema and peer.bw_ema > 0
    assert server.stats()["frames_served"] >= 2 * cfg.n_layers
    _teardown(pa, pb, server, peer)


def test_kill9_identical_reasons_in_proc_vs_socket(setup, dram_reference,
                                                   tmp_path):
    cfg, params, q1, q2 = setup
    d1 = GlobalBlockDirectory()
    pa1 = HostKVPool(capacity_blocks=1, ssd_capacity_blocks=64,
                     ssd_dir=str(tmp_path / "in_a"), writeback_batch=1,
                     directory=d1, node_id=0)
    pb1 = HostKVPool(capacity_blocks=None, ssd_capacity_blocks=64,
                     ssd_dir=str(tmp_path / "in_b"), directory=d1, node_id=1)
    connect_pools([pa1, pb1])
    pw_a1 = PrefillWorker(params, cfg, pa1, prefill_chunk=128)
    pw_b1 = PrefillWorker(params, cfg, pb1, prefill_chunk=128,
                          ssd_mode="overlap")
    pw_a1(q1)
    pa1.store.flush()
    pa1.kill()
    pres1 = pw_b1(q2)

    d2, pa2, pb2, pw_b2, server, peer = _socket_nodes(
        setup, tmp_path / "sock")
    server.close()                      # the kill -9 stand-in
    pres2 = pw_b2(q2)

    assert pb1.fallback_reasons == pb2.fallback_reasons \
        == {"peer_unreachable": 1}
    assert pres1.peer_blocks == pres2.peer_blocks == 0
    assert _decode_tokens(params, cfg, pres1, q2) == dram_reference
    assert _decode_tokens(params, cfg, pres2, q2) == dram_reference
    pa1.close()
    pb1.close()
    _teardown(pa2, pb2, server, peer)


def test_server_death_mid_block_bit_exact(setup, dram_reference, tmp_path):
    cfg, params, _, q2 = setup
    d, pa, pb, pw_b, server, peer = _socket_nodes(setup, tmp_path,
                                                  stall_s=0.05)
    killer = threading.Timer(0.12, server.close)
    killer.name = "repro-torch-chaos-killer"
    killer.start()
    try:
        pres = pw_b(q2)
    finally:
        killer.cancel()
        killer.join()
    assert _decode_tokens(params, cfg, pres, q2) == dram_reference
    assert set(pb.fallback_reasons) <= {"peer_unreachable", "verify_failed"}
    assert pb.fallback_reasons, "the death mid-block went unaccounted"
    _teardown(pa, pb, server, peer)


def test_torn_frame_at_byte_boundary(setup, dram_reference, tmp_path):
    cfg, params, _, q2 = setup
    d, pa, pb, pw_b, server, peer = _socket_nodes(
        setup, tmp_path, mangle=lambda f: f[:max(1, len(f) // 3)])
    pres = pw_b(q2)
    assert pres.peer_blocks == 0
    assert _decode_tokens(params, cfg, pres, q2) == dram_reference
    assert pb.fallback_reasons == {"verify_failed": 1}
    assert 0 not in d.holders(prefix_hash_ids(q2)[0])
    _teardown(pa, pb, server, peer)


def test_stale_directory_entry_over_wire(setup, dram_reference, tmp_path):
    cfg, params, _, q2 = setup
    d, pa, pb, pw_b, server, peer = _socket_nodes(setup, tmp_path)
    for h in prefix_hash_ids(q2):
        pa.store.delete(h)              # bytes gone, directory not told
        pa.data.pop(h, None)
    pa.store.flush()
    pres = pw_b(q2)
    assert pres.peer_blocks == 0
    assert _decode_tokens(params, cfg, pres, q2) == dram_reference
    assert pb.fallback_reasons == {"stale_directory": 1}
    assert 0 not in d.holders(prefix_hash_ids(q2)[0])
    _teardown(pa, pb, server, peer)


def test_remote_directory_end_to_end(setup, dram_reference, tmp_path):
    """The topology of one serve_cluster worker, in one process: both
    pools publish through ``RemoteDirectory`` clients and fetch through
    ``SocketPeer``s."""
    cfg, params, q1, q2 = setup
    ds = DirectoryServer()
    pools, servers, rdirs, peers = [], [], [], []
    for i in range(2):
        pool = HostKVPool(capacity_blocks=1 if i == 0 else None,
                          ssd_capacity_blocks=64, writeback_batch=1,
                          ssd_dir=str(tmp_path / f"p{i}"))
        server = BlockServer(InProcPeer(pool))
        rdir = RemoteDirectory(ds.addr, node_id=i, block_port=server.port)
        pool.directory = rdir
        pool.node_id = i
        rdir.bind(i, pool.meta)
        pools.append(pool)
        servers.append(server)
        rdirs.append(rdir)
    for i, pool in enumerate(pools):
        for nid, (host, port) in rdirs[i].nodes().items():
            if nid != i:
                sp = SocketPeer((host, port), node=nid)
                peers.append(sp)
                pool.add_peer(nid, sp)
    pw_a = PrefillWorker(params, cfg, pools[0], prefill_chunk=128)
    pw_b = PrefillWorker(params, cfg, pools[1], prefill_chunk=128,
                         ssd_mode="overlap")
    pw_a(q1)
    pools[0].store.flush()
    pres = pw_b(q2)
    assert pres.peer_blocks == 2
    assert _decode_tokens(params, cfg, pres, q2) == dram_reference
    assert not pools[1].fallback_reasons
    st = rdirs[1].stats()
    assert st["keys"] >= 2 and st["nodes"] == 2
    for sp in peers:
        sp.close()
    for s in servers:
        s.close()
    for r in rdirs:
        r.close()
    for p in pools:
        p.close()
    ds.close()


def test_directory_partition_degrades_to_recompute(setup, dram_reference,
                                                   tmp_path):
    cfg, params, _, q2 = setup
    dead = DirectoryServer()
    dead_addr = dead.addr
    dead.close()
    rdir = RemoteDirectory(dead_addr)
    pool = HostKVPool(capacity_blocks=None, ssd_capacity_blocks=64,
                      ssd_dir=str(tmp_path / "b"))
    pool.directory = rdir
    pool.node_id = 1
    rdir.bind(1, pool.meta)
    pool.add_peer(0, SocketPeer(("127.0.0.1", 1), node=0))
    pw = PrefillWorker(params, cfg, pool, prefill_chunk=128,
                       ssd_mode="overlap")
    pres = pw(q2)
    assert pres.peer_blocks == 0 and pres.reused_blocks == 0
    assert _decode_tokens(params, cfg, pres, q2) == dram_reference
    assert not pool.fallback_reasons
    st = rdir.stats()
    assert st.get("partitioned") and st["client_errors"] > 0
    pool.peers[0].close()
    rdir.close()
    pool.close()


def test_demotion_keeps_block_readable_by_peers(tmp_path):
    """A block moving from the DRAM tier to the SSD store is readable
    through ``InProcPeer`` at every step of the move — a node's
    ``BlockServer`` serves from its pool while the node's own prefill
    demotes blocks: the store stages the block before the DRAM copy
    goes."""
    pool = HostKVPool(capacity_blocks=1, ssd_capacity_blocks=8,
                      writeback_batch=1, ssd_dir=str(tmp_path))
    peer = InProcPeer(pool)
    k = torch.randn(2, BLOCK_TOKENS, 1, 4).to(torch.bfloat16)
    seen = []
    real_put = pool.store.put

    def put(key, kk, vv):
        seen.append(peer.read_layer(key, 1)[0].clone())
        real_put(key, kk, vv)
        seen.append(peer.read_layer(key, 1)[0].clone())

    pool.store.put = put
    try:
        pool.put([11], k, k + 1)
        pool.put([12], k + 2, k + 3)    # evicts 11 from DRAM: a demotion
        assert len(seen) == 2
        for got in seen + [peer.read_layer(11, 1)[0]]:
            assert torch.equal(got.view(torch.int16), k[1].view(torch.int16))
        assert 11 not in pool.data and 11 in pool.store
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# the launcher's process lane and command line (its in-process lanes:
# tests/test_torch_cluster_lanes.py)
# ---------------------------------------------------------------------------

def test_processes_lane_bit_exact(tmp_path):
    """Two OS processes over the wire: each prefills its document, then
    answers a query extending the OTHER node's document through a socket
    fetch, bit-exact against the parent's single-process oracle."""
    cfg = get_config(ARCH).reduced()
    lines: list = []
    s = serve_cluster(cfg, "cpu", processes=2, max_new=4,
                      ssd_dir=str(tmp_path), log=lines.append)
    assert s["failures"] == 0, "\n".join(lines)
    for i in range(2):
        r = s["results"][i]
        assert r["bit_exact"] and r["tokens"] == s["oracle"][i]
        assert r["peer_blocks"] == 2 and not r["fallback"]
        assert r["server"]["frames_served"] == 2 * cfg.n_layers
        assert r["bw"]


def test_cli_refuses_mesh_and_flat_global_pool(capsys):
    # --mesh is ported: what stays refused is a mesh over the dense
    # substrate and a model axis with no grouped-GQA head layout
    with pytest.raises(SystemExit):
        cluster_main(["--mesh", "2x2", "--decode-substrate", "dense"])
    assert "--mesh shards the PAGED decode substrate" \
        in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cluster_main(["--mesh", "1x3"])
    assert "has no grouped-GQA head layout" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cluster_main(["--global-pool"])
    assert "--ssd-blocks" in capsys.readouterr().err
