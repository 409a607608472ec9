"""Directory service over the wire protocol (the port's own copy of the
reference's ``serving/directory_service.py``): one process serves the
``GlobalBlockDirectory``, every other node caches it advisorily.

Until now the directory was one shared Python object — fine for the
in-process cluster, impossible across OS processes.  This module splits
it along the paper's Conductor/node boundary:

* ``DirectoryServer`` wraps a real ``GlobalBlockDirectory`` behind the
  CRC-framed transport (``PUBLISH``/``WITHDRAW``/``LOOKUP`` plus node
  membership: ``HELLO``, ``NODES``, a crash-tolerant ``BARRIER``).  A
  node's connection doubles as its liveness lease — when the socket of a
  HELLO'd node dies (including kill -9), the server ``drop_node``s every
  claim, so the directory self-heals exactly as it does in-process.
* ``RemoteDirectory`` duck-types the directory surface the serving
  engine consumes (``register``/``unregister``/``pick_owner``/
  ``holders``/``nodes_with``/``best_ssd_extension``/``bind``/``stats``)
  over a socket, with a small TTL'd positive-lookup cache.  The cache is
  *advisory* in precisely the directory's own sense: a stale hit is
  re-verified at fetch time by CRC and degrades to recompute, so serving
  correctness never depends on cache freshness.

Partition tolerance: when the directory service is unreachable, reads
answer "nobody holds it" (pick_owner → None — requests degrade to
recompute, the same path as any other fallback) and writes are dropped
and counted.  Nothing blocks the serving loop on a dead directory.

``python -m repro_torch.serving.directory_service`` runs a standalone
server and prints ``PORT <p>``.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Iterable, Optional

from repro_torch.core.directory import (GlobalBlockDirectory, bind_pool,
                                  select_owner)
from repro_torch.serving.transport import (MSG_BARRIER, MSG_ERR, MSG_HELLO,
                                     MSG_LOOKUP, MSG_NODES, MSG_OK,
                                     MSG_PUBLISH, MSG_STATS, MSG_WITHDRAW,
                                     FrameConn, FrameReader, PeerError,
                                     PeerUnreachable, _pack_json,
                                     _unpack_json, encode_frame)

_RECV_CHUNK = 1 << 16


class DirectoryServer:
    """Serve one ``GlobalBlockDirectory`` to a cluster of processes."""

    def __init__(self, directory: Optional[GlobalBlockDirectory] = None,
                 host: str = "127.0.0.1", port: int = 0, *,
                 barrier_timeout: float = 30.0) -> None:
        self.directory = directory if directory is not None \
            else GlobalBlockDirectory()
        self.barrier_timeout = barrier_timeout
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._conns: dict[int, socket.socket] = {}  #: guarded_by self._lock
        self._conn_node: dict[int, int] = {}        #: guarded_by self._lock
        #: guarded_by self._lock — node id -> (host, block port)
        self._endpoints: dict[int, tuple] = {}
        self._barriers: dict[str, int] = {}         #: guarded_by self._cond
        self._closed = False                        #: guarded_by self._lock
        self._next_conn = 0                         #: guarded_by self._lock
        self._threads: list[threading.Thread] = []  #: guarded_by self._lock
        self.n_drops = 0                            #: guarded_by self._lock
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
            name="repro-torch-dir-accept")
        self._accept_thread.start()

    @property
    def addr(self) -> tuple:
        return (self.host, self.port)

    def endpoints(self) -> dict:
        """node id -> (host, block port) of every HELLO'd node."""
        with self._lock:
            return dict(self._endpoints)

    # ---- server plumbing ----------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, peer = self._sock.accept()
            except OSError:
                return
            alive = self._adopt(conn, peer[0])
            if not alive:
                return

    def _adopt(self, conn: socket.socket, host: str) -> bool:
        """Take ownership of an accepted conn: register it and spawn its
        serve thread, or close it if the server already shut down."""
        with self._lock:
            if self._closed:
                conn.close()
                return False
            cid = self._next_conn
            self._next_conn += 1
            self._conns[cid] = conn
            t = threading.Thread(target=self._serve,
                                 args=(conn, cid, host), daemon=True,
                                 name=f"repro-torch-dir-serve-{cid}")
            self._threads.append(t)
        t.start()
        return True

    def _node_left(self, cid: int) -> None:
        """A HELLO'd node's connection died: revoke its claims."""
        with self._lock:
            node = self._conn_node.pop(cid, None)
            if node is None:
                return
            self._endpoints.pop(node, None)
            self.n_drops += 1
        self.directory.drop_node(node)

    def _handle(self, conn: socket.socket, cid: int, host: str,
                mtype: int, payload: bytes) -> None:
        d = self.directory
        if mtype == MSG_HELLO:
            req = _unpack_json(payload)
            node = int(req["node"])
            with self._lock:
                self._conn_node[cid] = node
                self._endpoints[node] = (req.get("host") or host,
                                         int(req.get("port", 0)))
            reply = dict(ok=True, node=node)
        elif mtype == MSG_PUBLISH:
            req = _unpack_json(payload)
            d.register(int(req["key"]), int(req["node"]), req["tier"])
            reply = dict(ok=True)
        elif mtype == MSG_WITHDRAW:
            req = _unpack_json(payload)
            removed = d.unregister(int(req["key"]), int(req["node"]))
            reply = dict(ok=True, removed=removed)
        elif mtype == MSG_LOOKUP:
            req = _unpack_json(payload)
            holders = d.holders(int(req["key"]))
            # node ids as list pairs: json would stringify dict keys
            reply = dict(holders=[[n, t] for n, t in sorted(holders.items())])
        elif mtype == MSG_NODES:
            with self._lock:
                nodes = [[n, h, p] for n, (h, p)
                         in sorted(self._endpoints.items())]
            reply = dict(nodes=nodes)
        elif mtype == MSG_BARRIER:
            req = _unpack_json(payload)
            reply = self._barrier(req["name"], int(req["n"]),
                                  float(req.get("timeout",
                                                self.barrier_timeout)))
        elif mtype == MSG_STATS:
            reply = dict(d.stats())
            with self._lock:
                reply.update(nodes=len(self._endpoints),
                             node_drops=self.n_drops)
        else:
            conn.sendall(encode_frame(MSG_ERR, _pack_json(
                dict(code="peer_fetch_failed",
                     msg=f"unknown directory request {mtype}"))))
            return
        conn.sendall(encode_frame(MSG_OK, _pack_json(reply)))

    def _barrier(self, name: str, n: int, timeout: float) -> dict:
        """Block until ``n`` arrivals at ``name`` or timeout; reports the
        arrival count either way so survivors of a crashed participant
        can proceed (crash tolerance over strictness)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._barriers[name] = self._barriers.get(name, 0) + 1
            self._cond.notify_all()
            while self._barriers.get(name, 0) < n and \
                    not self._closed:  # replint: ignore[guarded-by] -- self._cond wraps self._lock; 'with self._cond' holds that same lock
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(min(left, 0.1))
            arrived = self._barriers.get(name, 0)
        return dict(arrived=arrived, met=arrived >= n)

    def _serve(self, conn: socket.socket, cid: int, host: str) -> None:
        reader = FrameReader()
        try:
            conn.settimeout(None)       # a directory conn idles legally
            while True:
                data = conn.recv(_RECV_CHUNK)
                if not data:
                    return
                for mtype, payload in reader.feed(data):
                    self._handle(conn, cid, host, mtype, payload)
        except (OSError, PeerError):
            return
        finally:
            conn.close()
            self._node_left(cid)
            with self._lock:
                self._conns.pop(cid, None)
                self._cond.notify_all()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns.values())
            threads = list(self._threads)
            self._cond.notify_all()
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


class RemoteDirectory:
    """Socket client for a ``DirectoryServer``; duck-types the directory
    surface the serving engine uses, with an advisory TTL lookup cache."""

    def __init__(self, addr, *, node_id: Optional[int] = None,
                 block_port: int = 0, host: Optional[str] = None,
                 timeout: float = 5.0, cache_ttl: float = 2.0) -> None:
        self.addr = (addr[0], int(addr[1]))
        self.node_id = node_id
        self.timeout = timeout
        self.cache_ttl = cache_ttl
        self.barrier_default_timeout = 30.0
        self._lock = threading.Lock()
        self._conn: Optional[FrameConn] = None  #: guarded_by self._lock
        #: guarded_by self._lock — key -> (expiry, {node: tier})
        self._cache: dict[int, tuple] = {}
        self.n_errors = 0               #: guarded_by self._lock
        self.n_dropped_writes = 0       #: guarded_by self._lock
        self.n_cache_hits = 0           #: guarded_by self._lock
        self.n_lookups = 0              #: guarded_by self._lock
        if node_id is not None:
            # announce membership; the conn is our liveness lease
            self._call(MSG_HELLO, dict(node=node_id, port=block_port,
                                       host=host), required=True)

    # ---- rpc plumbing --------------------------------------------------
    def _call(self, mtype: int, obj, required: bool = False,
              rpc_timeout: Optional[float] = None):
        """One request/response; on socket failure returns None (callers
        treat the directory as partitioned) unless ``required``.
        ``rpc_timeout`` widens the read timeout for RPCs that legally
        block server-side (BARRIER)."""
        payload = _pack_json(obj if obj is not None else {})
        with self._lock:
            try:
                if self._conn is None:
                    try:
                        sock = socket.create_connection(
                            self.addr, timeout=self.timeout)
                    except OSError as e:
                        raise PeerUnreachable(
                            f"cannot connect to directory {self.addr}: {e}"
                        ) from None
                    self._conn = FrameConn(sock, timeout=self.timeout)
                    if self.node_id is not None and mtype != MSG_HELLO:
                        # re-HELLO after a reconnect: the lease follows
                        # the connection, not the process
                        self._conn.request(MSG_HELLO, _pack_json(
                            dict(node=self.node_id)))
                if rpc_timeout is not None:
                    self._conn.settimeout(rpc_timeout)
                try:
                    rtype, rpayload = self._conn.request(mtype, payload)
                finally:
                    if rpc_timeout is not None and self._conn is not None:
                        self._conn.settimeout(self.timeout)
            except PeerError as e:
                if self._conn is not None:
                    self._conn.close()
                    self._conn = None
                self.n_errors += 1
                if required:
                    raise PeerUnreachable(
                        f"directory service at {self.addr}: {e}") from None
                return None
            if rtype != MSG_OK:
                self.n_errors += 1
                return None
            return _unpack_json(rpayload)

    # ---- directory surface --------------------------------------------
    def register(self, key: int, node, tier: str) -> None:
        r = self._call(MSG_PUBLISH, dict(key=key, node=node, tier=tier))
        with self._lock:
            self._cache.pop(key, None)
            if r is None:
                self.n_dropped_writes += 1

    def unregister(self, key: int, node) -> bool:
        r = self._call(MSG_WITHDRAW, dict(key=key, node=node))
        with self._lock:
            self._cache.pop(key, None)
            if r is None:
                self.n_dropped_writes += 1
        return bool(r and r.get("removed"))

    def holders(self, key: int) -> dict:
        now = time.monotonic()
        with self._lock:
            self.n_lookups += 1
            hit = self._cache.get(key)
            if hit is not None and hit[0] > now:
                self.n_cache_hits += 1
                return dict(hit[1])
        r = self._call(MSG_LOOKUP, dict(key=key))
        if r is None:
            return {}                   # partitioned: nobody holds it
        holders = {int(n): t for n, t in r.get("holders", [])}
        if holders:                     # positive entries only: a miss
            with self._lock:            # now may be a publish in flight
                self._cache[key] = (now + self.cache_ttl, dict(holders))
        return holders

    def nodes_with(self, key: int, tier: Optional[str] = None) -> list:
        h = self.holders(key)
        return sorted(n for n, t in h.items() if tier is None or t == tier)

    def pick_owner(self, key: int, exclude: Iterable = (),
                   among: Optional[Iterable] = None):
        exclude = set(exclude)
        among = None if among is None else set(among)
        cands = [(n, t) for n, t in self.holders(key).items()
                 if n not in exclude and (among is None or n in among)]
        return select_owner(cands)

    def best_ssd_extension(self, hash_ids: list, start: int = 0,
                           exclude: Iterable = ()) -> tuple:
        """Same contract as ``GlobalBlockDirectory.best_ssd_extension``,
        built from (cached) per-key lookups."""
        if start >= len(hash_ids):
            return 0, None
        exclude = set(exclude)
        best_k, best_node = 0, None
        for node in self.nodes_with(hash_ids[start], tier="ssd"):
            if node in exclude:
                continue
            k = 0
            for h in hash_ids[start:]:
                if self.holders(h).get(node) != "ssd":
                    break
                k += 1
            if k > best_k:
                best_k, best_node = k, node
        return best_k, best_node

    def bind(self, node, pool) -> None:
        bind_pool(self, node, pool)

    # ---- membership ----------------------------------------------------
    def nodes(self) -> dict:
        """node id -> (host, block port) for every live node."""
        r = self._call(MSG_NODES, {})
        if r is None:
            return {}
        return {int(n): (h, int(p)) for n, h, p in r.get("nodes", [])}

    def barrier(self, name: str, n: int,
                timeout: Optional[float] = None) -> dict:
        """Crash-tolerant rendezvous: returns {arrived, met}."""
        t = self.barrier_default_timeout if timeout is None else timeout
        r = self._call(MSG_BARRIER, dict(name=name, n=n, timeout=t),
                       required=True, rpc_timeout=t + 10.0)
        return r if r is not None else dict(arrived=0, met=False)

    def stats(self) -> dict:
        r = self._call(MSG_STATS, {})
        with self._lock:
            local = dict(client_errors=self.n_errors,
                         dropped_writes=self.n_dropped_writes,
                         lookups=self.n_lookups,
                         cache_hits=self.n_cache_hits)
        if r is None:
            local["partitioned"] = True
            return local
        r.update(local)
        return r

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.directory_service",
        description="standalone directory service for a multi-process "
                    "serve_cluster run")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args(argv)

    server = DirectoryServer(host=args.host, port=args.port)
    print(f"PORT {server.port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
