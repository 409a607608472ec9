"""Cross-node KVCache transfer — the in-process half of the reference's
``serving/transport.py``: the error taxonomy shared by every transport,
and the two peer backends a node serves its blocks from.

Error taxonomy (the engine maps these to the ``fallback_reasons`` it
records; every failure degrades to recompute upstream, wrong bytes are
impossible by construction):

* ``PeerUnreachable`` — the node is gone (killed pool; over a wire, a
  dead process or a refused/reset connection). Reason ``peer_unreachable``.
* ``StaleDirectory`` — the node is alive but no longer holds the block
  (the advisory directory lagged). Reason ``stale_directory``.
* ``TornFrame`` — bytes arrived but failed integrity (the owner's own
  store rejected the slot's CRC). Reason ``verify_failed``.

``InProcPeer`` serves a sibling ``HostKVPool`` in this process;
``StorePeer`` serves a bare ``SSDBlockStore``. Not ported yet: the wire
itself — the ``MKW1`` frame codec, ``FrameConn``, ``BlockServer``,
``SocketPeer`` and the standalone block-node ``main`` (ROADMAP queue 1).
"""
from __future__ import annotations


class PeerError(Exception):
    """Base of the cross-node transfer taxonomy."""


class PeerUnreachable(PeerError):
    """The peer is gone — killed, or its connection refused, reset or
    timed out."""


class TornFrame(PeerError):
    """Bytes arrived but failed integrity (a CRC-rejected store slot)."""


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
