"""Messenger — the cross-machine KVCache transfer service (§3 step 3);
the port's own copy of the reference's ``core/messenger.py``.

One Messenger per instance; transfers are point-to-point (sender-node
egress is the contended resource, matching the paper's congestion concern
in §6.1: "whether the sending node is under congestion"). We model each
node's egress link as a FIFO pipe of bandwidth ``bw``; a transfer of B
bytes enqueued at time t on a link whose backlog drains at time t' ≥ t
completes at max(t, t') + B/bw.

This same object answers Conductor's ``EstimateKVCacheTransferTime`` —
the estimate includes the current backlog, which is how congestion feeds
back into Algorithm 1's instance selection and drives hot-spot
replication (§6.2).

Nodes with a tiered DRAM+SSD pool additionally register an *SSD channel*
(``add_ssd_channel``): a per-node FIFO pipe at NVMe read bandwidth that
serialises SSD→DRAM prefix loads. Its backlog feeds the Conductor's
estimate for the third TTFT arm (load-from-SSD), so a node whose SSD is
busy loading one long prefix correctly looks expensive for the next one.
A cross-node peer-SSD fetch (the global pool's fourth arm) composes two
pipes serially — the owner's SSD read channel, then the owner's egress
link — via ``estimate_peer_ssd``/``enqueue_peer_ssd``.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Link:
    bw: float                   # bytes/s
    busy_until: float = 0.0     # time the current backlog drains
    bytes_sent: float = 0.0
    n_transfers: int = 0


class Messenger:
    """Transfer-time bookkeeping for a set of named nodes."""

    def __init__(self, node_ids, bw: float) -> None:
        self.links: dict = {i: Link(bw=bw) for i in node_ids}
        self.ssd_links: dict = {}

    def add_node(self, node_id, bw: float) -> None:
        self.links[node_id] = Link(bw=bw)

    def add_ssd_channel(self, node_id, read_bw: float) -> None:
        """Register a node's local SSD read pipe (tiered pools only)."""
        self.ssd_links[node_id] = Link(bw=read_bw)

    def has_ssd_channel(self, node_id) -> bool:
        return node_id in self.ssd_links

    # shared FIFO-pipe math (egress and SSD channels are the same model)
    @staticmethod
    def _estimate(link: Link, nbytes: float, now: float) -> float:
        return max(link.busy_until - now, 0.0) + nbytes / link.bw

    @staticmethod
    def _commit(link: Link, nbytes: float, now: float) -> float:
        start = max(link.busy_until, now)
        done = start + nbytes / link.bw
        link.busy_until = done
        link.bytes_sent += nbytes
        link.n_transfers += 1
        return done

    def estimate(self, src, nbytes: float, now: float) -> float:
        """Predicted transfer duration if enqueued now (queue + wire)."""
        return self._estimate(self.links[src], nbytes, now)

    def enqueue(self, src, nbytes: float, now: float) -> float:
        """Commit a transfer; returns its completion TIME."""
        return self._commit(self.links[src], nbytes, now)

    def congestion(self, src, now: float) -> float:
        """Seconds of backlog on a node's egress link."""
        return max(self.links[src].busy_until - now, 0.0)

    # ---- local SSD tier (same FIFO-pipe model, per-node read channel) ----
    def estimate_ssd(self, node, nbytes: float, now: float) -> float:
        """Predicted SSD-load duration if enqueued now (queue + media)."""
        link = self.ssd_links.get(node)
        if link is None:
            return float("inf")     # node has no SSD tier
        return self._estimate(link, nbytes, now)

    def enqueue_ssd(self, node, nbytes: float, now: float) -> float:
        """Commit an SSD load; returns its completion TIME."""
        return self._commit(self.ssd_links[node], nbytes, now)

    def set_ssd_bw(self, node, read_bw: float) -> None:
        """Recalibrate a node's SSD read channel to a MEASURED bandwidth
        (the serving engine feeds ``SSDBlockStore``'s read EMA back so the
        Conductor's load-arm estimates track reality, not the spec sheet)."""
        link = self.ssd_links.get(node)
        if link is None:
            self.add_ssd_channel(node, read_bw)
        else:
            link.bw = read_bw

    def set_link_bw(self, node, bw: float) -> None:
        """Recalibrate a node's EGRESS link to a MEASURED bandwidth — the
        wire-protocol counterpart of ``set_ssd_bw``. A multi-process
        cluster feeds ``SocketPeer.bw_ema`` (payload bytes/s actually
        observed on FETCH_BLOCK reads off that node) back here, so the
        peer-fetch arms price the socket the cluster really has, not the
        construction-time constant."""
        link = self.links.get(node)
        if link is None:
            self.add_node(node, bw)
        else:
            link.bw = bw

    # ---- cross-node SSD fetch (global pool: peer SSD read + egress hop) ----
    def estimate_peer_ssd(self, node, nbytes: float, now: float) -> float:
        """Predicted duration of fetching bytes OFF a peer's SSD: the
        peer's SSD read channel drains first, then the peer's egress link
        carries the bytes — two FIFO pipes composed serially, each with
        its current backlog."""
        link = self.ssd_links.get(node)
        if link is None:
            return float("inf")     # peer has no SSD tier
        t_read = self._estimate(link, nbytes, now)
        net = self.links[node]
        t_net = max(net.busy_until - (now + t_read), 0.0) + nbytes / net.bw
        return t_read + t_net

    def enqueue_peer_ssd(self, node, nbytes: float, now: float) -> float:
        """Commit a peer-SSD fetch; returns its completion TIME."""
        done_read = self._commit(self.ssd_links[node], nbytes, now)
        return self._commit(self.links[node], nbytes, done_read)
