"""Analytic instance cost model (Figure 2) for the Conductor — the port's
own copy of the reference's ``core/costmodel.py``, with hardware defaults
that describe an H100 node.

The paper fits a predictive model of prefill/decode time from offline data
(§6.1: "Thanks to the regular computation pattern of Transformers, the error
bound of this prediction is small"). This model derives the same shape from
the architecture config and the accelerator's roofline terms, scaled by
achievable fractions that were measured on the card:

  * Prefill is compute-bound: quadratic attention + linear MLP FLOPs
    (Figure 2 left: superlinear in input length).
  * Decode is memory-bound: weights + KV bytes per iteration
    (Figure 2 right: sublinear in batch size — weight reads amortize).

The method bodies are the reference's, term for term, so a ``Hardware``
built from the reference's values prices every request identically
(``tests/test_torch_conductor.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import ssm_state_bytes


@dataclass(frozen=True)
class Hardware:
    """One accelerator of a serving node and the node's transfer paths.

    Defaults: one NVIDIA H100 SXM. Peaks are NVIDIA's data sheet (dense,
    no sparsity); the achievable fractions and the host-side rates were
    measured by ``chip_smoke.py`` (``calibrate``, phase 10; the SSD rates
    in phase 9) on an "NVIDIA H100 80GB HBM3, 700.00 W" card, and phase
    10 re-measures them on every run."""
    #: bf16 dense tensor-core peak, FLOP/s (data sheet)
    peak_flops: float = 989e12
    #: HBM3 bandwidth, bytes/s (data sheet)
    hbm_bw: float = 3.35e12
    #: NVLink 4 between the GPUs of a node: 900 GB/s total, 450e9 bytes/s
    #: in each direction (data sheet)
    ici_bw: float = 450e9
    #: host DRAM → HBM from pinned memory, bytes/s: 1 GiB in 22.09 ms
    #: (measured, median of three)
    dram_bw: float = 4.862e10
    #: inter-node KVCache transfer: the paper's 800 Gb/s RDMA per node
    #: (Mooncake §8.1), 100e9 bytes/s
    net_bw: float = 100e9
    #: SSD block store read, bytes/s: a 20,971,520-byte block read in
    #: 10.65 ms (chip_smoke.py phase 9)
    ssd_read_bw: float = 1.969e9
    #: SSD block store write-back, bytes/s: 230,688,304 bytes flushed in
    #: 338.6 ms (chip_smoke.py phase 9)
    ssd_write_bw: float = 6.813e8
    #: HBM per GPU, bytes (data sheet)
    hbm_bytes: float = 80e9
    #: fraction of ``peak_flops`` a bf16 ``torch.matmul`` reaches at a
    #: llama2-70b prefill GEMM under 8-way tensor parallelism
    #: (4096x8192 @ 8192x3584 in 0.3176 ms; measured, median of three)
    mfu_prefill: float = 0.7656
    #: fraction of ``hbm_bw`` a 1 GiB device-to-device copy reaches
    #: (read + write bytes, 0.7171 ms; measured, median of three)
    mbu_decode: float = 0.8939


H100 = Hardware()


@dataclass(frozen=True)
class InstanceSpec:
    """One serving instance: one 8-GPU node, the paper's instance size
    (§8.1: eight accelerators and 640 GB of device memory a node)."""
    n_chips: int = 8
    hw: Hardware = H100


class CostModel:
    """Per-architecture timing estimates, all in SECONDS."""

    def __init__(self, cfg: ModelConfig, inst: InstanceSpec = InstanceSpec()):
        self.cfg = cfg
        self.inst = inst
        self.n_params_active = cfg.active_param_count()
        self.kv_token_bytes = (2 * cfg.attention_layers * cfg.n_kv_heads
                               * cfg.head_dim * 2)  # bf16 K+V per token
        self.weight_bytes = self.n_params_active * 2  # bf16
        self._ssd_s_per_token = None   # measured override (calibrate_ssd_read)

    # ---- prefill (compute-bound, Figure 2 left) ----
    def prefill_flops(self, L: int, prefix: int = 0) -> float:
        """FLOPs to prefill positions [prefix, L) given a cached prefix.
        A full (or over-covering, block-rounded) prefix still recomputes
        the last position to produce the first-token logits."""
        prefix = min(max(prefix, 0), L - 1) if L > 0 else 0
        new = L - prefix
        lin = 2.0 * self.n_params_active * new
        # attention scores+values: 2 * 2 * H * Dh * sum_{i=prefix}^{L} i
        cfg = self.cfg
        quad = 0.0
        if cfg.attention_layers:
            tri = 0.5 * (L * L - prefix * prefix)
            win = cfg.sliding_window
            if win and L > win:
                tri = min(tri, float(new) * win)
            quad = 4.0 * cfg.attention_layers * cfg.n_heads * cfg.head_dim * tri
        return lin + quad

    def prefill_time(self, L: int, prefix: int = 0) -> float:
        hw, n = self.inst.hw, self.inst.n_chips
        return self.prefill_flops(L, prefix) / (n * hw.peak_flops
                                                * hw.mfu_prefill)

    # ---- decode (memory-bound, Figure 2 right) ----
    def decode_iter_time(self, batch: int, avg_ctx: float) -> float:
        """One continuous-batching iteration: every active request emits one
        token. Weights are read once (amortized over the batch); KV is read
        per request. The compute term assumes 30% of peak, as the
        reference does."""
        hw, n = self.inst.hw, self.inst.n_chips
        cfg = self.cfg
        ctx = avg_ctx
        if cfg.sliding_window:
            ctx = min(ctx, cfg.sliding_window)
        kv = batch * ctx * self.kv_token_bytes
        if cfg.kind == "ssm":
            kv = batch * ssm_state_bytes(cfg)
        bytes_read = self.weight_bytes + kv
        t_mem = bytes_read / (n * hw.hbm_bw * hw.mbu_decode)
        t_cmp = 2.0 * self.n_params_active * batch / (n * hw.peak_flops * 0.3)
        return max(t_mem, t_cmp)

    def decode_capacity_tokens(self, kv_frac: float = 0.8) -> float:
        """KV tokens that fit in the instance's free HBM after weights.

        ``kv_frac`` is the fraction of free HBM budgeted for KV: a dedicated
        decode node spends nearly all of it on KV (0.8); a coupled
        prefill+decode node must reserve prefill activation space (≈0.5) —
        exactly the VRAM asymmetry §5.2's layer-wise prefill exploits."""
        hw, n = self.inst.hw, self.inst.n_chips
        free = n * hw.hbm_bytes - self.weight_bytes
        if self.kv_token_bytes == 0:
            return float("inf")
        return max(free * kv_frac, 0.0) / self.kv_token_bytes

    # ---- transfers (Messenger) ----
    def kv_bytes(self, tokens: int) -> float:
        return tokens * self.kv_token_bytes

    def transfer_time(self, tokens: int, bw: float | None = None) -> float:
        bw = bw if bw is not None else self.inst.hw.net_bw
        return self.kv_bytes(tokens) / bw

    def dram_load_time(self, tokens: int) -> float:
        """Local DRAM→HBM load of a cached prefix."""
        return self.kv_bytes(tokens) / self.inst.hw.dram_bw

    def ssd_load_time(self, tokens: int) -> float:
        """Local SSD→DRAM/HBM load of a demoted prefix (the 'load' arm of
        the compute-vs-load decision). Prefers the MEASURED per-block read
        time when ``calibrate_ssd_read`` has fed one back."""
        if self._ssd_s_per_token is not None:
            return tokens * self._ssd_s_per_token
        return self.kv_bytes(tokens) / self.inst.hw.ssd_read_bw

    def calibrate_ssd_read(self, seconds_per_block: float,
                           block_tokens: int = 512) -> None:
        """Pin the SSD-load arm's price to a measured seconds-per-block
        (e.g. ``SSDBlockStore``'s read EMA); every later ``ssd_load_time``
        — and therefore every Conductor arm priced off it — uses the
        measured value instead of the configured bandwidth."""
        if seconds_per_block <= 0:
            raise ValueError("seconds_per_block must be positive")
        self._ssd_s_per_token = seconds_per_block / block_tokens

    @property
    def ssd_calibrated(self) -> bool:
        return self._ssd_s_per_token is not None

    def ssd_write_time(self, tokens: int) -> float:
        """Demotion write-back DRAM→SSD."""
        return self.kv_bytes(tokens) / self.inst.hw.ssd_write_bw

    def peer_ssd_load_time(self, tokens: int) -> float:
        """Cross-node prefix fetch off a PEER's SSD (the global pool's
        fourth arm): the peer's SSD read followed by the network hop.
        ``Messenger.estimate_peer_ssd`` is the backlog-aware version; this
        is the channel-free fallback price."""
        return self.ssd_load_time(tokens) + self.transfer_time(tokens)
