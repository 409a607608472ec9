"""The plain reference: a dense decoder (RMSNorm, rotate-half RoPE,
causal grouped-query attention, optional per-head q/k RMSNorm, SwiGLU
MLP, untied unembedding) in plain PyTorch, over a whole sequence at
once. It imports nothing of the program under test.

It is the dense family's reference (``bench/families/dense.py``). It
reads that family's weights and takes the published model out of them
itself: the first ``heads`` query heads of ``wq``/``wo`` and the first
``vocab`` rows of the vocabulary. Weights and
the inputs of every matrix product are bf16 (the configurations'
precision) with fp32 accumulation; the residual stream, the norms, RoPE,
the attention scores, softmax and PV, and the logits are fp32, with TF32
and reduced-precision reductions off.

``precision="fp8"`` is the control: every weight matrix (embedding and
unembedding too) and every product's input rounded to float8 e4m3 with
a scale per output channel and per token, the nearest precision below
bf16 that a serving stack would switch to.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
Q_BLOCK = 512          # query rows per attention block


@contextlib.contextmanager
def exact_matmuls():
    """TF32 and reduced-precision bf16 reductions off for the block."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
             m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_tf32, torch.backends.cudnn.allow_tf32,
         m.allow_bf16_reduced_precision_reduction) = saved


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one scale per slice along ``dim``
    (amax / 448), back in bf16."""
    amax = t.abs().float().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn)
    return (q.float() * scale).to(torch.bfloat16)


class PlainModel:
    """``arch``: the published sizes (``layers``, ``d_model``, ``heads``,
    ``kv_heads``, ``head_dim``, ``d_ff``, ``vocab``) and ``rms_eps``,
    ``rope_theta``, ``qk_norm``."""

    def __init__(self, params: dict, arch: dict, precision: str = "bf16"):
        if precision not in ("bf16", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.p = params
        self.a = arch
        self.fp8 = precision == "fp8"

    # ---- primitives ------------------------------------------------------
    def _w(self, w: torch.Tensor) -> torch.Tensor:
        return fp8_round(w, 0) if self.fp8 else w

    def _lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """bf16 product of x (S, K) and w (K, N), fp32 out."""
        x = x.to(torch.bfloat16)
        if self.fp8:
            x = fp8_round(x, -1)
        return (x @ self._w(w)).float()

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = x.float()
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.a["rms_eps"])
        return x * w.float()

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (S, h, Dh) fp32; rotate-half RoPE at positions ``pos``."""
        Dh = x.shape[-1]
        inv = 1.0 / (self.a["rope_theta"] ** (
            torch.arange(0, Dh, 2, dtype=torch.float32, device=x.device) / Dh))
        ang = pos.float()[:, None] * inv[None, :]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, q, k, v) -> torch.Tensor:
        """Causal GQA: q (S, H, Dh), k/v (S, KV, Dh) fp32 → (S, H·Dh)."""
        S, H, Dh = q.shape
        KV = k.shape[1]
        g = H // KV
        scale = Dh ** -0.5
        out = torch.empty(S, H, Dh, dtype=torch.float32, device=q.device)
        for lo in range(0, S, Q_BLOCK):
            hi = min(lo + Q_BLOCK, S)
            qb = q[lo:hi].reshape(hi - lo, KV, g, Dh)
            s = torch.einsum("qkgd,skd->kgqs", qb, k[:hi]) * scale
            qpos = torch.arange(lo, hi, device=q.device)
            kpos = torch.arange(hi, device=q.device)
            s.masked_fill_(kpos[None, :] > qpos[:, None], float("-inf"))
            pr = torch.softmax(s, dim=-1)
            out[lo:hi] = torch.einsum("kgqs,skd->qkgd", pr, v[:hi]) \
                .reshape(hi - lo, H, Dh)
        return out.reshape(S, H * Dh)

    # ---- the model ---------------------------------------------------------
    def logits(self, tokens: torch.Tensor, first: int) -> torch.Tensor:
        """fp32 logits (S - first, vocab) at positions [first, S) of one
        sequence ``tokens`` (S,)."""
        a, p = self.a, self.p
        H, KV, Dh, V = a["heads"], a["kv_heads"], a["head_dim"], a["vocab"]
        with exact_matmuls(), torch.no_grad():
            tokens = tokens.to(p["embed"].device).long()
            S = tokens.shape[0]
            pos = torch.arange(S, device=tokens.device)
            x = self._w(p["embed"][:V])[tokens].float()
            at, ml = p["attn"], p["mlp"]
            for l in range(a["layers"]):
                h = self._norm(x, at["ln"][l])
                q = self._lin(h, at["wq"][l][:, :H * Dh]).view(S, H, Dh)
                k = self._lin(h, at["wk"][l]).view(S, KV, Dh)
                v = self._lin(h, at["wv"][l]).view(S, KV, Dh)
                if a["qk_norm"]:
                    q = self._norm(q, at["q_norm"][l])
                    k = self._norm(k, at["k_norm"][l])
                o = self._attention(self._rope(q, pos), self._rope(k, pos), v)
                x = x + self._lin(o, at["wo"][l][:H * Dh])
                h = self._norm(x, ml["ln"][l])
                gate = self._lin(h, ml["w1"][l])
                up = self._lin(h, ml["w3"][l])
                x = x + self._lin(torch.nn.functional.silu(gate) * up,
                                  ml["w2"][l])
            h = self._norm(x[first:], p["final_ln"])
            if self.fp8:
                return self._lin(h, p["lm_head"][:, :V])
            return h @ p["lm_head"][:, :V].float()
