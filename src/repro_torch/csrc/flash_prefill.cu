// Chunked-prefill flash attention for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py::flash_prefill
// (_flash_kernel), the Pallas TPU kernel, and covers what the reference
// never sent to it on the serving path: a runtime q_offset (chunked
// extend), ragged Sq and Sk (no block-divisibility requirement), and an
// explicit query-head -> KV-head map (qh2kv) for padded GQA.
//
// Computes, for every batch row b, query i and query head h:
//   o[b,i,h,:] = softmax_j( q[b,i,h,:]·k[b,j,kvh,:] / sqrt(D) ) · v[b,j,kvh,:]
// over keys j <= q_offset + i (and q_offset + i - j < window if window > 0),
// j < Sk, kvh = qh2kv[h]. Keys past q_offset + Sq are never read: the
// extend cache is sized to the whole prompt and holds zeros there.
//
// What bounds it on an H100: on the serving path (Sq = 256 query rows
// against up to ~1.5k keys, D = 64) the work is ~4·D flops per (query,
// key, head) pair, well above the byte bound, so the least time is
// flops / 989 TFLOP/s (bf16 tensor cores).
//
// Design (FlashAttention-2 shape on mma.sync, not yet wgmma/TMA): one
// block per (64-query tile, query head, batch row), 4 warps of 16 query
// rows. Q stays in registers as mma A-fragments. 64-key K and V tiles are
// staged in shared memory (16-byte vector loads, zero-filled past Sk,
// rows padded by 16 bytes so fragment loads are bank-conflict free).
// Per tile each warp computes S = Q·Kᵀ with m16n8k16 bf16 mma into fp32,
// masks and scales it, does the online-softmax update in registers
// (row max and sum across the 4 lanes of a row by shuffles), packs P to
// bf16 A-fragments straight from the S accumulators, and accumulates
// O += P·V with V's B-fragments read by ldmatrix.trans. Tiles after a
// warp's last query position (causal) or before its window are skipped.
// Not yet done (later work): wgmma and TMA, a multi-stage load pipeline,
// and a split over keys for more blocks at small Sq.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;      // query rows per block (16 per warp)
constexpr int kBN = 64;      // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16x8 fp32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,  // (B,Sq,H,D)
                     const __nv_bfloat16* __restrict__ k,  // (B,Sk,KV,D)
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ qh2kv,        // (H,)
                     __nv_bfloat16* __restrict__ out,      // (B,Sq,H,D)
                     int Sq, int Sk, int H, int KV, int q_offset, int window,
                     float scale) {
  constexpr int KS = D / 16;     // k-steps over the head dim (S = Q·Kᵀ)
  constexpr int NT = D / 8;      // n-tiles over the head dim (O)
  constexpr int SNT = kBN / 8;   // n-tiles over the keys (S)
  constexpr int PKS = kBN / 16;  // k-steps over the keys (O += P·V)
  constexpr int LD = D + 8;      // padded shared-memory row

  __shared__ __align__(16) __nv_bfloat16 Ks[kBN][LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBN][LD];

  const int m0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int tig = lane & 3;  // thread in group
  const int kvh = qh2kv[h];
  const int row[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
  const int qpos[2] = {q_offset + row[0], q_offset + row[1]};

  // Q as A-fragments, loaded once
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = row[r & 1];
      const int col = kk * 16 + (r >> 1) * 8 + tig * 2;
      qa[kk][r] = rr < Sq ? *reinterpret_cast<const uint32_t*>(
                                q + (((size_t)b * Sq + rr) * H + h) * D + col)
                          : 0u;
    }
  }

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const int last_q = min(m0 + kBM, Sq) - 1;
  const int k_hi = min(Sk, q_offset + last_q + 1);  // exclusive
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_offset + m0 - window + 1);
  k_lo = (k_lo / kBN) * kBN;
  const int w_first = m0 + warp * 16;
  const int w_last = min(w_first + 15, Sq - 1);

  constexpr int kChunks = kBN * D / 8;  // 16-byte chunks per K (or V) tile
  for (int n0 = k_lo; n0 < k_hi; n0 += kBN) {
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int j = c / (D / 8);
      const int d8 = (c % (D / 8)) * 8;
      const int kp = n0 + j;
      uint4 kr = make_uint4(0, 0, 0, 0);
      uint4 vr = make_uint4(0, 0, 0, 0);
      if (kp < Sk) {
        const size_t off = (((size_t)b * Sk + kp) * KV + kvh) * D + d8;
        kr = *reinterpret_cast<const uint4*>(k + off);
        vr = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&Ks[j][d8]) = kr;
      *reinterpret_cast<uint4*>(&Vs[j][d8]) = vr;
    }
    __syncthreads();

    // warp-uniform: does any of this warp's rows see a key of the tile?
    const bool live = w_first <= w_last && n0 <= q_offset + w_last &&
                      (window == 0 ||
                       q_offset + w_first - (n0 + kBN - 1) < window);
    if (live) {
      float s[SNT][4];
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const __nv_bfloat16* kr = &Ks[nt * 8 + g][kk * 16 + tig * 2];
          mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                   *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kp = n0 + nt * 8 + tig * 2 + (e & 1);
          bool ok = row[r] < Sq && kp < Sk && kp <= qpos[r];
          if (window > 0) ok = ok && (qpos[r] - kp) < window;
          s[nt][e] = ok ? s[nt][e] * scale : -INFINITY;
          mx[r] = fmaxf(mx[r], s[nt][e]);
        }
      }
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
        const float alpha = __expf(m[r] - mu[r]);
        l[r] *= alpha;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          o[nt][2 * r] *= alpha;
          o[nt][2 * r + 1] *= alpha;
        }
        m[r] = m_new;
      }
      uint32_t pa[PKS][4];
#pragma unroll
      for (int nt = 0; nt < SNT; ++nt) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = __expf(s[nt][e] - mu[e >> 1]);  // masked: exp(-inf) = 0
          l[e >> 1] += p[e];
        }
        pa[nt / 2][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int j = 0; j < PKS; ++j) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, &Vs[j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                               [np * 16 + (lane >> 4) * 8]);
          mma_bf16(o[2 * np], pa[j], bv[0], bv[1]);
          mma_bf16(o[2 * np + 1], pa[j], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + (((size_t)b * Sq + row[r]) * H + h) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + tig * 2) =
          pack_bf16(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qh2kv, void* out, int B, int Sq, int Sk, int H,
                   int KV, int q_offset, int window, float scale,
                   cudaStream_t s) {
  dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_prefill_kernel<D><<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qh2kv),
      static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, q_offset, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  const void* qh2kv, void* out, int B, int Sq,
                                  int Sk, int H, int KV, int D, int q_offset,
                                  int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch<32>(q, k, v, qh2kv, out, B, Sq, Sk, H, KV, q_offset,
                             window, scale, s);
    case 64:
      return (int)launch<64>(q, k, v, qh2kv, out, B, Sq, Sk, H, KV, q_offset,
                             window, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, qh2kv, out, B, Sq, Sk, H, KV, q_offset,
                              window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
