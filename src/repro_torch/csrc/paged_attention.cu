// Paged decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py::paged_attention
// (_paged_kernel), the Pallas TPU kernel of one continuous-batching decode
// step, and covers what its dispatcher turned down (_kernel_ok): an
// explicit query-head -> KV-head map (qh2kv) and a sliding window.
// The second entry, paged_attention_layers_bf16, replaces
// kernel.py::paged_attention_layers (_paged_kernel_layers): the same
// attention for all L layers of a stacked (L, P, page, KV, D) store in one
// launch, one block table and one set of lengths shared by every layer.
// Both entries run the same kernels: the layer index rides the grid's x
// axis (x = layer·H + head), so layer l of a layers call does exactly the
// arithmetic of a per-layer call on layer l's slabs (a per-layer call is
// the L = 1 case).
//
// Computes, for every slot b and query head h:
//   o[b,h,:] = softmax_t( q[b,h,:]·k_t / sqrt(D) ) · v_t
// over the tokens t of slot b's paged KV, read through its block table,
// with t < min(seq_lens[b], max_pages*page) and, if window > 0,
// t >= seq_lens[b] - window. Pages past ceil(len/page) are never read;
// the null page 0 contributes nothing.
//
// What bounds it on an H100: memory. One decode token does ~4·D flops
// per (head, token) against 4·D bytes of K/V per (kv head, token), far
// below the ~295 flop/byte ridge. Least time = K/V bytes of the live
// spans / 3.35 TB/s — a few microseconds on the serving path, so latency
// (dependent loads, idle SMs, launches) is what a simple kernel loses to;
// the layers entry pays the launch latency once for L layers.
//
// Design: a split over tokens with a log-sum-exp combine, two passes per
// call. Pass 1 runs one block per (layer, query head, slot, 256-token split),
// 4 warps; empty splits exit at once. Each warp takes 32-token tiles:
// lane j loads token j's whole K row and V row with 16-byte vector loads
// (all independent, so a tile's loads are in flight together), computes
// its score, and parks its V row in shared memory; the warp then does an
// online-softmax update and accumulates P·V from shared memory, each lane
// owning D/32 output dims. The block writes its unnormalised (acc, max,
// sum) partial. Pass 2 runs one block per (layer, query head, slot) and combines
// the splits. Query heads sharing a KV head re-read it through L2 — the
// map is irregular (KV head 0 serves 4 of 16 heads at smollm-360m's full
// width), so no grouping is assumed. fp32 accumulation, bf16 out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSplitTokens = 256;  // tokens per pass-1 block (multiple of 32)

__device__ __forceinline__ void bf16x8_to_float(const uint4& raw, float* f) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(h2[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_partial(const __nv_bfloat16* __restrict__ q,        // (L,B,H,D)
                     const __nv_bfloat16* __restrict__ k_pages,  // (L,P,page,KV,D)
                     const __nv_bfloat16* __restrict__ v_pages,
                     const int* __restrict__ block_table,        // (B,max_pages)
                     const int* __restrict__ seq_lens,           // (B,)
                     const int* __restrict__ qh2kv,              // (H,)
                     float* __restrict__ part,  // (L,B,H,n_splits,D+2)
                     int H, int KV, int page, int max_pages, int window,
                     float scale, int n_splits, size_t kv_lstride) {
  constexpr int DPL = D / 32;  // output dims per lane
  const int layer = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  const int sp = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  q += (size_t)layer * B * H * D;
  k_pages += layer * kv_lstride;
  v_pages += layer * kv_lstride;
  part += (size_t)layer * B * H * n_splits * (D + 2);

  const int len = seq_lens[b];
  const int n_tok = min(len, max_pages * page);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int s_begin = max(sp * kSplitTokens, lo);
  const int s_end = min((sp + 1) * kSplitTokens, n_tok);
  float* out = part + (((size_t)b * H + h) * n_splits + sp) * (D + 2);
  if (s_begin >= s_end) {  // block-uniform: nothing live in this split
    if (threadIdx.x == 0) {
      out[D] = -INFINITY;
      out[D + 1] = 0.f;
    }
    return;
  }

  const int kvh = qh2kv[h];
  __shared__ float q_s[D];
  __shared__ __align__(16) __nv_bfloat16 v_s[kWarps][32][D];
  __shared__ float m_s[kWarps];
  __shared__ float l_s[kWarps];
  __shared__ float acc_s[kWarps][D];

  for (int d = threadIdx.x; d < D; d += kThreads)
    q_s[d] = __bfloat162float(q[((size_t)b * H + h) * D + d]);
  __syncthreads();

  const int* table = block_table + (size_t)b * max_pages;
  const size_t tok_stride = (size_t)KV * D;  // elements between tokens

  float m = -INFINITY;
  float l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int t0 = (s_begin & ~31) + warp * 32; t0 < s_end; t0 += kWarps * 32) {
    const int t = t0 + lane;
    const bool valid = t >= s_begin && t < s_end;
    float s = -INFINITY;
    uint4* vdst = reinterpret_cast<uint4*>(&v_s[warp][lane][0]);
    if (valid) {
      const int pid = table[t / page];
      const size_t row = ((size_t)pid * page + t % page) * tok_stride +
                         (size_t)kvh * D;
      const uint4* krow = reinterpret_cast<const uint4*>(k_pages + row);
      const uint4* vrow = reinterpret_cast<const uint4*>(v_pages + row);
      uint4 kr[D / 8];
      uint4 vr[D / 8];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) kr[c] = krow[c];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) vr[c] = vrow[c];
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        float kf[8];
        bf16x8_to_float(kr[c], kf);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(q_s[c * 8 + i], kf[i], dot);
      }
      s = dot * scale;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) vdst[c] = vr[c];
    } else {
#pragma unroll
      for (int c = 0; c < D / 8; ++c) vdst[c] = make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
    float tmax = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    if (tmax != -INFINITY) {  // warp-uniform
      const float m_new = fmaxf(m, tmax);
      const float alpha = __expf(m - m_new);  // m = -inf -> 0
      const float p = valid ? __expf(s - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const __nv_bfloat16* vj = &v_s[warp][j][lane * DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          acc[i] = fmaf(pj, __bfloat162float(vj[i]), acc[i]);
      }
      m = m_new;
    }
    __syncwarp();  // the next tile overwrites this warp's V rows
  }

  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc_s[warp][lane * DPL + i] = acc[i];
  __syncthreads();

  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (m_s[w] != -INFINITY) A += acc_s[w][d] * __expf(m_s[w] - M);
    out[d] = A;
  }
  if (threadIdx.x == 0) {
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (m_s[w] != -INFINITY) L += l_s[w] * __expf(m_s[w] - M);
    out[D] = M;
    out[D + 1] = L;
  }
}

template <int D>
__global__ void __launch_bounds__(D)
paged_decode_combine(const float* __restrict__ part,
                     __nv_bfloat16* __restrict__ out,  // (L,B,H,D)
                     int H, int n_splits) {
  const int layer = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  const int d = threadIdx.x;
  part += (size_t)layer * B * H * n_splits * (D + 2);
  out += (size_t)layer * B * H * D;
  const float* base = part + ((size_t)b * H + h) * n_splits * (D + 2);
  float M = -INFINITY;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, base[s * (D + 2) + D]);
  float L = 0.f, A = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < n_splits; ++s) {
      const float* p = base + s * (D + 2);
      if (p[D] == -INFINITY) continue;
      const float f = __expf(p[D] - M);
      L += p[D + 1] * f;
      A += p[d] * f;
    }
  }
  out[((size_t)b * H + h) * D + d] = __float2bfloat16(L > 0.f ? A / L : 0.f);
}

template <int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* seq_lens,
                   const void* qh2kv, void* part, void* out, int L, int B,
                   int H, int KV, int page, int max_pages, int window,
                   float scale, int n_splits, size_t kv_lstride,
                   cudaStream_t s) {
  paged_decode_partial<D><<<dim3(L * H, B, n_splits), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<const int*>(block_table), static_cast<const int*>(seq_lens),
      static_cast<const int*>(qh2kv), static_cast<float*>(part), H, KV, page,
      max_pages, window, scale, n_splits, kv_lstride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine<D><<<dim3(L * H, B), D, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), H,
      n_splits);
  return cudaGetLastError();
}

}  // namespace

// Tokens per pass-1 split; the caller sizes the partial buffer
// (L, B, H, n_splits, D + 2) fp32 with n_splits = ceil(max_pages*page / this).
extern "C" int paged_attention_split_tokens() { return kSplitTokens; }

namespace {

int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* block_table, const void* seq_lens, const void* qh2kv,
             void* part, void* out, int L, int B, int H, int KV, int D,
             int page, int max_pages, int n_pages, int window, float scale,
             int n_splits, void* stream) {
  if (L <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
  if ((long long)L * H > 0x7fffffffLL || B > 65535 || n_splits <= 0 ||
      n_splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t kv_lstride = (size_t)n_pages * page * KV * D;
  switch (D) {
    case 32:
      return (int)launch<32>(q, k_pages, v_pages, block_table, seq_lens,
                             qh2kv, part, out, L, B, H, KV, page, max_pages,
                             window, scale, n_splits, kv_lstride, s);
    case 64:
      return (int)launch<64>(q, k_pages, v_pages, block_table, seq_lens,
                             qh2kv, part, out, L, B, H, KV, page, max_pages,
                             window, scale, n_splits, kv_lstride, s);
    case 128:
      return (int)launch<128>(q, k_pages, v_pages, block_table, seq_lens,
                              qh2kv, part, out, L, B, H, KV, page, max_pages,
                              window, scale, n_splits, kv_lstride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One layer: q (B,H,D), pages (P,page,KV,D), out (B,H,D).
extern "C" int paged_attention_bf16(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const void* block_table,
                                    const void* seq_lens, const void* qh2kv,
                                    void* part, void* out, int B, int H,
                                    int KV, int D, int page, int max_pages,
                                    int window, float scale, int n_splits,
                                    void* stream) {
  return dispatch(q, k_pages, v_pages, block_table, seq_lens, qh2kv, part,
                  out, 1, B, H, KV, D, page, max_pages, 0, window, scale,
                  n_splits, stream);
}

// All L layers in one launch: qs (L,B,H,D), pages (L,P,page,KV,D), out
// (L,B,H,D); the block table, lengths and head map are shared.
extern "C" int paged_attention_layers_bf16(
    const void* qs, const void* k_pages, const void* v_pages,
    const void* block_table, const void* seq_lens, const void* qh2kv,
    void* part, void* out, int L, int B, int H, int KV, int D, int page,
    int max_pages, int n_pages, int window, float scale, int n_splits,
    void* stream) {
  return dispatch(qs, k_pages, v_pages, block_table, seq_lens, qh2kv, part,
                  out, L, B, H, KV, D, page, max_pages, n_pages, window,
                  scale, n_splits, stream);
}
