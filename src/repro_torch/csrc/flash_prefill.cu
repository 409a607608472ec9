// Chunked-prefill flash attention for Hopper (sm_90a): TMA loads into a
// multi-stage shared-memory ring, wgmma for both products, and a split
// over keys with a log-sum-exp combine. Plain C interface for ctypes.
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
// j < Sk, kvh = qh2kv[h]. Keys past q_offset + Sq are never read: the key
// extent of the TMA tensor maps is min(Sk, q_offset + Sq), and the copy
// engine fills rows past it with zeros, which the causal mask then drops.
//
// What bounds it on an H100: on the serving path (Sq = 256 query rows at
// offset 1280 against 1536 keys, 16 query heads over 5 KV heads, D = 64)
// the work is 4·D flops per (query, key, head) pair, 1.48 GFLOP against
// 3.0 MB of traffic, so the least time is the flops over the H100 SXM's
// published 989 TFLOP/s (bf16 tensor cores), 1.5 µs. At that size the
// kernel is bound in practice by filling the card and by latency, not by
// the tensor cores.
//
// Design:
//  * Grid (query tile of 64 rows, query head, batch × key split). Each
//    query tile's key range (its window start, rounded down to a 64-key
//    tile, to min(Sk, q_offset + last row + 1)) is cut into n_splits runs
//    of whole 64-key tiles; the host picks n_splits so that at least two
//    blocks per SM are live. With one split the block normalises and
//    writes bf16; with more, pass 1 writes fp32 partials (o, m, l) and a
//    combine pass merges them by log-sum-exp. A split with no key for a
//    row leaves m = -inf and l = 0 there, and the combine weighs it 0.
//  * One producer warp (warp 4, one lane) loads Q once and keeps K/V
//    tiles in flight through a ring of kStages stages with TMA
//    (cp.async.bulk.tensor over the 4-D (B, S, heads, D) tensors, box of
//    64 rows x 1 head x one panel of D). Each stage has a "full" mbarrier
//    (the copy's transaction bytes) and an "empty" one (the 128 consumer
//    threads arrive when done), with phase parity flipping as the ring
//    wraps.
//  * One consumer warpgroup (warps 0-3, 16 query rows each) runs
//    S = Q·Kᵀ as wgmma.m64n64k16 with both operands K-major in shared
//    memory, the online softmax in registers on the accumulator layout
//    (masking before exp), and O += P·V as wgmma with P packed to bf16 in
//    registers (the accumulator layout of S is the A-fragment layout) and
//    V an MN-major (transposed) B operand from the ring.
//  * Panels and swizzle: D is cut into panels of 64 columns where 64
//    divides it (D = 64: one, D = 128: two) and of 32 columns otherwise
//    (D = 32: one, D = 96: three). Each panel is its own TMA box and its
//    own wgmma operand, so the global row stride (2·D bytes, a multiple
//    of 16 for every D taken) never enters shared memory. A 64-column
//    panel (128 B rows) uses the 128-byte swizzle in both the tensor map
//    and the wgmma descriptor, a 32-column panel (64 B rows) the 64-byte
//    one; a panel is a whole number of swizzle atoms (8 rows), so every
//    panel starts on an atom and the descriptors' start addresses differ
//    only by whole panels. At D = 96, Q·Kᵀ is six k16 steps over the
//    three panels, P·V one m64n32k16 wgmma per panel and key step, and
//    the O accumulator three 32-column panels (o[3][16]).
//  * The tensor-map encoder cuTensorMapEncodeTiled lives in libcuda, not
//    in the CUDA runtime; it is fetched at run time with
//    cudaGetDriverEntryPoint, so the library links only the runtime.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;      // query rows per block (16 per consumer warp)
constexpr int kBN = 64;      // keys per tile
constexpr int kStages = 3;   // K/V ring depth
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + one producer warp

template <int D>
struct Cfg {
  static constexpr int kPanel = D % 64 == 0 ? 64 : 32;     // columns a panel
  static constexpr int kPanels = D / kPanel;
  static_assert(kPanels * kPanel == D, "D must be a multiple of 32");
  static constexpr int kRowBytes = kPanel * 2;
  static constexpr int kPanelBytes = kBN * kRowBytes;      // one 64-row box
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // Q, K or V tile
  static constexpr int kSwizzleMode = kPanel == 32 ? 2 : 1;  // wgmma: 64B / 128B
  static constexpr int kSBO = 8 * kRowBytes;               // 8-row group
  static constexpr int kKSteps = kPanel / 16;              // k16 steps a panel
  // Q, then kStages K tiles, then kStages V tiles, then the barriers
  static constexpr int kOffK = kTileBytes;
  static constexpr int kOffV = kOffK + kStages * kTileBytes;
  static constexpr int kOffBar = kOffV + kStages * kTileBytes;
  static constexpr int kSmem = kOffBar + 8 * (2 * kStages + 1) + 1024;
};

// ---- shared-memory barriers and TMA ----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)mode << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders the compiler's use of accumulator registers after a wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define F8(b)                                                            \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),         \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64x64 fp32) (+)= A (64x16, K-major smem) · B (64x16, K-major smem)ᵀ
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64x64 fp32) += A (64x16 bf16, registers) · B (16x64, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64x32 fp32) += A (64x16 bf16, registers) · B (16x32, MN-major smem)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- pass 1 ------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const int* __restrict__ qh2kv,    // (H,)
                     __nv_bfloat16* __restrict__ out,  // (B,Sq,H,D)
                     float* __restrict__ part_o,       // (ns,B,H,Sq,D)
                     float* __restrict__ part_ml,      // (ns,B,H,Sq,2)
                     int B, int Sq, int Sk, int H, int q_offset, int window,
                     int n_splits, float scale) {
  using C = Cfg<D>;
  constexpr int kOP = C::kPanel / 2;  // O accumulator floats per panel
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + C::kOffK;
  const uint32_t s_v = s_q + C::kOffV;
  const uint32_t bar_full = s_q + C::kOffBar;          // kStages barriers
  const uint32_t bar_empty = bar_full + 8 * kStages;   // kStages barriers
  const uint32_t bar_q = bar_empty + 8 * kStages;

  const int m0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_splits;
  const int sp = blockIdx.z % n_splits;
  const int kvh = qh2kv[h];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // this split's run of key tiles (kernels/flash_prefill/ref.py split_tiles)
  const int last = min(m0 + kBM, Sq) - 1;
  const int k_hi = min(Sk, q_offset + last + 1);
  int k_lo = window > 0 ? max(0, q_offset + m0 - window + 1) : 0;
  k_lo = k_lo / kBN * kBN;
  const int n_all = k_hi > k_lo ? (k_hi - k_lo + kBN - 1) / kBN : 0;
  const int per = (n_all + n_splits - 1) / n_splits;
  const int t_first = min(n_all, sp * per);
  const int n_tiles = min(n_all, (sp + 1) * per) - t_first;
  const int k_first = k_lo + t_first * kBN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: one lane issues every copy ----
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, C::kTileBytes);
      for (int p = 0; p < C::kPanels; ++p)
        tma_load_4d(s_q + p * C::kPanelBytes, &tm_q, bar_q, p * C::kPanel, h,
                    m0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty + 8 * st, ((t / kStages) - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * C::kTileBytes);
        const int kpos = k_first + t * kBN;
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_4d(s_k + st * C::kTileBytes + p * C::kPanelBytes, &tm_k, full,
                      p * C::kPanel, kvh, kpos, b);
          tma_load_4d(s_v + st * C::kTileBytes + p * C::kPanelBytes, &tm_v, full,
                      p * C::kPanel, kvh, kpos, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int g = lane >> 2;   // row within the warp's 8-row group
  const int tq = lane & 3;   // column pair within an 8-column block
  const int row[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
  const int qpos[2] = {q_offset + row[0], q_offset + row[1]};

  float o[C::kPanels][kOP];
#pragma unroll
  for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < kOP; ++i) o[p][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    mbar_wait(bar_full + 8 * st, (t / kStages) & 1);
    const uint32_t kt = s_k + st * C::kTileBytes;
    const uint32_t vt = s_v + st * C::kTileBytes;

    // S = Q·Kᵀ over D in k16 steps, panel by panel
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk) {
        const uint32_t off = p * C::kPanelBytes + kk * 32;
        wgmma_ss_n64(s, make_desc(s_q + off, 16, C::kSBO, C::kSwizzleMode),
                     make_desc(kt + off, 16, C::kSBO, C::kSwizzleMode),
                     (p | kk) != 0);
      }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // mask (before exp), scale, online softmax on the accumulator layout:
    // s[i] is row row[(i >> 1) & 1], key n0 + 8 (i >> 2) + 2 tq + (i & 1)
    const int n0 = k_first + t * kBN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int kp = n0 + 8 * (i >> 2) + 2 * tq + (i & 1);
      bool ok = row[r] < Sq && kp < Sk && kp <= qpos[r];
      if (window > 0) ok = ok && (qpos[r] - kp) < window;
      s[i] = ok ? s[i] * scale : -INFINITY;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
      alpha[r] = __expf(m[r] - mu[r]);
      l[r] *= alpha[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
      for (int i = 0; i < kOP; ++i) o[p][i] *= alpha[(i >> 1) & 1];
    // P as bf16 A fragments: keys 16 kk .. 16 kk + 15 are S's 8-column
    // blocks 2 kk and 2 kk + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int i = 8 * kk + 2 * q4;
        const int r = q4 & 1;
        const float p0 = __expf(s[i] - mu[r]);  // masked: exp(-inf) = 0
        const float p1 = __expf(s[i + 1] - mu[r]);
        l[r] += p0 + p1;
        pa[kk][q4] = pack_bf16(p0, p1);
      }
    }

    // O += P·V, V MN-major from the ring, one wgmma per panel and k16 step
    wg_fence();
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv =
            make_desc(vt + p * C::kPanelBytes + kk * 16 * C::kRowBytes,
                      C::kPanelBytes, C::kSBO, C::kSwizzleMode);
        if constexpr (kOP == 32)
          wgmma_rs_n64(o[p], pa[kk], dv);
        else
          wgmma_rs_n32(o[p], pa[kk], dv);
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) fence_regs(o[p]);
    mbar_arrive(bar_empty + 8 * st);
  }

  // epilogue: o[p][i] is row row[(i >> 1) & 1], column
  // p * kPanel + 8 (i >> 2) + 2 tq + (i & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
    if (n_splits == 1) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      __nv_bfloat16* orow = out + (((size_t)b * Sq + row[r]) * H + h) * D;
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
        for (int j = 0; j < kOP / 4; ++j)
          *reinterpret_cast<uint32_t*>(orow + p * C::kPanel + 8 * j + 2 * tq) =
              pack_bf16(o[p][4 * j + 2 * r] * inv, o[p][4 * j + 2 * r + 1] * inv);
    } else {
      const size_t ri = (((size_t)sp * B + b) * H + h) * Sq + row[r];
      float* prow = part_o + ri * D;
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
        for (int j = 0; j < kOP / 4; ++j)
          *reinterpret_cast<float2*>(prow + p * C::kPanel + 8 * j + 2 * tq) =
              make_float2(o[p][4 * j + 2 * r], o[p][4 * j + 2 * r + 1]);
      if (tq == 0) {
        part_ml[2 * ri] = m[r];
        part_ml[2 * ri + 1] = l[r];
      }
    }
  }
}

// ---- pass 2: merge the splits by log-sum-exp --------------------------

template <int D>
__global__ void __launch_bounds__(D)
flash_prefill_combine(const float* __restrict__ part_o,
                      const float* __restrict__ part_ml,
                      __nv_bfloat16* __restrict__ out, int B, int Sq, int H,
                      int n_splits) {
  const int i = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d = threadIdx.x;
  const size_t split_rows = (size_t)B * H * Sq;
  const size_t ri = ((size_t)b * H + h) * Sq + i;
  float M = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    M = fmaxf(M, part_ml[2 * (s * split_rows + ri)]);
  float L = 0.f, A = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < n_splits; ++s) {
      const size_t rs = s * split_rows + ri;
      const float ms = part_ml[2 * rs];
      if (ms == -INFINITY) continue;  // no key of this split for the row
      const float f = __expf(ms - M);
      L += part_ml[2 * rs + 1] * f;
      A += part_o[rs * D + d] * f;
    }
  }
  out[(((size_t)b * Sq + i) * H + h) * D + d] =
      __float2bfloat16(L > 0.f ? A / L : 0.f);
}

// ---- host --------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 (n, rows, heads, D) tensor with `extent` rows visible (the
// rest read as zeros), in boxes of (64 rows, 1 head, one panel).
template <int D>
bool make_map(CUtensorMap* map, const void* base, int n, int rows,
              int extent, int heads) {
  using C = Cfg<D>;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)extent, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::kPanel, 1, (cuuint32_t)kBN, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             C::kPanel == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qh2kv, void* out, void* part_o, void* part_ml,
                   int B, int Sq, int Sk, int H, int KV, int q_offset,
                   int window, int n_splits, float scale, cudaStream_t s) {
  using C = Cfg<D>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int extent = max(1, min(Sk, q_offset + Sq));  // keys ever read
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, q, B, Sq, Sq, H) ||
      !make_map<D>(&tk, k, B, Sk, extent, KV) ||
      !make_map<D>(&tv, v, B, Sk, extent, KV))
    return cudaErrorInvalidValue;
  dim3 grid((Sq + kBM - 1) / kBM, H, B * n_splits);
  flash_prefill_kernel<D><<<grid, kThreads, C::kSmem, s>>>(
      tq, tk, tv, static_cast<const int*>(qh2kv),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), B, Sq, Sk, H, q_offset, window, n_splits,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  flash_prefill_combine<D><<<dim3(Sq, H, B), D, 0, s>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(out), B, Sq, H, n_splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  const void* qh2kv, void* out, void* part_o,
                                  void* part_ml, int B, int Sq, int Sk, int H,
                                  int KV, int D, int q_offset, int window,
                                  int n_splits, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return (int)cudaSuccess;
  if (Sk <= 0 || n_splits < 1 || H > 65535 || B * n_splits > 65535 ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch<32>(q, k, v, qh2kv, out, part_o, part_ml, B, Sq, Sk,
                             H, KV, q_offset, window, n_splits, scale, s);
    case 64:
      return (int)launch<64>(q, k, v, qh2kv, out, part_o, part_ml, B, Sq, Sk,
                             H, KV, q_offset, window, n_splits, scale, s);
    case 96:
      return (int)launch<96>(q, k, v, qh2kv, out, part_o, part_ml, B, Sq, Sk,
                             H, KV, q_offset, window, n_splits, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, qh2kv, out, part_o, part_ml, B, Sq, Sk,
                              H, KV, q_offset, window, n_splits, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
