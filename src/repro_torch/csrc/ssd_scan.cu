// Chunked SSD (Mamba2 state-space duality) scan for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::ssd_scan (_ssd_kernel),
// the Pallas TPU kernel, and computes what it computes, in fp32
// throughout. For one (batch b, head h), over chunks of l positions:
//   cum   = cumsum(dt·A) within the chunk
//   y_i   = Σ_{j≤i} (C_i·B_j) e^{cum_i−cum_j} (x_j·dt_j)      (intra-chunk)
//         + e^{cum_i} C_i · h_prev                            (incoming state)
//   h     = h_prev e^{cum_{l−1}} + Σ_j (x_j·dt_j)ᵀ B_j e^{cum_{l−1}−cum_j}
// x (b,s,h,p) bf16; dt (b,s,h) f32; A (h,) f32; B, C (b,s,n) bf16 (one
// group, shared by every head); h0 (b,h,p,n) f32 or null → y (b,s,h,p)
// f32, hT (b,h,p,n) f32. s % chunk == 0, chunk ≤ 256, n ≤ 128, n % 8 == 0.
//
// What bounds it on an H100: memory. At the serving call (b=1, s=512,
// h=80, p=64, n=128, chunk 256, with h0) it must move 21.4 MB (x, B, C,
// dt, h0 read once; y and hT written once in fp32) and do 2.03 GFLOP
// (C·Bᵀ once per chunk, shared by every head; per head the causal masked
// product with x·dt, the incoming-state term and the state update):
// 6.4 µs at 3.35 TB/s against 2.1 µs at 989 TFLOP/s bf16
// (chip_smoke.py's bound()). This kernel runs its products on the fp32
// CUDA cores and recomputes C·Bᵀ in every block (~8.8 GFLOP), so it sits
// far above that bound.
//
// Design (simple and right first):
//  * The TPU's sequential chunk axis (state carried in VMEM scratch)
//    becomes a loop over chunks inside one block; the block's slice of the
//    state stays in shared memory for the whole loop.
//  * Column p of y and row p of the state depend only on column p of x,
//    so the grid splits p into 16-column slices: grid (p/16, h, b), no
//    reduction across blocks (320 blocks at the serving call).
//  * The l×l score matrix (256 KB in fp32 at l = 256) is never held
//    whole: query rows go in 64-row tiles against 64-key tiles j ≤ i, as
//    in causal attention with the decay e^{cum_i−cum_j} in place of a
//    softmax. C and B tiles sit k-major in shared memory; each thread
//    computes a 4×4 patch of the scores with float4 reads.
//  * Masking comes before exp: above the diagonal cum_i − cum_j > 0 could
//    overflow, and inf·0 is NaN here, so exp is never evaluated there.
//  * Ragged chunks (any l ≤ 256, not only powers of two) and p not a
//    multiple of 16 are masked at the edges; padded positions carry dt = 0
//    and leave the state unchanged.
//  * Inputs are read in their (b,s,h,p) layout by strides: no transposed
//    copies. Each block recomputes C·Bᵀ for its chunk (B, C are shared by
//    all heads); tensor cores (mma.sync/wgmma), TMA and sharing C·Bᵀ across
//    heads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPB = 16;          // state columns (of p) per block
constexpr int kTile = 64;        // query / key rows per tile
constexpr int kMaxChunk = 256;
constexpr int kMaxN = 128;
constexpr int kSmStride = kTile + 4;  // score-tile row stride, float4-aligned

// shared-memory layout, in floats
constexpr int kOffCum = 0;
constexpr int kOffWend = kOffCum + kMaxChunk;
constexpr int kOffDt = kOffWend + kMaxChunk;
constexpr int kOffX = kOffDt + kMaxChunk;          // x·dt (chunk, kPB)
constexpr int kOffH = kOffX + kMaxChunk * kPB;     // state (n, kPB)
constexpr int kOffC = kOffH + kMaxN * kPB;         // C tile (n, kTile)
constexpr int kOffB = kOffC + kMaxN * kTile;       // B tile (n, kTile)
constexpr int kOffS = kOffB + kMaxN * kTile;       // scores (kTile, stride)
constexpr int kSmemFloats = kOffS + kTile * kSmStride;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ void bf16x8_to_float(const uint4& raw, float* f) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(h2[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// Rows r0 .. r0+kTile of a chunk's (rows, n) bf16 matrix (row stride n)
// into dst[k][row] fp32, k-major; rows at or past `valid` are zero.
__device__ __forceinline__ void load_tile_t(const __nv_bfloat16* __restrict__ src,
                                            float* dst, int r0, int valid,
                                            int n) {
  const int groups = n / 8;
  for (int idx = threadIdx.x; idx < kTile * groups; idx += kThreads) {
    const int rr = idx % kTile;
    const int g = idx / kTile;
    float f[8];
    if (rr < valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (size_t)(r0 + rr) * n + g * 8);
      bf16x8_to_float(raw, f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(g * 8 + e) * kTile + rr] = f[e];
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x,   // (b,s,h,p)
                const float* __restrict__ dt,          // (b,s,h)
                const float* __restrict__ A,           // (h,)
                const __nv_bfloat16* __restrict__ Bm,  // (b,s,n)
                const __nv_bfloat16* __restrict__ Cm,  // (b,s,n)
                const float* __restrict__ h0,          // (b,h,p,n) or null
                float* __restrict__ y,                 // (b,s,h,p)
                float* __restrict__ hT,                // (b,h,p,n)
                int S, int H, int P, int N, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* cum = smem + kOffCum;    // inclusive cumsum of dt·A in the chunk
  float* wend = smem + kOffWend;  // e^{cum_last − cum_j}, 0 past the chunk
  float* dts = smem + kOffDt;
  float* xdt = smem + kOffX;
  float* hs = smem + kOffH;
  float* Ct = smem + kOffC;
  float* Bt = smem + kOffB;
  float* Sm = smem + kOffS;

  const int p0 = blockIdx.x * kPB;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int pc = tid % kPB;   // this thread's state column (y / state)
  const int rg = tid / kPB;   // its row group (0..15)
  const int ty = tid / 16;    // score patch row  (rows 4ty .. 4ty+3)
  const int tx = tid % 16;    // score patch col  (cols 4tx .. 4tx+3)
  const float a_h = A[hh];

  for (int idx = tid; idx < N * kPB; idx += kThreads) {
    const int k = idx % N;
    const int c = idx / N;
    const int p = p0 + c;
    hs[k * kPB + c] = (h0 != nullptr && p < P)
                          ? h0[(((size_t)b * H + hh) * P + p) * N + k]
                          : 0.f;
  }

  const int n_chunks = S / chunk;
  const int rows_pad = (chunk + kTile - 1) / kTile * kTile;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const int t0 = ic * chunk;
    const __nv_bfloat16* Bc = Bm + ((size_t)b * S + t0) * N;
    const __nv_bfloat16* Cc = Cm + ((size_t)b * S + t0) * N;
    __syncthreads();  // the previous chunk is done with every buffer

    // dt, and the inclusive cumsum of dt·A (one warp, 8 positions a lane)
    if (tid < 32) {
      constexpr int kPer = kMaxChunk / 32;
      float local[kPer];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int i = tid * kPer + e;
        float v = 0.f;
        if (i < chunk) {
          v = dt[((size_t)b * S + t0 + i) * H + hh];
          dts[i] = v;
          v *= a_h;
        }
        run += v;
        local[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += up;
      }
      const float excl = incl - run;
#pragma unroll
      for (int e = 0; e < kPer; ++e) cum[tid * kPer + e] = excl + local[e];
    }
    // x·dt for this block's columns; rows past the chunk (up to the tile
    // edge) are zero so a masked score never meets stale values
    __syncthreads();
    for (int idx = tid; idx < rows_pad * kPB; idx += kThreads) {
      const int i = idx / kPB;
      const int c = idx % kPB;
      const int p = p0 + c;
      float v = 0.f;
      if (i < chunk && p < P)
        v = __bfloat162float(x[(((size_t)b * S + t0 + i) * H + hh) * P + p]) *
            dts[i];
      xdt[i * kPB + c] = v;
    }
    const float cum_last = cum[chunk - 1];
    for (int i = tid; i < kMaxChunk; i += kThreads)
      wend[i] = i < chunk ? expf(cum_last - cum[i]) : 0.f;
    __syncthreads();

    // ---- outputs, one 64-row query tile at a time ----
    for (int i0 = 0; i0 < chunk; i0 += kTile) {
      load_tile_t(Cc, Ct, i0, chunk - i0, N);
      __syncthreads();

      // incoming state: y_i = e^{cum_i} C_i · h_prev[:, col]
      float yacc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < N; ++k) {
        const float hv = hs[k * kPB + pc];
        const float4 c4 = *reinterpret_cast<const float4*>(&Ct[k * kTile + rg * 4]);
        yacc[0] = fmaf(c4.x, hv, yacc[0]);
        yacc[1] = fmaf(c4.y, hv, yacc[1]);
        yacc[2] = fmaf(c4.z, hv, yacc[2]);
        yacc[3] = fmaf(c4.w, hv, yacc[3]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + rg * 4 + a;
        yacc[a] = i < chunk ? yacc[a] * expf(cum[i]) : 0.f;
      }

      // intra-chunk: key tiles j0 ≤ i0
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        load_tile_t(Bc, Bt, j0, chunk - j0, N);
        __syncthreads();
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          const float4 c4 = *reinterpret_cast<const float4*>(&Ct[k * kTile + ty * 4]);
          const float4 b4 = *reinterpret_cast<const float4*>(&Bt[k * kTile + tx * 4]);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty * 4 + a;
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx * 4 + c;
            // mask first: exp only where j ≤ i (its argument is ≤ 0 there)
            v[c] = (i < chunk && j <= i) ? acc[a][c] * expf(cum[i] - cum[j])
                                         : 0.f;
          }
          *reinterpret_cast<float4*>(&Sm[(ty * 4 + a) * kSmStride + tx * 4]) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
        __syncthreads();
        for (int cc = 0; cc < kTile; cc += 4) {
          float xv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[e] = xdt[(j0 + cc + e) * kPB + pc];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float4 s4 =
                *reinterpret_cast<const float4*>(&Sm[(rg * 4 + a) * kSmStride + cc]);
            yacc[a] = fmaf(s4.x, xv[0], yacc[a]);
            yacc[a] = fmaf(s4.y, xv[1], yacc[a]);
            yacc[a] = fmaf(s4.z, xv[2], yacc[a]);
            yacc[a] = fmaf(s4.w, xv[3], yacc[a]);
          }
        }
        __syncthreads();  // Bt, Sm (and after the last tile Ct) are reused
      }
      const int p = p0 + pc;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + rg * 4 + a;
        if (i < chunk && p < P)
          y[(((size_t)b * S + t0 + i) * H + hh) * P + p] = yacc[a];
      }
    }

    // ---- state update: h = h_prev e^{cum_last} + Σ_j x·dt_j B_j w_j ----
    const float dec = expf(cum_last);
    float hn[kMaxN / 16];
#pragma unroll
    for (int a = 0; a < kMaxN / 16; ++a) {
      const int k = rg + 16 * a;
      hn[a] = k < N ? hs[k * kPB + pc] * dec : 0.f;
    }
    for (int j0 = 0; j0 < chunk; j0 += kTile) {
      __syncthreads();
      load_tile_t(Bc, Bt, j0, chunk - j0, N);
      __syncthreads();
      const int jn = min(kTile, chunk - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float xw = xdt[(j0 + jj) * kPB + pc] * wend[j0 + jj];
#pragma unroll
        for (int a = 0; a < kMaxN / 16; ++a) {
          const int k = rg + 16 * a;
          if (k < N) hn[a] = fmaf(Bt[k * kTile + jj], xw, hn[a]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kMaxN / 16; ++a) {
      const int k = rg + 16 * a;
      if (k < N) hs[k * kPB + pc] = hn[a];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < N * kPB; idx += kThreads) {
    const int k = idx % N;
    const int c = idx / N;
    const int p = p0 + c;
    if (p < P) hT[(((size_t)b * H + hh) * P + p) * N + k] = hs[k * kPB + c];
  }
}

}  // namespace

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* h0,
                             void* y, void* hT, int b, int S, int H, int P,
                             int N, int chunk, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || chunk > kMaxChunk || S % chunk != 0 || N <= 0 ||
      N > kMaxN || N % 8 != 0 || H > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((P + kPB - 1) / kPB, H, b);
  ssd_scan_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hT), S, H, P, N, chunk);
  return (int)cudaGetLastError();
}
