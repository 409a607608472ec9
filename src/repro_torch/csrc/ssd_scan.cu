// Chunked SSD (Mamba2 state-space duality) scan for Hopper (sm_90a) as
// four chunk-parallel passes on the tensor cores, plain C interface for
// ctypes.
//
// Replaces: src/repro/kernels/ssd_scan/kernel.py::ssd_scan (_ssd_kernel),
// the Pallas TPU kernel, and computes what it computes. For one (batch b,
// head h), over chunks of l positions:
//   cum   = cumsum(dt·A) within the chunk
//   y_i   = Σ_{j≤i} (C_i·B_j) e^{cum_i−cum_j} (x_j·dt_j)      (intra-chunk)
//         + e^{cum_i} C_i · h_in                              (incoming state)
//   h     = h_in e^{cum_{l−1}} + Σ_j (x_j·dt_j e^{cum_{l−1}−cum_j})ᵀ B_j
// x (b,s,h,p) bf16; dt (b,s,h) f32; A (h,) f32; B, C (b,s,n) bf16 (one
// group, shared by every head); h0 (b,h,p,n) f32 or null → y (b,s,h,p)
// f32, hT (b,h,p,n) f32. s % chunk == 0, chunk ≤ 256, n ≤ 128, n % 8 == 0,
// p % 8 == 0. x, B and C are read through their row strides (views into
// the conv output need no copy); their rows must be 16-byte aligned.
//
// What bounds it on an H100: memory. At the serving call (b=1, s=512,
// h=80, p=64, n=128, chunk 256, with h0) it must move 21.4 MB (x, B, C,
// dt, h0 read once; y and hT written once in fp32) and do 2.03 GFLOP:
// 6.4 µs at the H100 SXM's published 3.35 TB/s against 2.1 µs at its
// 989 TFLOP/s bf16 (chip_smoke.py's bound()). The scratch (C·Bᵀ, cum,
// per-chunk states and incoming states, ~11 MB at that call) stays in the
// 50 MB L2 between passes.
//
// Design: the TPU kernel's sequential chunk axis becomes four passes, each
// parallel over chunks (kernels/ssd_scan/ref.py has each as plain PyTorch):
//  1. cb: C·Bᵀ once per (batch, chunk), as lower-triangular 64×64 tiles,
//     on bf16 mma.sync (B and C are bf16 inputs: exact products, fp32 sums).
//     Every head shares it.
//  2. chunk_state, one block per (chunk, head, 64 columns of p, 64 of n):
//     the warp scan of dt·A (cum, kept for passes 3 and 4) and
//     S_c = (x·dt·e^{cum_last − cum})ᵀ·B over 64-row slabs of the chunk.
//  3. state_pass, one thread per state element: h_in[c] = h; h = h·
//     e^{cum_last,c} + S_c over the chunks in order; writes h_in and hT.
//  4. chunk_scan, one block per (64 query rows, chunk, head, 64 columns of
//     p): e^{cum_i} C·h_inᵀ, then Σ_{j≤i} (CB ∘ e^{cum_i − cum_j} dt_j) x
//     over the key tiles up to the diagonal. Masking comes before exp:
//     above the diagonal cum_i − cum_j > 0 could overflow, and inf·0 is NaN.
// Precision: every product has one bf16 input operand (B, C or x), exact
// in bf16. The other factor, where it carries an fp32 decay, dt or state
// (x·dt·decay in pass 2, h_in in pass 4, CB·decay·dt in pass 4), is split
// into two bf16 terms hi + lo, and both go through the tensor cores: each
// product then keeps 16 bits of that factor's mantissa (relative error
// ≤ 2^-17 per product, finer than TF32's 2^-11). cum is summed and kept
// in fp64 (the scratch is fp64): the decays are exponentials of
// differences of nearby prefix sums that reach |cum| ~ 10^3, where fp32
// sums lose ~10^-4 of the exponent, more than all the products together;
// pass 4 forms each exponent from fp32 offsets to an fp64 origin per warp.
// The kernel is then closer to exact than the fp32 plain version, and the
// two differ by little more than the plain version's own rounding.
// Ragged chunks (any l ≤ 256) and padded n are zero-filled in shared
// memory; padded positions carry dt = 0 and leave the state unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 256;
constexpr int kMaxN = 128;
constexpr int kT = 64;              // rows of a tile (queries, keys, slab)
constexpr int kPT = 64;             // columns of p a block covers
constexpr int kNT = 64;             // columns of n a chunk_state block covers
constexpr int kLdN = kMaxN + 8;     // padded bf16 row of n (ldmatrix banks)
constexpr int kLdP = kPT + 8;       // padded bf16 row of p

// ---- tensor-core helpers -------------------------------------------------

// c (16x8 fp32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(uint32_t* r, const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// v = hi + lo with hi = bf16(v), lo = bf16(v − hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// A fragment (16 rows x 16 k) of a row-major bf16 tile: rows r0.., k k0..
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* s,
                                       int ld, int r0, int k0, int lane) {
  ldsm4(a, s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 +
               (lane >> 4) * 8);
}
// A fragment (16 m x 16 k) of a tile stored k-major as s[k][m]
__device__ __forceinline__ void frag_a_t(uint32_t* a, const __nv_bfloat16* s,
                                         int ld, int m0, int k0, int lane) {
  ldsm4_t(a, s + (k0 + (lane >> 4) * 8 + (lane & 7)) * ld + m0 +
                 ((lane >> 3) & 1) * 8);
}
// B fragments of two 8-column blocks (n0.., n0+8..) x 16 k of a tile
// stored n-major as s[n][k]: b[0..1] for block n0, b[2..3] for n0+8
__device__ __forceinline__ void frag_b(uint32_t* b, const __nv_bfloat16* s,
                                       int ld, int n0, int k0, int lane) {
  ldsm4(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
               ((lane >> 3) & 1) * 8);
}
// the same from a tile stored k-major as s[k][n]
__device__ __forceinline__ void frag_b_t(uint32_t* b, const __nv_bfloat16* s,
                                         int ld, int n0, int k0, int lane) {
  ldsm4_t(b, s + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0 +
                 (lane >> 4) * 8);
}

// Asynchronous copies global -> shared (cp.async): a thread issues all of
// its copies of a tile before waiting once, so their latencies overlap.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [r0, r0 + kT) of a (rows, n) bf16 matrix with row stride `ld_src`
// into dst[r][0..np) (row stride kLdN); rows ≥ valid and columns ≥ n zero.
// Asynchronous: cp_async_wait() and a barrier before use.
__device__ __forceinline__ void load_rows_n(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            long ld_src, int valid, int n,
                                            int np, int tid, int nthreads) {
  const int groups = np / 8;
  for (int idx = tid; idx < kT * groups; idx += nthreads) {
    const int r = idx / groups;
    const int c = (idx % groups) * 8;
    if (r < valid && c < n)
      cp_async16(dst + r * kLdN + c, src + (long)r * ld_src + c);
    else
      *reinterpret_cast<uint4*>(dst + r * kLdN + c) = make_uint4(0, 0, 0, 0);
  }
}

// ---- pass 1: C·Bᵀ per (batch, chunk), lower-triangular 64x64 tiles ------

__global__ void __launch_bounds__(128)
ssd_cb_kernel(const __nv_bfloat16* __restrict__ Bm,
              const __nv_bfloat16* __restrict__ Cm, float* __restrict__ cb,
              int S, int N, int chunk, long b_bs, long b_ss, long c_bs,
              long c_ss, int n_tri) {
  __shared__ __align__(16) __nv_bfloat16 Cs[kT * kLdN];
  __shared__ __align__(16) __nv_bfloat16 Bs[kT * kLdN];
  const int tile = blockIdx.x % n_tri;
  const int ic = blockIdx.x / n_tri;
  const int b = blockIdx.y;
  const int n_chunks = S / chunk;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int tj = tile - ti * (ti + 1) / 2;
  const int i0 = ti * kT, j0 = tj * kT;
  const int t0 = ic * chunk;
  const int np = (N + 15) / 16 * 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_rows_n(Cs, Cm + b * c_bs + (long)(t0 + i0) * c_ss, c_ss, chunk - i0, N,
              np, tid, 128);
  load_rows_n(Bs, Bm + b * b_bs + (long)(t0 + j0) * b_ss, b_ss, chunk - j0, N,
              np, tid, 128);
  cp_async_wait();
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  for (int k0 = 0; k0 < np; k0 += 16) {
    uint32_t a[4];
    frag_a(a, Cs, kLdN, warp * 16, k0, lane);
#pragma unroll
    for (int pr = 0; pr < 4; ++pr) {
      uint32_t bb[4];
      frag_b(bb, Bs, kLdN, pr * 16, k0, lane);
      mma(acc[2 * pr], a, bb[0], bb[1]);
      mma(acc[2 * pr + 1], a, bb[2], bb[3]);
    }
  }
  const int g = lane >> 2, tq = lane & 3;
  float* out = cb + ((long)b * n_chunks + ic) * chunk * chunk;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + warp * 16 + g + 8 * (e >> 1);
      const int j = j0 + nb * 8 + 2 * tq + (e & 1);
      if (i < chunk && j < chunk) out[(long)i * chunk + j] = acc[nb][e];
    }
}

// ---- pass 2: cum and each chunk's own state ------------------------------

__global__ void __launch_bounds__(128)
ssd_state_kernel(const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const __nv_bfloat16* __restrict__ Bm,
                 double* __restrict__ cum_g,  // (b,h,c,l)
                 float* __restrict__ states,  // (b,c,h,p,n)
                 int S, int H, int P, int N, int chunk, long x_bs, long x_ss,
                 long b_bs, long b_ss) {
  __shared__ __align__(16) __nv_bfloat16 Xh[kT * kLdP];
  __shared__ __align__(16) __nv_bfloat16 Xl[kT * kLdP];
  __shared__ __align__(16) __nv_bfloat16 Bs[kT * kLdN];
  __shared__ double cum[kMaxChunk];
  __shared__ float w[kMaxChunk];
  const int n_chunks = S / chunk;
  const int ic = blockIdx.x / H;
  const int hh = blockIdx.x % H;
  const int b = blockIdx.y;
  const int n_nb = (N + kNT - 1) / kNT;
  const int p0 = blockIdx.z / n_nb * kPT;
  const int n0 = blockIdx.z % n_nb * kNT;
  const int pw = min(kPT, P - p0);
  const int nw = min(kNT, N - n0);
  const int np = (nw + 15) / 16 * 16;
  const int t0 = ic * chunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (warp == 0) {
    // inclusive cumsum of dt·A (each product rounded to fp32, as the plain
    // version rounds it), summed in fp64, 8 positions a lane: decays are
    // exponentials of differences of nearby sums that reach |cum| ~ 10^3,
    // where an fp32 sum would lose ~10^-4 of the exponent
    constexpr int kPer = kMaxChunk / 32;
    const float a_h = A[hh];
    double local[kPer];
    float dts[kPer];
    double run = 0.0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = lane * kPer + e;
      dts[e] = i < chunk ? dt[((long)b * S + t0 + i) * H + hh] : 0.f;
      run += (double)(dts[e] * a_h);
      local[e] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const double excl = incl - run;
    double* cg = cum_g + (((long)b * H + hh) * n_chunks + ic) * chunk;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = lane * kPer + e;
      cum[i] = excl + local[e];
      w[i] = dts[e];
      if (i < chunk && blockIdx.z == 0) cg[i] = cum[i];
    }
  }
  __syncthreads();
  const double cum_last = cum[chunk - 1];
  for (int i = tid; i < kMaxChunk; i += 128)
    w[i] = i < chunk ? w[i] * expf((float)(cum_last - cum[i])) : 0.f;

  // warp: p rows 16 warp .., the block's n columns
  const int pm = 16 * warp;
  float acc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int j0 = 0; j0 < chunk; j0 += kT) {
    __syncthreads();  // w ready; the previous slab's tiles are consumed
    const int valid = chunk - j0;
    load_rows_n(Bs, Bm + b * b_bs + (long)(t0 + j0) * b_ss + n0, b_ss, valid,
                nw, np, tid, 128);
    // x slab: every load issued before any is used
    constexpr int kIt = kT * (kPT / 8) / 128;
    uint4 raw[kIt];
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int idx = tid + it * 128;
      const int r = idx / (kPT / 8);
      const int c = (idx % (kPT / 8)) * 8;
      raw[it] = make_uint4(0, 0, 0, 0);
      if (r < valid && c < pw)
        raw[it] = *reinterpret_cast<const uint4*>(
            x + b * x_bs + (long)(t0 + j0 + r) * x_ss + (long)hh * P + p0 + c);
    }
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int idx = tid + it * 128;
      const int r = idx / (kPT / 8);
      const int c = (idx % (kPT / 8)) * 8;
      const __nv_bfloat162* h2 =
          reinterpret_cast<const __nv_bfloat162*>(&raw[it]);
      const float wr = w[j0 + r];  // 0 past the chunk
      float f[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = __bfloat1622float2(h2[e]);
        f[2 * e] = v.x * wr;
        f[2 * e + 1] = v.y * wr;
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split2(f[2 * e], f[2 * e + 1], hi[e], lo[e]);
      *reinterpret_cast<uint4*>(Xh + r * kLdP + c) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(Xl + r * kLdP + c) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    cp_async_wait();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t ah[4], al[4];
      frag_a_t(ah, Xh, kLdP, pm, kk * 16, lane);
      frag_a_t(al, Xl, kLdP, pm, kk * 16, lane);
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        if (pr * 16 >= np) break;
        uint32_t bb[4];
        frag_b_t(bb, Bs, kLdN, pr * 16, kk * 16, lane);
        mma(acc[2 * pr], ah, bb[0], bb[1]);
        mma(acc[2 * pr], al, bb[0], bb[1]);
        mma(acc[2 * pr + 1], ah, bb[2], bb[3]);
        mma(acc[2 * pr + 1], al, bb[2], bb[3]);
      }
    }
  }

  const int g = lane >> 2, tq = lane & 3;
  float* out = states + (((long)b * n_chunks + ic) * H + hh) * (long)P * N;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = pm + g + 8 * r;
      const int n = nb * 8 + 2 * tq;
      if (p < pw && n < nw)
        *reinterpret_cast<float2*>(out + (long)(p0 + p) * N + n0 + n) =
            make_float2(acc[nb][2 * r], acc[nb][2 * r + 1]);
    }
}

// ---- pass 3: the recurrence over chunk states ----------------------------

__global__ void __launch_bounds__(256)
ssd_state_pass_kernel(const float* __restrict__ states,
                      const double* __restrict__ cum_g,
                      const float* __restrict__ h0, float* __restrict__ h_in,
                      float* __restrict__ hT, int H, int PN, int n_chunks,
                      int chunk) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  if (e >= PN) return;
  const long bh = (long)b * H + hh;
  float h = h0 != nullptr ? h0[bh * PN + e] : 0.f;
  const double* cl = cum_g + bh * n_chunks * chunk + chunk - 1;
  for (int ic = 0; ic < n_chunks; ++ic) {
    const long at = (((long)b * n_chunks + ic) * H + hh) * PN + e;
    h_in[at] = h;
    h = h * expf((float)cl[(long)ic * chunk]) + states[at];
  }
  hT[bh * PN + e] = h;
}

// ---- pass 4: outputs -----------------------------------------------------

constexpr int kLdCB = kT + 1;   // padded fp32 row of a C·Bᵀ tile
constexpr int kScanSmem =
    (kT * kLdN + 2 * kPT * kLdN + kT * kLdP) * 2 + kMaxChunk * (8 + 4);

__global__ void __launch_bounds__(128)
ssd_chunk_scan_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ dt,
                      const __nv_bfloat16* __restrict__ Cm,
                      const float* __restrict__ cb,
                      const double* __restrict__ cum_g,
                      const float* __restrict__ h_in,
                      float* __restrict__ y, int S, int H, int P, int N,
                      int chunk, long x_bs, long x_ss, long c_bs, long c_ss,
                      int n_qt) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Hh = Cs + kT * kLdN;     // h_in rows p, split hi
  __nv_bfloat16* Hl = Hh + kPT * kLdN;    // and lo
  __nv_bfloat16* Xs = Hl + kPT * kLdN;    // x key tile (keys, p)
  double* cum = reinterpret_cast<double*>(Xs + kT * kLdP);
  float* dts = reinterpret_cast<float*>(cum + kMaxChunk);
  // once the state term has used h_in: the C·Bᵀ tile of the key tile, and
  // each warp's fp32 offsets of the tile's cum from the warp's first row
  float* CBs = reinterpret_cast<float*>(Hh);
  float* kloc = reinterpret_cast<float*>(Hl);  // (4 warps, kT keys)

  const int n_chunks = S / chunk;
  const int qt = blockIdx.x % n_qt;
  const int ch = blockIdx.x / n_qt;        // ic * H + hh
  const int ic = ch / H;
  const int hh = ch % H;
  const int b = blockIdx.y;
  const int p0 = blockIdx.z * kPT;
  const int pw = min(kPT, P - p0);
  const int i0 = qt * kT;
  const int t0 = ic * chunk;
  const int np = (N + 15) / 16 * 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;

  const double* cg = cum_g + (((long)b * H + hh) * n_chunks + ic) * chunk;
  for (int i = tid; i < chunk; i += 128) {
    cum[i] = cg[i];
    dts[i] = dt[((long)b * S + t0 + i) * H + hh];
  }
  load_rows_n(Cs, Cm + b * c_bs + (long)(t0 + i0) * c_ss, c_ss, chunk - i0, N,
              np, tid, 128);
  const float* hsrc =
      h_in + (((long)b * n_chunks + ic) * H + hh) * (long)P * N + (long)p0 * N;
  // h_in, split hi + lo: four rows of 8 a thread in flight at a time
  const int groups = np / 8;
  constexpr int kBatch = 4;
  for (int base = tid; base < kPT * groups; base += kBatch * 128) {
    float4 u[kBatch][2];
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int idx = base + it * 128;
      const int r = idx / groups, c = (idx % groups) * 8;
      u[it][0] = u[it][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < kPT * groups && r < pw && c < N) {
        const float4* s4 =
            reinterpret_cast<const float4*>(hsrc + (long)r * N + c);
        u[it][0] = s4[0];
        u[it][1] = s4[1];
      }
    }
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int idx = base + it * 128;
      if (idx >= kPT * groups) break;
      const int r = idx / groups, c = (idx % groups) * 8;
      uint32_t hi[4], lo[4];
      split2(u[it][0].x, u[it][0].y, hi[0], lo[0]);
      split2(u[it][0].z, u[it][0].w, hi[1], lo[1]);
      split2(u[it][1].x, u[it][1].y, hi[2], lo[2]);
      split2(u[it][1].z, u[it][1].w, hi[3], lo[3]);
      *reinterpret_cast<uint4*>(Hh + r * kLdN + c) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(Hl + r * kLdN + c) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  cp_async_wait();  // C rows
  __syncthreads();

  // incoming state: y_i = e^{cum_i} C_i · h_inᵀ
  float acc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  for (int k0 = 0; k0 < np; k0 += 16) {
    uint32_t a[4];
    frag_a(a, Cs, kLdN, warp * 16, k0, lane);
#pragma unroll
    for (int pr = 0; pr < 4; ++pr) {
      uint32_t bh[4], bl[4];
      frag_b(bh, Hh, kLdN, pr * 16, k0, lane);
      frag_b(bl, Hl, kLdN, pr * 16, k0, lane);
      mma(acc[2 * pr], a, bh[0], bh[1]);
      mma(acc[2 * pr], a, bl[0], bl[1]);
      mma(acc[2 * pr + 1], a, bh[2], bh[3]);
      mma(acc[2 * pr + 1], a, bl[2], bl[3]);
    }
  }
  const int row[2] = {i0 + warp * 16 + g, i0 + warp * 16 + g + 8};
  // decay exponents cum_i − cum_j as differences of fp32 offsets from an
  // fp64 origin per warp: the exponents that weigh anything (> −20 or so)
  // then carry ~4e-6 of rounding, not the ~1e-4 of fp32 sums near 10^3
  const double origin = cum[min(i0 + warp * 16, chunk - 1)];
  float rloc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const double c_i = row[r] < chunk ? cum[row[r]] : 0.0;
    rloc[r] = (float)(c_i - origin);
    const float dec = expf((float)c_i);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      acc[nb][2 * r] *= dec;
      acc[nb][2 * r + 1] *= dec;
    }
  }

  // intra-chunk: key tiles j0 ≤ i0, (CB ∘ e^{cum_i − cum_j} dt_j) · x
  const float* cbc = cb + ((long)b * n_chunks + ic) * chunk * chunk;
  const int warp_last = i0 + warp * 16 + 15;  // last row of this warp
  for (int j0 = 0; j0 <= i0; j0 += kT) {
    __syncthreads();  // Xs and CBs are free (and the state term done)
    const int valid = chunk - j0;
    for (int idx = tid; idx < kT * (kPT / 8); idx += 128) {
      const int r = idx / (kPT / 8);
      const int c = (idx % (kPT / 8)) * 8;
      if (r < valid && c < pw)
        cp_async16(Xs + r * kLdP + c, x + b * x_bs + (long)(t0 + j0 + r) * x_ss +
                                          (long)hh * P + p0 + c);
      else
        *reinterpret_cast<uint4*>(Xs + r * kLdP + c) = make_uint4(0, 0, 0, 0);
    }
    for (int idx = tid; idx < kT * kT; idx += 128) {
      const int r = idx / kT, c = idx % kT;
      if (i0 + r < chunk && c < valid)
        cp_async4(CBs + r * kLdCB + c, cbc + (long)(i0 + r) * chunk + j0 + c);
      else
        CBs[r * kLdCB + c] = 0.f;
    }
    for (int idx = tid; idx < 4 * kT; idx += 128) {
      const int w = idx / kT, c = idx % kT;
      kloc[idx] = c < valid ? (float)(cum[j0 + c] -
                                      cum[min(i0 + w * 16, chunk - 1)])
                            : 0.f;
    }
    cp_async_wait();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const int jb = j0 + kk * 16;
      if (jb > warp_last) break;  // wholly above this warp's diagonal
      // A fragments of M = CB ∘ e^{cum_i − cum_j} dt_j, built in registers:
      // reg q holds row row[q & 1], keys jb + 8 (q >> 1) + 2 tq + {0, 1}
      uint32_t ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = row[q & 1];
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jb + 8 * (q >> 1) + 2 * tq + e;
          // mask first: exp only where j ≤ i (its argument is ≤ 0 there)
          v[e] = (i < chunk && j <= i)
                     ? CBs[(i - i0) * kLdCB + j - j0] *
                           expf(rloc[q & 1] - kloc[warp * kT + j - j0]) *
                           dts[j]
                     : 0.f;
        }
        split2(v[0], v[1], ah[q], al[q]);
      }
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        uint32_t bb[4];
        frag_b_t(bb, Xs, kLdP, pr * 16, kk * 16, lane);
        mma(acc[2 * pr], ah, bb[0], bb[1]);
        mma(acc[2 * pr], al, bb[0], bb[1]);
        mma(acc[2 * pr + 1], ah, bb[2], bb[3]);
        mma(acc[2 * pr + 1], al, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= chunk) continue;
    float* yr = y + (((long)b * S + t0 + row[r]) * H + hh) * P + p0;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int c = nb * 8 + 2 * tq;
      if (c < pw)
        *reinterpret_cast<float2*>(yr + c) =
            make_float2(acc[nb][2 * r], acc[nb][2 * r + 1]);
    }
  }
}

}  // namespace

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* h0,
                             void* y, void* hT, void* cb, void* cum,
                             void* states, void* h_in, int b, int S, int H,
                             int P, int N, int chunk, int x_bs, int x_ss,
                             int b_bs, int b_ss, int c_bs, int c_ss,
                             void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || chunk > kMaxChunk || S % chunk != 0 || N <= 0 ||
      N > kMaxN || N % 8 != 0 || P % 8 != 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kScanSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* Bb = static_cast<const __nv_bfloat16*>(B);
  const auto* Cb = static_cast<const __nv_bfloat16*>(C);
  const int n_chunks = S / chunk;
  const int n_t = (chunk + kT - 1) / kT;
  const int n_tri = n_t * (n_t + 1) / 2;
  const int p_blocks = (P + kPT - 1) / kPT;

  ssd_cb_kernel<<<dim3(n_tri * n_chunks, b), 128, 0, s>>>(
      Bb, Cb, static_cast<float*>(cb), S, N, chunk, b_bs, b_ss, c_bs, c_ss,
      n_tri);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_state_kernel<<<dim3(n_chunks * H, b, p_blocks * ((N + kNT - 1) / kNT)),
                     128, 0, s>>>(
      xb, static_cast<const float*>(dt), static_cast<const float*>(A), Bb,
      static_cast<double*>(cum), static_cast<float*>(states), S, H, P, N, chunk,
      x_bs, x_ss, b_bs, b_ss);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_state_pass_kernel<<<dim3((P * N + 255) / 256, H, b), 256, 0, s>>>(
      static_cast<const float*>(states), static_cast<const double*>(cum),
      static_cast<const float*>(h0), static_cast<float*>(h_in),
      static_cast<float*>(hT), H, P * N, n_chunks, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<<<dim3(n_t * n_chunks * H, b, p_blocks), 128,
                          kScanSmem, s>>>(
      xb, static_cast<const float*>(dt), Cb, static_cast<const float*>(cb),
      static_cast<const double*>(cum), static_cast<const float*>(h_in),
      static_cast<float*>(y), S, H, P, N, chunk, x_bs, x_ss, c_bs, c_ss, n_t);
  return (int)cudaGetLastError();
}
