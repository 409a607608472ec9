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
// Both entries run one kernel, with the layer on the grid's x axis
// (x = layer·KV + KV head), so layer l of a layers call does exactly the
// arithmetic of a per-layer call on layer l's slabs when both use the same
// split count (the wrappers give the layers call the per-layer count).
//
// Computes, for every slot b and query head h:
//   o[b,h,:] = softmax_t( q[b,h,:]·k_t / sqrt(D) ) · v_t
// over the tokens t of slot b's paged KV, read through its block table,
// with t < min(seq_lens[b], max_pages*page) and, if window > 0,
// t >= seq_lens[b] - window. Pages past ceil(len/page) are never read, so
// the null page 0 is never loaded; a slot with no live token gives 0.
//
// What bounds it on an H100: memory. One decode token does ~4·D flops per
// (query head, token) against 4·D bytes of K/V per (KV head, token), far
// below the ~295 flop/byte ridge. Least time = the live K/V bytes / 3.35
// TB/s: 8.08 MB, 2.4 µs, for smollm-360m's serving step (8 slots, 16
// padded query heads over 5 KV heads, D = 64).
//
// Design: one launch, one block (4 warps) per (layer, KV head, slot,
// split), serving every query head that qh2kv maps to that KV head.
//  * Grouping. Warp 0 reads qh2kv and lists, in ascending order, the
//    query heads of its KV head (one ballot per 32 heads; a KV head no
//    query head uses exits at once), while the block fetches the slot's
//    length and block-table row. Their q rows, zero-padded to 16, are the A
//    operand of Q·Kᵀ, so each live K/V byte is read once per (layer, slot,
//    KV head) whatever the map; a group of more than 16 heads loops over
//    16-row query tiles. No inverse map is built on the host.
//  * The page ring. The slot's live range [lo, n_tok) is cut into 64-token
//    tiles of its linear token sequence, and the tiles into n_splits runs.
//    Each tile's K and V rows are copied into a stage of a 4-stage (3 at
//    D = 128) shared-memory ring with cp.async.cg 16-byte copies, each
//    row's page id read from the block's copy of the table row; rows
//    outside the live range are zero-filled (src-size 0) and never read.
//    The prologue fills every stage, so a split of up to 4 tiles (the
//    serving step's) has all its loads in flight at once. Rows are XOR-
//    swizzled by 16-byte chunk instead of padded, which keeps three blocks
//    an SM at D = 64 (two at D = 96 and 128). At D = 96 a row is 12
//    chunks (192 bytes), so its swizzle and copy order are its own
//    (``swz``, ``copy_slot``). Tiles are whole pages or parts of pages,
//    so any page size works. cp.async and not TMA: at 16- and 32-token
//    pages a tile spans several pages, which one TMA box cannot, and a
//    tensor map would cost host encoding on each of the 32 calls of a
//    decode step.
//  * Tensor cores. Warp w takes tokens [16w, 16w+16) of every tile:
//    S = Q·Kᵀ with mma.sync.m16n8k16 bf16 (K through ldmatrix), the online
//    softmax per row in registers (base-2 exponent, masking before the
//    max), then O += P·V with the score accumulators packed to bf16 as the
//    A fragments and V through ldmatrix.trans. After the last tile the four
//    warps' (acc, m, l) are merged in shared memory in warp order.
//  * The split combine in the same launch, by thread-block clusters: the
//    n_splits blocks of a (layer, KV head, slot) form one cluster along z
//    (so n_splits <= 8). Each block leaves its partial in shared memory;
//    after a cluster barrier the blocks share the output elements, each
//    thread reading its element of the partials of ranks 0, 1, ... through
//    distributed shared memory, merging them by log-sum-exp in that order
//    and writing bf16; a second barrier keeps every block alive until all
//    have read. A split with no live token still reaches both barriers
//    with (m = -inf, l = 0), which the merge skips. Fixed merge order, no
//    atomics: deterministic. No global scratch and no state between calls.
//    An arrival counter (the last split block merges partials from a
//    workspace) was measured too: slower on the serving step, where the
//    merge then waits on two more L2 round trips, faster on the 32-layer
//    grid, whose many short blocks otherwise wait at the cluster barriers
//    (PERF.md, PR 14); the serving step decides.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;       // tokens per ring stage
constexpr int kRows = 16;       // query heads per tile (mma M)
constexpr int kWarps = 4;       // 16 tokens of each tile per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 8;   // portable cluster size
constexpr int kMaxHeads = 256;  // query heads a map may have
constexpr int kTableCap = 128;  // block-table entries a block keeps in smem
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  // D = 96: 4 stages are 96 KB of ring and 106.6 KB a block, 3 would be
  // 82.6 KB; either way two blocks fit an SM, so it keeps all four
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kChunks = D / 8;                // 16-byte chunks a row
  static constexpr int kStageElems = 2 * kTile * D;    // K rows, then V rows
  static constexpr int kRingBytes = kStages * kStageElems * 2;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kPartFloats = kRows * D + 2 * kRows;  // acc, m, l
  static constexpr int kGrpOff = kRingBytes + kQBytes + kPartFloats * 4;
  static constexpr int kTblOff = kGrpOff + kMaxHeads * 4;
  static constexpr int kSmem = kTblOff + kTableCap * 4;
  // the four warps' partials reuse the ring after the last tile
  static_assert(kWarps * kPartFloats * 4 <= kRingBytes, "warp partials");
};

// XOR swizzle of a row's 16-byte chunks, so that the 8 rows an ldmatrix
// reads at one chunk (rows 8j .. 8j + 7) fall in 8 different bank groups
// (16 bytes each, 8 to a 128-byte line); it permutes the chunks of each
// row among themselves. Row r starts at bank group 2·D·r/16 mod 8:
//  * D = 64, 128 (rows of whole lines, group 0): chunk c goes to
//    c ^ (r & 7), in group (c ^ r) mod 8;
//  * D = 32 (64-byte rows, group 4 (r & 1)): c ^ ((r >> 1) & 3), in group
//    4 (r & 1) + (c ^ ((r >> 1) & 3)), and (r & 1, (r >> 1) & 3) takes
//    all 8 values over 8 rows;
//  * D = 96 (192-byte rows, group 12 r mod 8 = 4 (r & 1)): chunks 0-7 go
//    to c ^ (r & 7), in group (c ^ (r & 7)) ^ 4 (r & 1), and r & 7 ->
//    (r & 7) ^ 4 (r & 1) is one-to-one; chunks 8-11 go to
//    8 + ((c - 8) ^ ((r >> 1) & 3)), in group 4 (r & 1) + ((c - 8) ^
//    ((r >> 1) & 3)), distinct over 8 rows as at D = 32.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (D == 96)
    return c < 8 ? c ^ (r & 7) : 8 + ((c - 8) ^ ((r >> 1) & 3));
  else if constexpr (D == 32)
    return c ^ ((r >> 1) & 3);
  else
    return c ^ (r & 7);
}

// element offset of (row r, 16-byte chunk c) in a swizzled tile of D columns
template <int D>
__device__ __forceinline__ int sw(int r, int c) {
  return r * D + (swz<D>(r, c) << 3);
}

// Thread tid's it-th of a tile's kTile·kChunks 16-byte copies (copy
// i = tid + it·kThreads): (row, chunk). Row by row, so 8 neighbouring
// threads (one 128-byte store phase) write one row's 8 chunks, or 2 or 4
// rows' 4 or 2 chunks each, in 8 bank groups; where kChunks divides
// kThreads a thread keeps its chunk through the loop. At D = 96 a row
// has 12 chunks, and 8 threads at a run of 8 of them would meet chunks
// 8-11 in the groups of four of chunks 0-7; so the first 512 copies take
// chunks 0-7 of every row (8 a row, all 8 groups) and the last 256
// chunks 8-11 (an even row's in groups 0-3, the next odd row's in 4-7).
template <int D>
__device__ __forceinline__ void copy_slot(int tid, int it, int& r, int& c) {
  constexpr int kChunks = Cfg<D>::kChunks;
  if constexpr (D == 96) {
    const int i = tid + it * kThreads;
    if (i < kTile * 8) {
      r = i >> 3;
      c = i & 7;
    } else {
      r = (i - kTile * 8) >> 2;
      c = 8 + (i & 3);
    }
  } else {
    r = tid / kChunks + it * (kThreads / kChunks);
    c = tid % kChunks;
  }
}

// ---- tensor cores and asynchronous copies ----------------------------

// c (16x8 fp32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragments of swizzled row-major tiles (each lane names one 16-byte row
// segment of the four 8x8 matrices ldmatrix reads):
// A (16 rows r0.. x 16 k k0..) of a tile s[row][k]
template <int D>
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* s,
                                       int r0, int k0, int lane) {
  ldsm4(a, s + sw<D>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                     (k0 >> 3) + (lane >> 4)));
}
// B of two 8-column blocks (n0.., n0+8..) x 16 k of a tile s[n][k]:
// b[0..1] for block n0, b[2..3] for n0+8
template <int D>
__device__ __forceinline__ void frag_b(uint32_t* b, const __nv_bfloat16* s,
                                       int n0, int k0, int lane) {
  ldsm4(b, s + sw<D>(n0 + (lane & 7) + (lane >> 4) * 8,
                     (k0 >> 3) + ((lane >> 3) & 1)));
}
// the same from a tile stored k-major as s[k][n]
template <int D>
__device__ __forceinline__ void frag_b_t(uint32_t* b, const __nv_bfloat16* s,
                                         int n0, int k0, int lane) {
  ldsm4_t(b, s + sw<D>(k0 + ((lane >> 3) & 1) * 8 + (lane & 7),
                       (n0 >> 3) + (lane >> 4)));
}

// 16 bytes global -> shared; with ok = false nothing is read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- the kernel --------------------------------------------------------

// K and V rows of tokens [t0, t0 + 64) of one KV head into a ring stage
// (K rows, then V rows, swizzled): token t from page table[t / page] (the
// block's shared-memory copy of the row's first kTableCap entries, or the
// table itself past them); rows outside [lo, n_tok) are zero-filled and
// read nothing. ``col`` = the KV head's first column. Each thread makes
// kTile·D/8 / 128 copies (``copy_slot``), a whole number at every D taken
// (2, 4, 6, 8).
template <int D>
__device__ __forceinline__ void load_tile(
    __nv_bfloat16* ks, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* tbl_s,
    const int* __restrict__ table, int t0, int lo, int n_tok, int page,
    size_t tok_stride, size_t col, int tid) {
  constexpr int kCopies = kTile * Cfg<D>::kChunks;
  static_assert(kCopies % kThreads == 0, "copies a thread");
  __nv_bfloat16* vs = ks + kTile * D;
#pragma unroll
  for (int it = 0; it < kCopies / kThreads; ++it) {
    int r, c;
    copy_slot<D>(tid, it, r, c);
    const int t = t0 + r;
    const bool ok = t >= lo && t < n_tok;
    size_t off = 0;
    if (ok) {
      const int p = t / page;
      const int pid = p < kTableCap ? tbl_s[p] : __ldg(table + p);
      off = ((size_t)pid * page + t % page) * tok_stride + col + c * 8;
    }
    cp_async16(ks + sw<D>(r, c), k_pages + off, ok);
    cp_async16(vs + sw<D>(r, c), v_pages + off, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,        // (L,B,H,D)
                    const __nv_bfloat16* __restrict__ k_pages,  // (L,P,page,KV,D)
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ block_table,        // (B,max_pages)
                    const int* __restrict__ seq_lens,           // (B,)
                    const int* __restrict__ qh2kv,              // (H,)
                    __nv_bfloat16* __restrict__ out,            // (L,B,H,D)
                    int H, int KV, int page, int max_pages, int window,
                    float scale, size_t kv_lstride) {
  using C = Cfg<D>;
  constexpr int kChunks = C::kChunks;
  constexpr int kS = C::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + C::kRingBytes);
  float* part = reinterpret_cast<float*>(smem + C::kRingBytes + C::kQBytes);
  int* grp = reinterpret_cast<int*>(smem + C::kGrpOff);
  int* tbl_s = reinterpret_cast<int*>(smem + C::kTblOff);
  __shared__ int n_grp;
  __shared__ float fac[kWarps][kRows];  // each warp's weight in the merge

  cg::cluster_group cluster = cg::this_cluster();
  const int n_splits = gridDim.z;   // one cluster spans the split axis
  const int sp = blockIdx.z;        // == the block's rank in its cluster
  const int layer = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  q += ((size_t)layer * B + b) * H * D;
  out += ((size_t)layer * B + b) * H * D;
  k_pages += layer * kv_lstride;
  v_pages += layer * kv_lstride;
  const int* table = block_table + (size_t)b * max_pages;

  // requested together: the slot's length, its block-table row, and the
  // head map, which warp 0 turns into the ascending list of this KV
  // head's query heads (one ballot per 32 heads)
  const int len = seq_lens[b];
  for (int p = tid; p < min(max_pages, kTableCap); p += kThreads)
    tbl_s[p] = table[p];
  if (warp == 0) {
    int n = 0;
    for (int h0 = 0; h0 < H; h0 += 32) {
      const bool mine = h0 + lane < H && qh2kv[h0 + lane] == kvh;
      const unsigned bal = __ballot_sync(0xffffffffu, mine);
      if (mine) grp[n + __popc(bal & ((1u << lane) - 1))] = h0 + lane;
      n += __popc(bal);
    }
    if (lane == 0) n_grp = n;
  }
  __syncthreads();
  const int G = n_grp;
  if (G == 0) return;  // the whole cluster serves this KV head: all leave

  // this split's run of 64-token tiles of the live range [lo, n_tok)
  const int n_tok = min(len, max_pages * page);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int first = lo / kTile;
  const int n_all = max((n_tok + kTile - 1) / kTile - first, 0);
  const int per = (n_all + n_splits - 1) / n_splits;
  const int t_begin = first + min(sp * per, n_all);
  const int n_t = max(0, min(per, n_all - sp * per));
  const size_t tok_stride = (size_t)KV * D;
  const float sl2 = scale * kLog2e;
  const size_t col = (size_t)kvh * D;

  const int g = lane >> 2, tq = lane & 3;
  for (int h0 = 0; h0 < G; h0 += kRows) {
    const int Gt = min(kRows, G - h0);
    // every stage is filled at once: a split of up to kStages tiles has
    // all its loads in flight together
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      if (i < n_t)
        load_tile<D>(ring + i * C::kStageElems, k_pages, v_pages, tbl_s,
                     table, (t_begin + i) * kTile, lo, n_tok, page, tok_stride,
                     col, tid);
      cp_async_commit();
    }
    for (int c = tid; c < kRows * kChunks; c += kThreads) {
      const int r = c / kChunks, cc = c % kChunks;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < Gt)
        v = *reinterpret_cast<const uint4*>(q + (size_t)grp[h0 + r] * D +
                                            cc * 8);
      *reinterpret_cast<uint4*>(q_s + sw<D>(r, cc)) = v;
    }
    __syncthreads();
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) frag_a<D>(qf[kk], q_s, 0, kk * 16, lane);

    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g+8

    for (int i = 0; i < n_t; ++i) {
      if (i > 0) {
        __syncthreads();  // every warp is done with tile i - 1's stage
        if (i - 1 + kS < n_t)
          load_tile<D>(ring + ((i - 1) % kS) * C::kStageElems, k_pages,
                       v_pages, tbl_s, table, (t_begin + i - 1 + kS) * kTile,
                       lo, n_tok, page, tok_stride, col, tid);
        cp_async_commit();
      }
      cp_async_wait<kS - 1>();
      __syncthreads();  // tile i has landed for every thread
      const __nv_bfloat16* ks = ring + (i % kS) * C::kStageElems;
      const __nv_bfloat16* vs = ks + kTile * D;

      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        frag_b<D>(bk, ks, warp * 16, kk * 16, lane);
        mma(s[0], qf[kk], bk[0], bk[1]);
        mma(s[1], qf[kk], bk[2], bk[3]);
      }
      const int tw = (t_begin + i) * kTile + warp * 16;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = tw + j * 8 + 2 * tq + (e & 1);
          s[j][e] = (t >= lo && t < n_tok) ? s[j][e] * sl2 : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      const float n0 = fmaxf(m0, quad_max(mx0));
      const float n1 = fmaxf(m1, quad_max(mx1));
      const float u0 = n0 == -INFINITY ? 0.f : n0;  // all masked so far
      const float u1 = n1 == -INFINITY ? 0.f : n1;
      const float a0 = exp2f(m0 - u0), a1 = exp2f(m1 - u1);
      m0 = n0;
      m1 = n1;
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[j][0] = exp2f(s[j][0] - u0);
        p[j][1] = exp2f(s[j][1] - u0);
        p[j][2] = exp2f(s[j][2] - u1);
        p[j][3] = exp2f(s[j][3] - u1);
      }
      l0 = l0 * a0 + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
      l1 = l1 * a1 + (p[0][2] + p[0][3]) + (p[1][2] + p[1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= a0;
        acc[n][1] *= a0;
        acc[n][2] *= a1;
        acc[n][3] *= a1;
      }
      // the score accumulators are the A fragments of P·V (k = token)
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                              pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]),
                              pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bv[4];
        frag_b_t<D>(bv, vs, nd * 16, warp * 16, lane);
        mma(acc[2 * nd], pa, bv[0], bv[1]);
        mma(acc[2 * nd + 1], pa, bv[2], bv[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring

    // the four warps' partials, merged in warp order into this block's:
    // per row the max M, each warp's weight e^(m_w - M) and the sum l;
    // then the accumulators, four columns a thread
    float* wp = reinterpret_cast<float*>(ring) + warp * C::kPartFloats;
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int cn = n * 8 + 2 * tq;
      *reinterpret_cast<float2*>(wp + g * D + cn) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(wp + (g + 8) * D + cn) =
          make_float2(acc[n][2], acc[n][3]);
    }
    if (tq == 0) {
      wp[kRows * D + g] = m0;
      wp[kRows * D + g + 8] = m1;
      wp[kRows * D + kRows + g] = l0;
      wp[kRows * D + kRows + g + 8] = l1;
    }
    __syncthreads();
    const float* w0 = reinterpret_cast<const float*>(ring);
    if (tid < kRows) {
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        M = fmaxf(M, w0[w * C::kPartFloats + kRows * D + tid]);
      float L = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = w0[w * C::kPartFloats + kRows * D + tid];
        const float f = mw == -INFINITY ? 0.f : exp2f(mw - M);
        fac[w][tid] = f;
        L += w0[w * C::kPartFloats + kRows * D + kRows + tid] * f;
      }
      part[kRows * D + tid] = M;
      part[kRows * D + kRows + tid] = L;
    }
    __syncthreads();
    for (int x = tid * 4; x < kRows * D; x += kThreads * 4) {
      const int r = x / D;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 a =
            *reinterpret_cast<const float4*>(w0 + w * C::kPartFloats + x);
        const float f = fac[w][r];
        A.x += a.x * f;
        A.y += a.y * f;
        A.z += a.z * f;
        A.w += a.w * f;
      }
      *reinterpret_cast<float4*>(part + x) = A;
    }

    // the splits, merged in split order; the cluster's blocks share the
    // output elements, and each thread reads its element of every split's
    // partial through distributed shared memory in one round of loads
    cluster.sync();
    for (int x = sp * kThreads + tid; x < Gt * D; x += n_splits * kThreads) {
      const int r = x / D;
      float ms[kMaxSplits], as[kMaxSplits], ls[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        ms[s] = -INFINITY;
        as[s] = ls[s] = 0.f;
        if (s < n_splits) {
          const float* ps = cluster.map_shared_rank(part, s);
          ms[s] = ps[kRows * D + r];
          as[s] = ps[x];
          ls[s] = ps[kRows * D + kRows + r];
        }
      }
      float M = -INFINITY;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) M = fmaxf(M, ms[s]);
      float A = 0.f, L = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (ms[s] != -INFINITY) {  // an empty split (or past n_splits)
          const float f = exp2f(ms[s] - M);
          A += as[s] * f;
          L += ls[s] * f;
        }
      }
      out[(size_t)grp[h0 + r] * D + x % D] =
          __float2bfloat16(L > 0.f ? A / L : 0.f);
    }
    cluster.sync();  // the partials stay alive until every block has read
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* seq_lens,
                   const void* qh2kv, void* out, int L, int B, int H, int KV,
                   int page, int max_pages, int window, float scale,
                   int n_splits, size_t kv_lstride, cudaStream_t s) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<D>::kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L * KV, B, n_splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<D>::kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n_splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_decode_kernel<D>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages),
      static_cast<const int*>(block_table), static_cast<const int*>(seq_lens),
      static_cast<const int*>(qh2kv), static_cast<__nv_bfloat16*>(out), H, KV,
      page, max_pages, window, scale, kv_lstride);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* block_table, const void* seq_lens, const void* qh2kv,
             void* out, int L, int B, int H, int KV, int D, int page,
             int max_pages, int n_pages, int window, float scale,
             int n_splits, void* stream) {
  if (L <= 0 || B <= 0 || H <= 0) return (int)cudaSuccess;
  if ((long long)L * KV > 0x7fffffffLL || B > 65535 || KV <= 0 ||
      H > kMaxHeads || page <= 0 || n_splits < 1 || n_splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t kv_lstride = (size_t)n_pages * page * KV * D;
  switch (D) {
    case 32:
      return (int)launch<32>(q, k_pages, v_pages, block_table, seq_lens,
                             qh2kv, out, L, B, H, KV, page, max_pages, window,
                             scale, n_splits, kv_lstride, s);
    case 64:
      return (int)launch<64>(q, k_pages, v_pages, block_table, seq_lens,
                             qh2kv, out, L, B, H, KV, page, max_pages, window,
                             scale, n_splits, kv_lstride, s);
    case 96:
      return (int)launch<96>(q, k_pages, v_pages, block_table, seq_lens,
                             qh2kv, out, L, B, H, KV, page, max_pages, window,
                             scale, n_splits, kv_lstride, s);
    case 128:
      return (int)launch<128>(q, k_pages, v_pages, block_table, seq_lens,
                              qh2kv, out, L, B, H, KV, page, max_pages,
                              window, scale, n_splits, kv_lstride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one block at head_dim D (0 for another D).
extern "C" int paged_attention_smem_bytes(int D) {
  switch (D) {
    case 32: return Cfg<32>::kSmem;
    case 64: return Cfg<64>::kSmem;
    case 96: return Cfg<96>::kSmem;
    case 128: return Cfg<128>::kSmem;
    default: return 0;
  }
}

// One layer: q (B,H,D), pages (P,page,KV,D), out (B,H,D).
extern "C" int paged_attention_bf16(const void* q, const void* k_pages,
                                    const void* v_pages,
                                    const void* block_table,
                                    const void* seq_lens, const void* qh2kv,
                                    void* out, int B, int H, int KV, int D,
                                    int page, int max_pages, int window,
                                    float scale, int n_splits, void* stream) {
  return dispatch(q, k_pages, v_pages, block_table, seq_lens, qh2kv, out, 1,
                  B, H, KV, D, page, max_pages, 0, window, scale, n_splits,
                  stream);
}

// All L layers in one launch: qs (L,B,H,D), pages (L,P,page,KV,D), out
// (L,B,H,D); the block table, lengths and head map are shared.
extern "C" int paged_attention_layers_bf16(
    const void* qs, const void* k_pages, const void* v_pages,
    const void* block_table, const void* seq_lens, const void* qh2kv,
    void* out, int L, int B, int H, int KV, int D, int page, int max_pages,
    int n_pages, int window, float scale, int n_splits, void* stream) {
  return dispatch(qs, k_pages, v_pages, block_table, seq_lens, qh2kv, out, L,
                  B, H, KV, D, page, max_pages, n_pages, window, scale,
                  n_splits, stream);
}
