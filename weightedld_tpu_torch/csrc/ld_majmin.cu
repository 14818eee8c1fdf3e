// Factorized major/dominant-minor weighted-LD tile kernel for Hopper (sm_90a).
//
// Replaces the two factorized Pallas TPU kernels of the JAX package:
//   * weightedld_tpu/ops/pallas_ld.py:_ld_kernel_mm (entry
//     pallas_tile_stats_majmin), which builds the per-site [maj; dmin]
//     indicator planes from the int8 codes and the per-site aux in-kernel;
//   * weightedld_tpu/ops/pallas_ld.py:_ld_kernel_mm_pre (entry
//     pallas_tile_stats_majmin_pre), which reads the planes and the
//     weight-scaled int8 cascade planes (xq) precomputed in device memory;
// with the finalize algebra of pallas_ld.py:_pair_algebra.
//
// What it computes.  For every site pair (i, j) of a (tile_i, tile_j) tile
// pair, the four weighted haplotype cells {maj,dmin}(i) x {maj,dmin}(j) as a
// contraction over the sequence axis, then D, D', r2 and the keep mask.
// Weight modes: NLEV int8 passes (unit weights: one count pass; int8 / int8x3
// cascades: two or three int8 x int8 -> int32 passes combined in f32 as
// sum_l a_l * J_l once per seq_chunk), or NFLT f32 passes (bf16-exact weights:
// one pass; split_bf16: w_hi and w_lo passes) accumulated in f32, or both
// (lo_int8, NLEV = NFLT = 1: the f32 pass of w_hi = bf16(w) plus one int8
// pass of the quantized residual q, combined as F + alpha * J once per
// seq_chunk, pallas_ld.py:926-930 and 1173-1177).
//
// Two bodies, chosen by weight mode (dispatch below), never as a fallback:
//
// 1. The integer modes (unit, int8, int8x3: NLEV = 1..3, NFLT = 0) run on the
//    int8 tensor cores, ld_majmin_wgmma.
//    What bounds it.  Operations: int8x3 is 4 cells x 3 levels x 2
//    operations per pair and column, 0.43 ms for the 528 tile pairs of
//    N_pad = 1,024, T = 256 at the 1,979 TOP/s int8 peak, against 0.13 ms
//    of HBM traffic (13 output bytes per pair).  Inside the SM, shared
//    memory: per 128-column stage the wgmma of both consumer warpgroups read
//    64 KB (each its own 8 KB of A, both the same 24 KB of B) and the
//    producer writes 40 KB, for 3.1 M MACs: ~139 bytes per clock at the
//    full tensor rate against the SM's 128, so even a perfect schedule stays
//    under ~90 % of the peak.  The preplaned entry reads 320 operand bytes
//    per column per CTA from L2 (~80 ops per byte); the codes entry reads
//    96 code bytes + 3 q bytes (~500 ops per byte) but builds its operands
//    on one warpgroup's CUDA cores, which sets its pace (PERF.md).
//    What the design does.  One CTA owns 64 A sites x 32 B sites of a tile
//    pair.  A = the [maj; dmin] 0/1 indicator rows of the A sites, M = 64 per
//    consumer warpgroup (32 sites); B = the indicator rows of the B sites
//    times each int8 level q_l, stacked along N, so one
//    wgmma.m64n{64,128,192}k32.s32.s8.s8 per 32 columns gives every level's
//    joints of the warpgroup's 1,024 pairs (the q_l side does not matter:
//    the int32 joints are exact in any order).  Rows are ordered in groups
//    of 8 (eight sites' maj rows, then the same sites' dmin rows) on both
//    sides, so the accumulator fragment (rows r, r+8; columns {c, c+1} + 8k)
//    gives each thread all 4 cells x NLEV levels of its own 8 pairs: the
//    combine needs no exchange.  A ring of shared-memory stages of 128
//    columns (128-byte swizzle, the wgmma K-major layout) is filled by one
//    producer warpgroup and drained by two consumer warpgroups through
//    mbarriers (full: the producer's writes or cp.async completions; empty:
//    the consumers' wgmma reads done).  The preplaned entry stages planes /
//    xq rows with cp.async into 4 stages (16 bytes where N_pad and seq_chunk
//    are multiples of 16, else 4 bytes; zero-filled past the chunk end); the
//    codes entry keeps 3 stages of code loads in flight (cp.async into raw
//    buffers) while it builds the landed one into one of 3 operand stages:
//    indicators from __vcmpeq4 against the per-site aux, masked with q_l,
//    written in the swizzled layout.  Rows
//    past the tile edge read the tile's last site and are masked at the
//    store.  At each reference seq chunk end the consumers wait for their
//    wgmma groups and combine the int32 joints into the f32 running cells,
//    which live in a shared buffer (registers stay for the accumulators);
//    after an item's last chunk a fourth, epilogue warpgroup runs the pair
//    algebra and the stores from that buffer while the consumers contract
//    the next item.  The CTAs are persistent (one per SM, items strided by
//    the grid), so the ring runs on across items.  setmaxnreg gives the
//    consumers 160 registers, the producer and the epilogue 96 each.
//
// 2. The float modes (bf16-exact, split_bf16, lo_int8: NFLT > 0) keep the
//    CUDA-core body ld_majmin_dp4a: a CTA of 32 x 32 site pairs, 2 x 2 pairs
//    x 4 cells per thread, the f32 passes summed from a 16-entry table per
//    staged word (below), lo_int8's int8 residual pass on __dp4a.  It is
//    bound by instruction issue on CUDA cores, at a few percent of the
//    operation bound; its tensor-core redesign (bf16 wgmma) is later work.
//
// Numerics that must match the JAX package bit for bit where it is exact:
//   * The int32 joints are exact; the f32 combine runs once per reference
//     seq chunk: cells = a1*J1 + a2*J2 + a3*J3 (left to right), then
//     acc = cells on the first chunk and acc += cells after.
//   * Build with -fmad=false and without --use_fast_math: no FMA contraction
//     of the combine or of _pair_algebra's products-minus-observations, IEEE
//     division for 1/safe_w, D' and r2, and the reciprocal is multiplied in,
//     as JAX does.
//   * The 0.95 skip rule is an f32 compare (0.95f): at P = 19/20 the f32
//     value equals f32(0.95) and the pair is skipped.
//   * Float weight passes accumulate in f32 one staged word at a time: the
//     f32 sum of the word's selected weights (column order) comes from a
//     16-entry table per word, indexed by the 4-bit mask of its 0/1 bytes
//     (one shared-memory read and one add per cell and word instead of four
//     multiply-adds).  Where the f32 partial sums are exact, as for weights
//     of a bounded dynamic range, this equals the plain version's float64
//     sum rounded once; elsewhere it is within f32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const int8_t* codes;    // [s_pad, n_pad] site-major codes       (codes)
  const int8_t* q;        // [nlev, n_pad] int8 cascade levels     (codes)
  const int8_t* planes;   // [2*s_pad, n_pad] [maj; dmin] per tile (planes)
  const int8_t* xq;       // [nlev, 2*s_pad, n_pad] planes * q_l   (planes)
                          // lo_int8: the [n_pad] q row instead
  const float* scale;     // [nlev] cascade scales a_l
  const float* wf;        // [nflt, n_pad] f32 pass weights
  const int32_t* auxc;    // [s_pad, 3] (major, dmin, distinct)
  const int32_t* tile_i;  // [k]
  const int32_t* tile_j;  // [k]
  const int32_t* emit;    // [k]
  float* d;               // [k, tile, tile]
  float* dp;
  float* r2;
  int8_t* keep;
  int tile;
  int n_sites;
  int s_pad;
  int n_pad;
  int seq_chunk;
};

__device__ __forceinline__ uint32_t ld_word(const int8_t* base, int64_t off) {
  return *reinterpret_cast<const uint32_t*>(base + off);
}

// _pair_algebra (pallas_ld.py:434-476), operation for operation.
__device__ __forceinline__ void pair_algebra(float n_mm, float n_md, float n_dm,
                                             float n_dd, bool& keep, float& d,
                                             float& d_prime, float& r2) {
  const float total_w = ((n_mm + n_md) + n_dm) + n_dd;
  keep = keep && (total_w > 0.0f);
  const float safe_w = total_w > 0.0f ? total_w : 1.0f;
  const float inv_w = 1.0f / safe_w;
  const float pa_major = (n_mm + n_md) * inv_w;
  const float pb_major = (n_mm + n_dm) * inv_w;
  const float pa_minor = (n_dm + n_dd) * inv_w;
  const float pb_minor = (n_md + n_dd) * inv_w;
  keep = keep && (pa_major < 0.95f) && (pb_major < 0.95f);
  keep = keep && (n_mm + n_md > 0.0f) && (n_mm + n_dm > 0.0f);
  const float obs_mm = n_mm * inv_w;
  const float obs_md = n_md * inv_w;
  const float obs_dm = n_dm * inv_w;
  const float obs_dd = n_dd * inv_w;
  const float t0 = pa_major * pb_major - obs_mm;
  const float t1 = pa_minor * pb_minor - obs_dd;
  const float t2 = -(pa_major * pb_minor - obs_md);
  const float t3 = -(pa_minor * pb_major - obs_dm);
  d = (((t0 + t1) + t2) + t3) * 0.25f;
  float neg = fmaxf(-obs_dd, -obs_mm);
  if (neg == 0.0f) neg = fminf(-obs_dd, -obs_mm);
  float pos = fminf(obs_dm, obs_md);
  if (pos == 0.0f) pos = fmaxf(obs_dm, obs_md);
  const float denom = d < 0.0f ? neg : pos;
  d_prime = d / denom;
  r2 = (d * d) / (((pa_major * pa_minor) * pb_major) * pb_minor);
}

// Whether a site has more than one distinct allele (aux column 2).
__device__ __forceinline__ bool polymorphic(const Params& p, int64_t site) {
  return p.auxc[site * 3 + 2] > 1;
}

// Finalize one pair (pallas_ld.py:946-969): `keep` = both sites
// polymorphic, then the pair algebra and the strict upper triangle of true
// sites.
__device__ __forceinline__ void store_pair(const Params& p, int64_t kt, int ti,
                                           int tj, int li, int lj, bool keep,
                                           const float* cells) {
  const int tile = p.tile;
  const int64_t gi = (int64_t)ti * tile + li;
  const int64_t gj = (int64_t)tj * tile + lj;
  float d, dpr, r2v;
  pair_algebra(cells[0], cells[1], cells[2], cells[3], keep, d, dpr, r2v);
  keep = keep && gi < gj && gj < p.n_sites;
  const int64_t o = (kt * tile + li) * tile + lj;
  p.d[o] = d;
  p.dp[o] = dpr;
  p.r2[o] = r2v;
  p.keep[o] = keep ? 1 : 0;
}

// ---------------------------------------------------------------------------
// 1. The integer weight modes on wgmma.
// ---------------------------------------------------------------------------

constexpr int kWA = 64;              // A-side sites per CTA (32 per warpgroup)
constexpr int kWB = 32;              // B-side sites per CTA
constexpr int kWK = 128;             // sequence columns (bytes) per stage row
constexpr int kConsumers = 256;      // two consumer warpgroups
constexpr int kProducers = 128;      // one producer warpgroup
constexpr int kFinishers = 128;      // one epilogue warpgroup
// Registers per thread of each role after setmaxnreg: multiples of 8 that
// fill the SM's 65,536 (ptxas then spills nothing in any role).
constexpr int kConsumerRegs = 160;
constexpr int kProducerRegs = 96;
constexpr int kFinisherRegs = 96;
static_assert(kConsumers * kConsumerRegs + kProducers * kProducerRegs +
                      kFinishers * kFinisherRegs ==
                  65536,
              "setmaxnreg split");
constexpr int kPairs = kWA * kWB;    // site pairs per work item
constexpr int kARows = 2 * kWA;      // [maj; dmin] rows of the A sites
constexpr int kABytes = kARows * kWK;

// Sites whose code rows one codes-producer thread stages (kCodeSitesA of
// them on the A side).
constexpr int kCodeSites = (kWA + kWB) / (kProducers / 8);
constexpr int kCodeSitesA = kWA / (kProducers / 8);

// Shared memory of one CTA.  The preplaned entry keeps 4 operand stages
// in flight from L2; the codes entry 3 operand stages and 4 buffers of raw
// chunks, so 3 stages of code loads are in flight while one is built.
template <int NLEV, bool PRE>
struct Ring {
  static constexpr int kStages = PRE ? 4 : 3;
  static constexpr int kRawDepth = PRE ? 0 : 4;
  static constexpr int kBRows = 2 * kWB * NLEV;   // per level: [maj; dmin]
  static constexpr int kStageBytes = kABytes + kBRows * kWK;
  // The codes producer's raw chunks of one stage: its code chunks and the
  // q chunks of every level, 16 bytes each, in slots of its own.
  static constexpr int kRawBytes = (kCodeSites + NLEV) * kProducers * 16;
  // The f32 cells of one work item, handed to the epilogue warpgroup.
  static constexpr int kCellBytes = kPairs * 16;
  // Stages (1,024-byte aligned for the swizzle atom), the raw buffers, the
  // cells, then the full and empty mbarriers of the stages and the cells.
  static constexpr int kSmem = kStages * kStageBytes + kRawDepth * kRawBytes +
                               kCellBytes + 1024 + 2 * (kStages + 1) * 8;
};

// Byte offset of 16-byte chunk `ch` of operand row `row` in the 128-byte
// swizzled K-major layout: 8-row atoms of 1,024 bytes, chunk ch ^ (row % 8).
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  return (row >> 3) * 1024 + (row & 7) * 128 + ((ch ^ (row & 7)) << 4);
}

// Row of an operand, in groups of 8: row 16g + r is the maj row of site
// 8g + r of its block, row 16g + 8 + r its dmin row.
__device__ __forceinline__ int op_row(int site, int is_dmin) {
  return (site >> 3) * 16 + is_dmin * 8 + (site & 7);
}

// wgmma shared-memory descriptor: 128-byte swizzle, 8-row groups 1,024
// bytes apart (SBO), leading offset unused by the swizzled K-major layout.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait of one role on another lasts at most about one work item (well
// under a second even at the largest seq chunk); 10 s means a broken
// schedule.
constexpr uint64_t kWaitLimitNs = 10000000000ull;

// Wait for the phase of `bar` with the given parity to complete.  A wait
// that never ends (a broken schedule) traps after kWaitLimitNs, so the
// launch fails with an error instead of holding the card (a count of
// tries would not do: each try_wait may suspend the thread for a while).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((++tries & 63) == 0) {
      const uint64_t now = global_ns();
      if (start == 0)
        start = now;
      else if (now - start > kWaitLimitNs)
        __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// Copy `bytes` (<= the size) from src and zero-fill the rest.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma operations that own them.
template <int R>
__device__ __forceinline__ void fence_regs(int32_t* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 64*NLEV] (+)= A[64 x 32] * B[64*NLEV x 32]^T, s8 x s8 -> s32, both
// operands K-major in shared memory; scale_d == 0 starts a new sum.
__device__ __forceinline__ void wgmma_n64(int32_t* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(int32_t* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n192(int32_t* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int NLEV>
__device__ __forceinline__ void wgmma_levels(int32_t* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (NLEV == 1) wgmma_n64(d, da, db, scale_d);
  if constexpr (NLEV == 2) wgmma_n128(d, da, db, scale_d);
  if constexpr (NLEV == 3) wgmma_n192(d, da, db, scale_d);
}

// The stage schedule both roles walk: stages of kWK columns inside each
// reference seq chunk, the last one of a chunk possibly partial.
template <int STAGES>
struct Cursor {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Producer, preplaned entry, 4-byte staging (N_pad or seq_chunk not a
// multiple of 16): A rows from the planes of tile ti, B rows from xq level l
// of tile tj (unit weights: xq is the planes), one cp.async per word.
template <int NLEV>
__device__ __forceinline__ void stage_planes(const Params& p, int ti, int tj,
                                             int bi, int bj, int k0,
                                             int width, uint32_t sa, int pt) {
  constexpr int rows = kARows + 2 * kWB * NLEV;
  const int tile = p.tile;
  const int64_t level = (int64_t)2 * p.s_pad * p.n_pad;
  for (int it = pt; it < rows * 32; it += kProducers) {
    const int row = it >> 5;
    const int w = it & 31;
    const int8_t* base;
    if (row < kARows) {
      const int m = row & 63;  // warpgroup row >> 6's rows: 32 sites
      const int loc = min(bi * kWA + (row >> 6) * 32 + ((m >> 4) << 3) +
                              (m & 7),
                          tile - 1);
      base = p.planes +
             ((int64_t)ti * 2 * tile + ((m >> 3) & 1) * tile + loc) * p.n_pad;
    } else {
      const int r = row - kARows;
      const int m = r & 63;
      const int loc = min(bj * kWB + ((m >> 4) << 3) + (m & 7), tile - 1);
      base = p.xq + (r >> 6) * level +
             ((int64_t)tj * 2 * tile + ((m >> 3) & 1) * tile + loc) * p.n_pad;
    }
    const int bytes = 4 * w < width ? 4 : 0;
    cp_async4(sa + swz(row, w >> 2) + 4 * (w & 3),
              base + (bytes > 0 ? k0 + 4 * w : 0), bytes);
  }
}

// The preplaned producer's source rows of one work item under 16-byte
// staging: thread pt copies chunk pt % 8 of the operand rows pt / 8 + 16 i
// (the first kARowsPer in the planes, the rest in xq seen as
// [nlev * 2 * s_pad] rows), whose stage offsets are swz(pt / 8, pt % 8) +
// 2,048 i.
template <int NLEV>
struct PlaneRows {
  static constexpr int kARowsPer = kARows / (kProducers / 8);
  static constexpr int kRows = kARowsPer + 2 * kWB * NLEV / (kProducers / 8);
  int row[kRows];
};

template <int NLEV>
__device__ __forceinline__ PlaneRows<NLEV> plane_rows(const Params& p, int ti,
                                                      int tj, int bi, int bj,
                                                      int pt) {
  PlaneRows<NLEV> pr;
  const int tile = p.tile;
#pragma unroll
  for (int i = 0; i < PlaneRows<NLEV>::kRows; ++i) {
    const int row = (pt >> 3) + 16 * i;
    if (row < kARows) {
      const int m = row & 63;  // warpgroup row >> 6's rows: 32 sites
      const int loc = min(bi * kWA + (row >> 6) * 32 + ((m >> 4) << 3) +
                              (m & 7),
                          tile - 1);
      pr.row[i] = ti * 2 * tile + ((m >> 3) & 1) * tile + loc;
    } else {
      const int r = row - kARows;
      const int m = r & 63;
      const int loc = min(bj * kWB + ((m >> 4) << 3) + (m & 7), tile - 1);
      pr.row[i] = (r >> 6) * 2 * p.s_pad + tj * 2 * tile +
                  ((m >> 3) & 1) * tile + loc;
    }
  }
  return pr;
}

template <int NLEV>
__device__ __forceinline__ void stage_plane_rows(const Params& p,
                                                 const PlaneRows<NLEV>& pr,
                                                 int k0, int width,
                                                 uint32_t sa, int pt) {
  const int ch = pt & 7;
  const int col = 16 * ch;
  const int bytes = min(max(width - col, 0), 16);
  const int off = bytes > 0 ? k0 + col : 0;
  const uint32_t dst = sa + swz(pt >> 3, ch);
#pragma unroll
  for (int i = 0; i < PlaneRows<NLEV>::kRows; ++i)
    cp_async16(dst + 2048 * i,
               (i < PlaneRows<NLEV>::kARowsPer ? p.planes : p.xq) +
                   (int64_t)pr.row[i] * p.n_pad + off,
               bytes);
}

__device__ __forceinline__ uint4 eq4(uint4 c, uint32_t b) {
  return make_uint4(__vcmpeq4(c.x, b), __vcmpeq4(c.y, b), __vcmpeq4(c.z, b),
                    __vcmpeq4(c.w, b));
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// The codes producer's sites of one work item: thread pt stages chunk
// pt % 8 of the A sites pt / 8 + 16 i (i < kCodeSitesA) and of the B sites
// pt / 8 + 16 (i - kCodeSitesA), so their row pointers (for the copies)
// and aux (for the build) stay in registers.
__device__ __forceinline__ int64_t code_site(const Params& p, int64_t kt,
                                            int bi, int bj, int pt, int i) {
  const bool is_a = i < kCodeSitesA;
  const int s = (pt >> 3) + 16 * (is_a ? i : i - kCodeSitesA);
  const int loc = min((is_a ? bi * kWA : bj * kWB) + s, p.tile - 1);
  return (int64_t)(is_a ? p.tile_i[kt] : p.tile_j[kt]) * p.tile + loc;
}

struct CodeRows {
  const int8_t* row[kCodeSites];
};

struct CodeAux {
  uint32_t maj[kCodeSites];    // the site's major allele in every byte
  uint32_t dmin[kCodeSites];   // its dominant minor allele
};

__device__ __forceinline__ CodeRows code_rows(const Params& p, int64_t kt,
                                              int bi, int bj, int pt) {
  CodeRows cr;
#pragma unroll
  for (int i = 0; i < kCodeSites; ++i)
    cr.row[i] = p.codes + code_site(p, kt, bi, bj, pt, i) * p.n_pad;
  return cr;
}

__device__ __forceinline__ CodeAux code_aux(const Params& p, int64_t kt,
                                            int bi, int bj, int pt) {
  CodeAux ca;
#pragma unroll
  for (int i = 0; i < kCodeSites; ++i) {
    const int64_t site = code_site(p, kt, bi, bj, pt, i);
    ca.maj[i] = (uint32_t)p.auxc[site * 3 + 0] * 0x01010101u;
    ca.dmin[i] = (uint32_t)p.auxc[site * 3 + 1] * 0x01010101u;
  }
  return ca;
}

// Copy the raw chunks of one stage (columns [k0 + 16 (pt % 8), +16)) into
// `raw` with cp.async, zero past the stage width; q through L1, where the
// 16 threads of one chunk share it.
template <int NLEV, bool VEC16>
__device__ __forceinline__ void fetch_codes(const Params& p,
                                            const CodeRows& cs, int k0,
                                            int width, uint32_t raw, int pt) {
  const int col = 16 * (pt & 7);
#pragma unroll
  for (int j = 0; j < kCodeSites + NLEV; ++j) {
    const bool is_q = j >= kCodeSites;
    const int8_t* row =
        is_q ? p.q + (int64_t)(j - kCodeSites) * p.n_pad : cs.row[j];
    const uint32_t dst = raw + (j * kProducers + pt) * 16;
    if (VEC16) {
      const int bytes = min(max(width - col, 0), 16);
      const int8_t* src = row + (bytes > 0 ? k0 + col : 0);
      if (is_q)
        cp_async16_ca(dst, src, bytes);
      else
        cp_async16(dst, src, bytes);
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int bytes = col + 4 * w < width ? 4 : 0;
        cp_async4(dst + 4 * w, row + (bytes > 0 ? k0 + col + 4 * w : 0),
                  bytes);
      }
    }
  }
}

// Build one stage from this thread's landed raw chunks: indicator bytes
// from one __vcmpeq4 per code word against the site's major (dmin)
// allele, zero past the stage width; A rows = indicator (0/1), B rows per
// level = indicator & q_l (0xff bytes select q).
template <int NLEV>
__device__ __forceinline__ void build_codes(const CodeAux& cs, int width,
                                            const uint8_t* raw, uint8_t* sa,
                                            int pt) {
  const int ch = pt & 7;
  const int col = 16 * ch;
  const uint4 valid = make_uint4(col < width ? ~0u : 0u,
                                 col + 4 < width ? ~0u : 0u,
                                 col + 8 < width ? ~0u : 0u,
                                 col + 12 < width ? ~0u : 0u);
  const uint4 ones = make_uint4(0x01010101u, 0x01010101u, 0x01010101u,
                                0x01010101u);
  const uint4* slot = reinterpret_cast<const uint4*>(raw) + pt;
  uint4 q[NLEV];
#pragma unroll
  for (int l = 0; l < NLEV; ++l) q[l] = slot[(kCodeSites + l) * kProducers];
#pragma unroll
  for (int i = 0; i < kCodeSites; ++i) {
    const uint4 code = slot[i * kProducers];
    const uint4 em = and4(eq4(code, cs.maj[i]), valid);
    const uint4 ed = and4(eq4(code, cs.dmin[i]), valid);
    if (i < kCodeSitesA) {
      // Warpgroup s / 32 owns A rows [64 * (s / 32), +64).
      const int s = (pt >> 3) + 16 * i;
      const int r = (s >> 5) * 64 + op_row(s & 31, 0);
      *reinterpret_cast<uint4*>(sa + swz(r, ch)) = and4(em, ones);
      *reinterpret_cast<uint4*>(sa + swz(r + 8, ch)) = and4(ed, ones);
    } else {
      const int s = (pt >> 3) + 16 * (i - kCodeSitesA);
      uint8_t* sb = sa + kABytes;
#pragma unroll
      for (int l = 0; l < NLEV; ++l) {
        const int r = l * 2 * kWB + op_row(s, 0);
        *reinterpret_cast<uint4*>(sb + swz(r, ch)) = and4(em, q[l]);
        *reinterpret_cast<uint4*>(sb + swz(r + 8, ch)) = and4(ed, q[l]);
      }
    }
  }
}

// One work item = one 64 x 32 site-pair block of one tile pair.
struct Item {
  int64_t kt;
  int bi, bj;
};

__device__ __forceinline__ Item item_of(int item, int tile) {
  const int nb = (tile + kWB - 1) / kWB;
  const int per_tile = ((tile + kWA - 1) / kWA) * nb;
  return {item / per_tile, (item % per_tile) / nb, (item % per_tile) % nb};
}

// The stages of a CTA in order: the emitting work items blockIdx.x,
// + gridDim.x, ...; in each, the reference seq chunks and their kWK-column
// steps.
struct StageWalk {
  int item, c0, k0;
  int64_t kt;
  int bi, bj;
  // The first stage of the first emitting item at or after `item`.
  __device__ void settle(const Params& p, int n_items) {
    c0 = k0 = 0;
    for (; item < n_items; item += gridDim.x) {
      const Item w = item_of(item, p.tile);
      if (p.emit[w.kt] != 0) {
        kt = w.kt;
        bi = w.bi;
        bj = w.bj;
        return;
      }
    }
  }
  __device__ int width(const Params& p) const {
    return min(kWK, c0 + p.seq_chunk - k0);
  }
  // Step to the next stage; true when it starts another item.
  __device__ bool next(const Params& p, int n_items) {
    k0 += kWK;
    if (k0 < c0 + p.seq_chunk) return false;
    c0 += p.seq_chunk;
    k0 = c0;
    if (c0 < p.n_pad) return false;
    item += gridDim.x;
    settle(p, n_items);
    return true;
  }
};

// Producer warpgroup, preplaned entry: per stage, once the consumers have
// released it, cp.async the operand rows; the full barrier completes when
// they have landed.
template <int NLEV, bool VEC16>
__device__ __forceinline__ void produce_planes(const Params& p, int n_items,
                                               uint32_t stages, uint32_t full,
                                               uint32_t empty, int pt) {
  using RingT = Ring<NLEV, true>;
  Cursor<RingT::kStages> cur;
  StageWalk at;
  at.item = blockIdx.x;
  at.settle(p, n_items);
  PlaneRows<NLEV> pr;
  bool fresh = true;
  for (; at.item < n_items; fresh = at.next(p, n_items)) {
    const int ti = p.tile_i[at.kt];
    const int tj = p.tile_j[at.kt];
    if (VEC16 && fresh) pr = plane_rows<NLEV>(p, ti, tj, at.bi, at.bj, pt);
    mbar_wait(empty + 8 * cur.stage, cur.phase ^ 1);
    const uint32_t sa = stages + cur.stage * RingT::kStageBytes;
    if (VEC16)
      stage_plane_rows<NLEV>(p, pr, at.k0, at.width(p), sa, pt);
    else
      stage_planes<NLEV>(p, ti, tj, at.bi, at.bj, at.k0, at.width(p), sa, pt);
    cp_async_arrive(full + 8 * cur.stage);
    cur.next();
  }
  cp_async_wait<0>();
}

// Producer warpgroup, codes entry: the raw chunks of the next kRawDepth - 1
// stages are in flight (cp.async into the raw buffers; walk `ahead`) while
// this stage (walk `at`) is built.
template <int NLEV, bool VEC16>
__device__ __forceinline__ void produce_codes(const Params& p, int n_items,
                                              uint8_t* gst, uint32_t raw,
                                              uint8_t* graw, uint32_t full,
                                              uint32_t empty, int pt) {
  using RingT = Ring<NLEV, false>;
  constexpr int kDepth = RingT::kRawDepth;
  StageWalk at;
  at.item = blockIdx.x;
  at.settle(p, n_items);
  if (at.item >= n_items) return;
  StageWalk ahead = at;
  CodeRows rows = code_rows(p, ahead.kt, ahead.bi, ahead.bj, pt);
  CodeAux aux = code_aux(p, at.kt, at.bi, at.bj, pt);
  // Fetch into buffer `slot` and step `ahead` on.
  auto fetch = [&](int slot) {
    if (ahead.item < n_items) {
      fetch_codes<NLEV, VEC16>(p, rows, ahead.k0, ahead.width(p),
                               raw + slot * RingT::kRawBytes, pt);
      if (ahead.next(p, n_items) && ahead.item < n_items)
        rows = code_rows(p, ahead.kt, ahead.bi, ahead.bj, pt);
    }
    cp_async_commit();  // one group per stage, empty past the end
  };
#pragma unroll
  for (int i = 0; i < kDepth - 1; ++i) fetch(i);
  Cursor<RingT::kStages> cur;
  int slot = 0;  // this stage's raw buffer
  while (at.item < n_items) {
    fetch(slot == 0 ? kDepth - 1 : slot - 1);
    cp_async_wait<kDepth - 1>();  // this stage's raw chunks have landed
    mbar_wait(empty + 8 * cur.stage, cur.phase ^ 1);
    build_codes<NLEV>(aux, at.width(p), graw + slot * RingT::kRawBytes,
                      gst + cur.stage * RingT::kStageBytes, pt);
    fence_proxy_async();  // generic-proxy writes -> wgmma reads
    mbar_arrive(full + 8 * cur.stage);
    cur.next();
    slot = slot == kDepth - 1 ? 0 : slot + 1;
    if (at.next(p, n_items) && at.item < n_items)
      aux = code_aux(p, at.kt, at.bi, at.bj, pt);
  }
}

// Persistent: each CTA walks work items blockIdx.x, + gridDim.x, ...; the
// stage ring runs on across items, so the producer fills the next item's
// first stages while the consumers finish the last one, and the epilogue
// warpgroup runs an item's pair algebra and stores while the consumers
// contract the next.
template <int NLEV, bool PRE, bool VEC16>
__global__ void __launch_bounds__(kConsumers + kProducers + kFinishers, 1)
ld_majmin_wgmma(const Params p, int n_items) {
  using RingT = Ring<NLEV, PRE>;
  constexpr int kStages = RingT::kStages;
  constexpr int kStageBytes = RingT::kStageBytes;
  constexpr int R = 32 * NLEV;        // accumulator registers per thread
  extern __shared__ uint8_t smem_raw[];

  const int tile = p.tile;
  const int tid = threadIdx.x;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t rawbuf = base + kStages * kStageBytes;
  const uint32_t cells = rawbuf + RingT::kRawDepth * RingT::kRawBytes;
  float4* const gcells = reinterpret_cast<float4*>(gbase + (cells - base));
  const uint32_t full = cells + RingT::kCellBytes;
  const uint32_t empty = full + 8 * (kStages + 1);
  // full[kStages] / empty[kStages]: the cells, filled by the consumers and
  // released by the epilogue warpgroup.
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kProducers);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_init(full + 8 * kStages, kConsumers);
    mbar_init(empty + 8 * kStages, kFinishers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers + kProducers) {
    // Epilogue warpgroup: per item the pair algebra and the stores of the
    // item's pairs (A site ea + 4m, m < kPer; B site eb: consecutive
    // threads on consecutive B sites); the keep blocks of padding tile
    // pairs are zeroed.  The sites' aux is read while the consumers
    // contract, before the cells are waited for.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
                     kFinisherRegs));
    constexpr int kPer = kPairs / kFinishers;
    constexpr int kStep = kFinishers / kWB;
    const int et = tid - kConsumers - kProducers;
    const int ea = et / kWB;
    const int eb = et % kWB;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Item w = item_of(item, tile);
      const bool emit = p.emit[w.kt] != 0;
      const int ti = p.tile_i[w.kt];
      const int tj = p.tile_j[w.kt];
      const int lj = w.bj * kWB + eb;
      const int li0 = w.bi * kWA + ea;
      uint32_t poly = 0;  // bit m: A site li0 + kStep m and the B site
      if (emit && lj < tile && polymorphic(p, (int64_t)tj * tile + lj)) {
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          const int li = li0 + kStep * m;
          if (li < tile && polymorphic(p, (int64_t)ti * tile + li))
            poly |= 1u << m;
        }
      }
      if (emit) {
        mbar_wait(full + 8 * kStages, phase);
        phase ^= 1;
      }
      if (lj < tile) {
#pragma unroll 4
        for (int m = 0; m < kPer; ++m) {
          const int li = li0 + kStep * m;
          if (li >= tile) break;
          if (!emit) {
            p.keep[(w.kt * tile + li) * tile + lj] = 0;
            continue;
          }
          const float4 c = gcells[(ea + kStep * m) * kWB + eb];
          const float cell[4] = {c.x, c.y, c.z, c.w};
          store_pair(p, w.kt, ti, tj, li, lj, (poly >> m) & 1u, cell);
        }
      }
      if (emit) mbar_arrive(empty + 8 * kStages);
    }
  } else if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
                     kProducerRegs));
    const int pt = tid - kConsumers;
    if (PRE)
      produce_planes<NLEV, VEC16>(p, n_items, base, full, empty, pt);
    else
      produce_codes<NLEV, VEC16>(p, n_items, gbase, rawbuf,
                                 gbase + (rawbuf - base), full, empty, pt);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
                     kConsumerRegs));
    // Consumer thread -> its 8 pairs of an item: A site li, B sites
    // lj0 + 8h + c.
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    float a[NLEV];
#pragma unroll
    for (int l = 0; l < NLEV; ++l) a[l] = p.scale[l];
    int32_t D[R];
    // The f32 running cells of this thread's pairs live in the epilogue's
    // buffer (pair (A site a, B site b) of the item at a * kWB + b), which
    // keeps the consumers' registers for the accumulators.
    float4* const run = gcells + (wg * 32 + 8 * warp + (lane >> 2)) * kWB +
                        2 * (lane & 3);
    Cursor<kStages> cur;
    uint32_t cell_phase = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      if (p.emit[item_of(item, tile).kt] == 0) continue;
      for (int c0 = 0; c0 < p.n_pad; c0 += p.seq_chunk) {
        int scale_d = 0;   // the chunk's first wgmma starts a new sum
        int prev = -1;     // the stage whose wgmma group may still run
        // Defined here, D is dead between a chunk's combine and the next
        // chunk, which frees its registers for the epilogue.
#pragma unroll
        for (int i = 0; i < R; ++i) D[i] = 0;
        for (int k0 = c0; k0 < c0 + p.seq_chunk; k0 += kWK) {
          mbar_wait(full + 8 * cur.stage, cur.phase);
          fence_proxy_async();
          const uint32_t sa = base + cur.stage * kStageBytes;
          const uint64_t da = sw128_desc(sa + wg * 64 * kWK);
          const uint64_t db = sw128_desc(sa + kABytes);
          fence_regs<R>(D);
          wgmma_fence();
          // All four 32-column steps: columns past a partial stage's
          // width are zero in both operands.  Each step moves the
          // descriptors 32 bytes further into the 128-byte rows.
          wgmma_levels<NLEV>(D, da, db, scale_d);
          wgmma_levels<NLEV>(D, da + 2, db + 2, 1);
          wgmma_levels<NLEV>(D, da + 4, db + 4, 1);
          wgmma_levels<NLEV>(D, da + 6, db + 6, 1);
          wgmma_commit();
          scale_d = 1;
          fence_regs<R>(D);
          wgmma_wait<1>();
          fence_regs<R>(D);
          if (prev >= 0) mbar_arrive(empty + 8 * prev);
          prev = cur.stage;
          cur.next();
        }
        wgmma_wait<0>();
        fence_regs<R>(D);
        mbar_arrive(empty + 8 * prev);
        if (c0 == 0) {
          // The epilogue warpgroup has read the last item's cells.
          mbar_wait(empty + 8 * kStages, cell_phase ^ 1);
          cell_phase ^= 1;
        }

        // Combine once per seq chunk (pallas_ld.py:912-920): fragment
        // entry 4k + 2*ia + c holds row-half ia (A maj / dmin) and column c
        // of n8 block k = 8l + 2h + ib (level l, B group h, B maj / dmin).
#pragma unroll
        for (int h = 0; h < 4; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float cell[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ia = e >> 1, ib = e & 1;
              cell[e] = a[0] * (float)D[4 * (2 * h + ib) + 2 * ia + c];
#pragma unroll
              for (int l = 1; l < NLEV; ++l)
                cell[e] = cell[e] + a[l] * (float)D[4 * (8 * l + 2 * h + ib) +
                                                     2 * ia + c];
            }
            float4 v = make_float4(cell[0], cell[1], cell[2], cell[3]);
            if (c0 > 0) {
              const float4 acc = run[8 * h + c];
              v = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z,
                              acc.w + v.w);
            }
            run[8 * h + c] = v;
          }
      }
      // Hand the item's cells to the epilogue warpgroup.
      mbar_arrive(full + 8 * kStages);
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

template <int NLEV, bool PRE, bool VEC16>
int launch_wgmma(const Params& p, int k, cudaStream_t stream) {
  constexpr int smem = Ring<NLEV, PRE>::kSmem;
  auto kern = ld_majmin_wgmma<NLEV, PRE, VEC16>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t items = (int64_t)k * ((p.tile + kWA - 1) / kWA) *
                        ((p.tile + kWB - 1) / kWB);
  const int grid = (int)(items < sm_count() ? items : sm_count());
  kern<<<grid, kConsumers + kProducers + kFinishers, smem, stream>>>(
      p, (int)items);
  return (int)cudaGetLastError();
}

template <int NLEV, bool PRE>
int launch_int(const Params& p, int k, cudaStream_t stream) {
  // 16-byte staging needs every stage start 16-byte aligned.
  if (p.n_pad % 16 == 0 && p.seq_chunk % 16 == 0)
    return launch_wgmma<NLEV, PRE, true>(p, k, stream);
  return launch_wgmma<NLEV, PRE, false>(p, k, stream);
}

// ---------------------------------------------------------------------------
// 2. The float weight modes on CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kBM = 32;            // A-side sites per CTA
constexpr int kBN = 32;            // B-side sites per CTA
constexpr int kThreads = 256;      // 16 x 16 threads, 2 x 2 pairs each
constexpr int kKS = 64;            // sequence columns staged per step
constexpr int kKW = kKS / 4;       // packed 32-bit words per staged row
constexpr int kKWP = kKW + 1;      // padded row stride: no bank conflicts

// 4-bit mask of a word of four 0/1 bytes (byte b -> bit b): the multiply
// moves each byte's bit to bits 24..27 and leaves its cross terms below.
__device__ __forceinline__ uint32_t mask4(uint32_t x) {
  return (x * 0x01020408u) >> 24;
}

// NFLT f32 passes over the indicators sI (weights staged separately as
// tables); under LO (lo_int8, NLEV = 1) also one int8 pass over sA =
// indicator * q.  PRE selects the operand source: false = codes + aux (the
// _ld_kernel_mm build), true = precomputed planes (the _ld_kernel_mm_pre
// inputs; under LO the planes and the q row, with planes * q built while
// staging, as JAX builds xq in-kernel for this mode: the same int8 bytes
// without a second [2*s_pad, n_pad] array in device memory).
template <int NLEV, int NFLT, bool PRE>
__global__ void __launch_bounds__(kThreads)
ld_majmin_dp4a(const Params p) {
  static_assert(NFLT > 0 && NLEV <= 1, "the integer modes run on wgmma");
  constexpr bool LO = NLEV > 0;
  __shared__ uint32_t sI[2][kBM][kKWP];
  __shared__ uint32_t sA[LO ? 2 : 1][kBM][kKWP];
  __shared__ uint32_t sB[2][kBN][kKWP];
  // Per staged word and 4-bit byte mask, the f32 sum of the selected
  // weights of its four columns, added in column order.
  __shared__ float sT[NFLT][kKW][16];
  __shared__ int32_t sAuxA[kBM][2];
  __shared__ int32_t sAuxB[kBN][2];

  const int bps = (p.tile + kBM - 1) / kBM;
  const int64_t kt = blockIdx.x / (bps * bps);
  const int rem = blockIdx.x % (bps * bps);
  const int bi = rem / bps;
  const int bj = rem % bps;
  const int ti = p.tile_i[kt];
  const int tj = p.tile_j[kt];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int tile = p.tile;

  int li[2], lj[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) li[r] = bi * kBM + ty + 16 * r;
#pragma unroll
  for (int c = 0; c < 2; ++c) lj[c] = bj * kBN + tx + 16 * c;

  if (p.emit[kt] == 0) {
    // Padding tile pair: only its keep block is zeroed.
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (li[r] < tile && lj[c] < tile)
          p.keep[(kt * tile + li[r]) * tile + lj[c]] = 0;
    return;
  }

  if (!PRE) {
    if (tid < kBM) {
      const int loc = bi * kBM + tid;
      const int64_t site = (int64_t)ti * tile + loc;
      sAuxA[tid][0] = loc < tile ? p.auxc[site * 3 + 0] : -1;
      sAuxA[tid][1] = loc < tile ? p.auxc[site * 3 + 1] : -1;
    } else if (tid < kBM + kBN) {
      const int loc = bj * kBN + (tid - kBM);
      const int64_t site = (int64_t)tj * tile + loc;
      sAuxB[tid - kBM][0] = loc < tile ? p.auxc[site * 3 + 0] : -1;
      sAuxB[tid - kBM][1] = loc < tile ? p.auxc[site * 3 + 1] : -1;
    }
  }

  int32_t J[2][2][4];
  float F[NFLT][2][2][4];
  float acc[2][2][4];

  for (int c0 = 0; c0 < p.n_pad; c0 += p.seq_chunk) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          J[r][c][e] = 0;
#pragma unroll
          for (int f = 0; f < NFLT; ++f) F[f][r][c][e] = 0.0f;
        }

    for (int k0 = c0; k0 < c0 + p.seq_chunk; k0 += kKS) {
      const int width = min(kKS, c0 + p.seq_chunk - k0);
      __syncthreads();  // the previous step's operands are consumed
      // Stage the A and B rows of this step: kBM * kKW words per side,
      // zero beyond the tile edge and past the chunk end.
      for (int s = tid; s < kBM * kKW; s += kThreads) {
        const int row = s / kKW;
        const int w = s % kKW;
        const int64_t col = k0 + 4 * w;
        const bool in_col = 4 * w < width;
        const int la = bi * kBM + row;
        const int lb = bj * kBN + row;
        const bool va = in_col && la < tile;
        const bool vb = in_col && lb < tile;
        if (PRE) {
          const int64_t ra = (int64_t)ti * 2 * tile + la;
          const int64_t rb = (int64_t)tj * 2 * tile + lb;
          const uint32_t pm = va ? ld_word(p.planes, ra * p.n_pad + col) : 0u;
          const uint32_t pd =
              va ? ld_word(p.planes, (ra + tile) * p.n_pad + col) : 0u;
          if constexpr (LO) {
            // 0/1 plane bytes times 0xff are byte masks (no carries).
            const uint32_t qw = va ? ld_word(p.xq, col) : 0u;
            sA[0][row][w] = (pm * 0xffu) & qw;
            sA[1][row][w] = (pd * 0xffu) & qw;
          }
          sI[0][row][w] = pm;
          sI[1][row][w] = pd;
          sB[0][row][w] = vb ? ld_word(p.planes, rb * p.n_pad + col) : 0u;
          sB[1][row][w] =
              vb ? ld_word(p.planes, (rb + tile) * p.n_pad + col) : 0u;
        } else {
          // Indicator bytes from one compare per byte: __vcmpeq4 gives 0xff
          // where the code equals the site's major (dmin) allele.
          uint32_t ema = 0u, eda = 0u, emb = 0u, edb = 0u;
          if (va) {
            const uint32_t code =
                ld_word(p.codes, ((int64_t)ti * tile + la) * p.n_pad + col);
            ema = __vcmpeq4(code, (uint32_t)sAuxA[row][0] * 0x01010101u);
            eda = __vcmpeq4(code, (uint32_t)sAuxA[row][1] * 0x01010101u);
          }
          if (vb) {
            const uint32_t code =
                ld_word(p.codes, ((int64_t)tj * tile + lb) * p.n_pad + col);
            emb = __vcmpeq4(code, (uint32_t)sAuxB[row][0] * 0x01010101u);
            edb = __vcmpeq4(code, (uint32_t)sAuxB[row][1] * 0x01010101u);
          }
          if constexpr (LO) {
            const uint32_t qw = va ? ld_word(p.q, col) : 0u;
            sA[0][row][w] = ema & qw;  // one-hot * q fits int8
            sA[1][row][w] = eda & qw;
          }
          sI[0][row][w] = ema & 0x01010101u;
          sI[1][row][w] = eda & 0x01010101u;
          sB[0][row][w] = emb & 0x01010101u;
          sB[1][row][w] = edb & 0x01010101u;
        }
      }
      for (int s = tid; s < NFLT * kKW * 16; s += kThreads) {
        const int f = s / (kKW * 16);
        const int w = (s / 16) % kKW;
        const int m = s % 16;
        float t = 0.0f;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (((m >> b) & 1) && 4 * w + b < width)
            t = t + p.wf[(int64_t)f * p.n_pad + k0 + 4 * w + b];
        sT[f][w][m] = t;
      }
      __syncthreads();

      if constexpr (LO) {
#pragma unroll 4
        for (int w = 0; w < kKW; ++w) {
          int bm[2], bd[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            bm[c] = (int)sB[0][tx + 16 * c][w];
            bd[c] = (int)sB[1][tx + 16 * c][w];
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int am = (int)sA[0][ty + 16 * r][w];
            const int ad = (int)sA[1][ty + 16 * r][w];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              J[r][c][0] = __dp4a(am, bm[c], J[r][c][0]);
              J[r][c][1] = __dp4a(am, bd[c], J[r][c][1]);
              J[r][c][2] = __dp4a(ad, bm[c], J[r][c][2]);
              J[r][c][3] = __dp4a(ad, bd[c], J[r][c][3]);
            }
          }
        }
      }
      for (int w = 0; w < kKW; ++w) {
        uint32_t am[2], ad[2], bm[2], bd[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          am[r] = sI[0][ty + 16 * r][w];
          ad[r] = sI[1][ty + 16 * r][w];
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          bm[c] = sB[0][tx + 16 * c][w];
          bd[c] = sB[1][tx + 16 * c][w];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint32_t m0 = mask4(am[r] & bm[c]);
            const uint32_t m1 = mask4(am[r] & bd[c]);
            const uint32_t m2 = mask4(ad[r] & bm[c]);
            const uint32_t m3 = mask4(ad[r] & bd[c]);
#pragma unroll
            for (int f = 0; f < NFLT; ++f) {
              F[f][r][c][0] += sT[f][w][m0];
              F[f][r][c][1] += sT[f][w][m1];
              F[f][r][c][2] += sT[f][w][m2];
              F[f][r][c][3] += sT[f][w][m3];
            }
          }
      }
    }

    // Combine once per seq chunk (pallas_ld.py:926-930, 937-940).
    const float a0 = LO ? p.scale[0] : 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float cells;
          if (LO) {
            cells = F[0][r][c][e] + a0 * (float)J[r][c][e];
          } else {
            cells = F[0][r][c][e];
#pragma unroll
            for (int f = 1; f < NFLT; ++f) cells = cells + F[f][r][c][e];
          }
          acc[r][c][e] = c0 == 0 ? cells : acc[r][c][e] + cells;
        }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (li[r] < tile && lj[c] < tile)
        store_pair(p, kt, ti, tj, li[r], lj[c],
                   polymorphic(p, (int64_t)ti * tile + li[r]) &&
                       polymorphic(p, (int64_t)tj * tile + lj[c]),
                   acc[r][c]);
}

template <int NLEV, int NFLT, bool PRE>
int launch_dp4a(const Params& p, int k, cudaStream_t stream) {
  const int bps = (p.tile + kBM - 1) / kBM;
  const int64_t blocks = (int64_t)k * bps * bps;
  ld_majmin_dp4a<NLEV, NFLT, PRE><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The body by weight mode: the integer modes (nflt == 0) on wgmma, the
// float modes on CUDA cores.
template <bool PRE>
int dispatch(const Params& p, int k, int nlev, int nflt, cudaStream_t stream) {
  if (k <= 0) return 0;
  if (nflt == 0 && nlev == 1) return launch_int<1, PRE>(p, k, stream);
  if (nflt == 0 && nlev == 2) return launch_int<2, PRE>(p, k, stream);
  if (nflt == 0 && nlev == 3) return launch_int<3, PRE>(p, k, stream);
  if (nlev == 0 && nflt == 1) return launch_dp4a<0, 1, PRE>(p, k, stream);
  if (nlev == 0 && nflt == 2) return launch_dp4a<0, 2, PRE>(p, k, stream);
  if (nlev == 1 && nflt == 1) return launch_dp4a<1, 1, PRE>(p, k, stream);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* scale, const void* wf, const void* auxc,
                   const void* tile_i, const void* tile_j, const void* emit,
                   void* d, void* dp, void* r2, void* keep, int tile,
                   int n_sites, int s_pad, int n_pad, int seq_chunk) {
  Params p = {};
  p.scale = static_cast<const float*>(scale);
  p.wf = static_cast<const float*>(wf);
  p.auxc = static_cast<const int32_t*>(auxc);
  p.tile_i = static_cast<const int32_t*>(tile_i);
  p.tile_j = static_cast<const int32_t*>(tile_j);
  p.emit = static_cast<const int32_t*>(emit);
  p.d = static_cast<float*>(d);
  p.dp = static_cast<float*>(dp);
  p.r2 = static_cast<float*>(r2);
  p.keep = static_cast<int8_t*>(keep);
  p.tile = tile;
  p.n_sites = n_sites;
  p.s_pad = s_pad;
  p.n_pad = n_pad;
  p.seq_chunk = seq_chunk;
  return p;
}

}  // namespace

// Entry for _ld_kernel_mm: operands built from the codes and the aux.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int ld_majmin_codes(const void* codes, const void* q,
                               const void* scale, const void* wf,
                               const void* auxc, const void* tile_i,
                               const void* tile_j, const void* emit, void* d,
                               void* dp, void* r2, void* keep, int k, int tile,
                               int n_sites, int s_pad, int n_pad, int seq_chunk,
                               int nlev, int nflt, void* stream) {
  Params p = make_params(scale, wf, auxc, tile_i, tile_j, emit, d, dp, r2,
                         keep, tile, n_sites, s_pad, n_pad, seq_chunk);
  p.codes = static_cast<const int8_t*>(codes);
  p.q = static_cast<const int8_t*>(q);
  return dispatch<false>(p, k, nlev, nflt, static_cast<cudaStream_t>(stream));
}

// Entry for _ld_kernel_mm_pre: operands read from precomputed planes / xq
// (unit weights: xq is the planes; lo_int8, nlev = nflt = 1: xq is the
// [n_pad] int8 q row).
extern "C" int ld_majmin_planes(const void* planes, const void* xq,
                                const void* scale, const void* wf,
                                const void* auxc, const void* tile_i,
                                const void* tile_j, const void* emit, void* d,
                                void* dp, void* r2, void* keep, int k,
                                int tile, int n_sites, int s_pad, int n_pad,
                                int seq_chunk, int nlev, int nflt,
                                void* stream) {
  Params p = make_params(scale, wf, auxc, tile_i, tile_j, emit, d, dp, r2,
                         keep, tile, n_sites, s_pad, n_pad, seq_chunk);
  p.planes = static_cast<const int8_t*>(planes);
  p.xq = static_cast<const int8_t*>(xq);
  return dispatch<true>(p, k, nlev, nflt, static_cast<cudaStream_t>(stream));
}
