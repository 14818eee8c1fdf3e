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
// sum_l a_l * J_l once per seq_chunk), or NFLT bf16 passes accumulated in f32
// (bf16-exact weights: one pass; split_bf16: w_hi and w_lo passes, summed
// once per seq_chunk), or both (lo_int8, NLEV = NFLT = 1: the pass of
// w_hi = bf16(w) plus one of the quantized residual q, combined as
// F + alpha * J once per seq_chunk, pallas_ld.py:926-930 and 1173-1177).
//
// One body, ld_majmin_wgmma, runs every mode on the tensor cores: the
// integer modes (NFLT = 0) on int8 wgmma, the float modes (NFLT > 0) on bf16
// wgmma.  dispatch builds no other body and falls back to none.
//
// What bounds it.  Operations: int8x3 is 4 cells x 3 levels x 2 operations
// per pair and column, 0.43 ms for the 528 tile pairs of N_pad = 1,024,
// T = 256 at the 1,979 TOP/s int8 peak (split_bf16: 2 bf16 passes, 0.57 ms
// at 989 TFLOP/s), against 0.13 ms of HBM traffic (13 output bytes per
// pair).  Inside the SM, shared memory: per stage the wgmma of both
// consumer warpgroups read their A rows and both the same B rows, and the
// producer writes every operand byte once, ~139 bytes per clock at the full
// int8 rate against the SM's 128, so even a perfect schedule stays under
// ~90 % of the peak.  The preplaned integer entry reads 320 operand bytes
// per column per CTA from L2; the codes entry reads 96 code bytes + the
// weight bytes but builds its operands on one warpgroup's CUDA cores, which
// sets its pace (PERF.md); the float modes build their operands in both
// entries, at twice the shared-memory bytes per column, and at the bf16
// peak their wgmma operand reads alone take 96 (two passes) to 128
// (bf16-exact) of those 128 bytes per clock.
//
// What the design does.  One CTA owns 64 A sites x 32 B sites of a tile
// pair.  A = the [maj; dmin] 0/1 indicator rows of the A sites, M = 64 per
// consumer warpgroup (32 sites); B = the indicator rows of the B sites times
// each weight pass (int8 q_l, or the bf16 bits of a float pass), stacked
// along N, so one wgmma.m64n{64,128,192}k32.s32.s8.s8 per 32 columns, or
// wgmma.m64n{64,128}k16.f32.bf16.bf16 per 16 columns, gives every pass's
// joints of the warpgroup's 1,024 pairs (each product 0/1 x weight is exact
// on either operand).  Rows are ordered in groups of 8 (eight sites' maj
// rows, then the same sites' dmin rows) on both sides, so the accumulator
// fragment (rows r, r+8; columns {c, c+1} + 8k) gives each thread all 4
// cells x passes of its own 8 pairs: the combine needs no exchange.  A ring
// of shared-memory stages of 128-byte swizzled rows (the wgmma K-major
// layout: 128 int8 or 64 bf16 columns per stage) is filled by one producer
// warpgroup (two in the float modes: one builds the A sites' rows, one the
// B sites') and drained by two consumer warpgroups through mbarriers (full:
// the producer's writes or cp.async completions; empty: the consumers'
// wgmma reads done).  The preplaned integer entry stages planes / xq rows
// with cp.async into 4 stages (16 bytes where N_pad and seq_chunk are
// multiples of 16, else 4 bytes; zero-filled past the chunk end).  Every
// other (entry, mode) builds its operands: the producer keeps 3 stages of
// raw loads in flight (cp.async into raw buffers: code rows, or under the
// float modes the planes' maj and dmin rows; the weight rows) while it
// builds the landed one into one of 3 operand stages: byte masks from
// __vcmpeq4 against the per-site aux (codes) or from the 0/1 plane bytes
// times 0xff (planes), then int8 A = mask & 1 and B = mask & q_l, or bf16
// halfword masks (byte_perm) and A = mask & bf16(1.0), B = mask & the
// pass's bf16 weight bits, written in the swizzled layout.  Rows past the
// tile edge read the tile's last site and are masked at the store.  At each
// reference seq chunk end the consumers wait for their wgmma groups and
// combine the joints into the f32 running cells, which live in a shared
// buffer (registers stay for the accumulators); after an item's last chunk
// a fourth, epilogue warpgroup runs the pair algebra and the stores from
// that buffer while the consumers contract the next item.  The CTAs are
// persistent (one per SM, items strided by the grid), so the ring runs on
// across items.  setmaxnreg gives the consumers 160 registers in the
// integer modes (at most 96 accumulators: int8x3's s32) and 120 in the
// float modes (at most 64: split_bf16's and lo_int8's f32), the producers
// and the epilogue 96 or 80 each.
//
// lo_int8's residual level q rides as a second bf16 pass beside w_hi: q is
// an integer in [-127, 127], exact in bf16, and its joint J (|J| <= 127 *
// seq_chunk < 2^24, driver.py MAX_SEQ_CHUNK) is exact in the f32
// accumulator, so F + alpha * J takes the int8 pass's value while every
// stage holds one operand type (A is built once, not as bf16 and int8).
//
// Numerics that must match the JAX package bit for bit where it is exact:
//   * The int32 joints are exact; the f32 combine runs once per reference
//     seq chunk: cells = a1*J1 + a2*J2 + a3*J3 (left to right), F_hi + F_lo,
//     F + alpha * J or F, then acc = cells on the first chunk and
//     acc += cells after.
//   * Build with -fmad=false and without --use_fast_math: no FMA contraction
//     of the combine or of _pair_algebra's products-minus-observations, IEEE
//     division for 1/safe_w, D' and r2, and the reciprocal is multiplied in,
//     as JAX does.
//   * The 0.95 skip rule is an f32 compare (0.95f): at P = 19/20 the f32
//     value equals f32(0.95) and the pair is skipped.
//   * The plain versions form each float pass as a float64 sum rounded once
//     to f32.  The tensor core's f32 sum over a chunk equals it wherever
//     every partial sum is exact in f32: when every selected weight is a
//     multiple of 2^e_min and the chunk total is below 2^(e_min + 24)
//     (products of 0/1 and bf16 are exact, and the alignment inside the
//     tensor core then drops no bit).  lo_int8's q pass always meets it;
//     its w_hi pass and bf16-exact weights do for a bounded range (weights
//     in [2^-5, 1] are multiples of 2^-12, so any N < 4,096 is exact).
//     split_bf16's w_lo pass need not (w_lo can lie far below w_hi): there
//     the result is within f32 rounding of the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Params {
  const int8_t* codes;    // [s_pad, n_pad] site-major codes       (codes)
  const int8_t* q;        // [nlev, n_pad] int8 cascade levels     (codes)
  const int8_t* planes;   // [2*s_pad, n_pad] [maj; dmin] per tile (planes)
  const int8_t* xq;       // [nlev, 2*s_pad, n_pad] planes * q_l   (planes)
  const float* scale;     // [nlev] cascade scales a_l (lo_int8: alpha)
  const uint16_t* wb;     // [nlev + nflt, n_pad] bf16 bits of the float
                          // passes (lo_int8: w_hi, then q)
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
// Geometry.
// ---------------------------------------------------------------------------

constexpr int kWA = 64;              // A-side sites per CTA (32 per warpgroup)
constexpr int kWB = 32;              // B-side sites per CTA
constexpr int kRowBytes = 128;       // bytes per swizzled operand row
constexpr int kConsumers = 256;      // two consumer warpgroups
constexpr int kProducers = 128;      // threads of one producer warpgroup
constexpr int kFinishers = 128;      // one epilogue warpgroup
constexpr int kPairs = kWA * kWB;    // site pairs per work item
constexpr int kARows = 2 * kWA;      // [maj; dmin] rows of the A sites
constexpr int kABytes = kARows * kRowBytes;

// The shape of one (weight mode, entry) instantiation: its operand type,
// stage width, shared memory, and the producer's share of a stage.
template <int NLEV, int NFLT, bool PRE>
struct Geom {
  static constexpr bool kBf16 = NFLT > 0;       // bf16 operands, f32 sums
  static constexpr int kPasses = NLEV + NFLT;   // weight blocks along N
  static constexpr int kCols = kBf16 ? 64 : 128;  // columns per stage
  // Whether the producer builds the operands from raw rows (every entry
  // and mode but the preplaned integer one, which copies planes / xq).
  static constexpr bool kBuild = kBf16 || !PRE;
  static constexpr int kStages = kBuild ? 3 : 4;
  static constexpr int kRawDepth = kBuild ? 4 : 0;
  static constexpr int kBRows = 2 * kWB * kPasses;  // per pass: [maj; dmin]
  static constexpr int kStageBytes = kABytes + kBRows * kRowBytes;
  // A build thread covers one 16-column piece of a row (kPieces per stage
  // row) for its share of the kSites sites (kSitesA of them on the A
  // side), reading kSrc raw rows per site (the code row; the planes' maj
  // and dmin rows) and, where it builds B rows, kWSlots 16-byte slots of
  // weights (q_l; two per bf16 pass).
  static constexpr int kPieces = kCols / 16;
  static constexpr int kRound = kProducers / kPieces;  // sites per round
  static constexpr int kSites = (kWA + kWB) / kRound;
  static constexpr int kSitesA = kWA / kRound;
  static constexpr int kSrc = PRE ? 2 : 1;
  static constexpr int kWSlots = kBf16 ? 2 * kPasses : NLEV;
  // Producer warpgroups: the float modes' operand build, which sets their
  // pace (PERF.md), takes two, one building the A sites' rows and one the
  // B sites' (their B rows carry every pass: about as much work).
  static constexpr int kBuilders = kBf16 ? 2 : 1;
  static constexpr int kProducerThreads = kBuilders * kProducers;
  static constexpr int kThreads = kConsumers + kProducerThreads + kFinishers;
  // Registers per thread of each role after setmaxnreg: multiples of 8 that
  // share out the CTA's launch allocation (kLaunchRegs per thread, the most
  // that fits kThreads in the SM's 65,536; setmaxnreg moves registers
  // between warpgroups and adds none).  Consumers hold at most 96
  // accumulators (int8x3's); 64 in the float modes.
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kConsumerRegs = kBuilders == 2 ? 120 : 160;
  static constexpr int kOtherRegs = kBuilders == 2 ? 80 : 96;
  static_assert(kConsumers * kConsumerRegs +
                        (kProducerThreads + kFinishers) * kOtherRegs ==
                    kThreads * kLaunchRegs,
                "setmaxnreg split");
  // Raw slots of builder warpgroup 0 (the A sites, and with one builder the
  // B sites and the weights too) and of builder 1 (the B sites, weights).
  static constexpr int kSlots0 =
      kBuilders == 2 ? kSitesA * kSrc : kSites * kSrc + kWSlots;
  static constexpr int kSlots1 =
      kBuilders == 2 ? (kSites - kSitesA) * kSrc + kWSlots : 0;
  static constexpr int kRawBytes = (kSlots0 + kSlots1) * kProducers * 16;
  // The f32 cells of one work item, handed to the epilogue warpgroup.
  static constexpr int kCellBytes = kPairs * 16;
  // Stages (1,024-byte aligned for the swizzle atom), the raw buffers, the
  // cells, then the full and empty mbarriers of the stages and the cells.
  static constexpr int kSmem = kStages * kStageBytes + kRawDepth * kRawBytes +
                               kCellBytes + 1024 + 2 * (kStages + 1) * 8;
  static_assert(kSmem <= 232448, "shared memory of one CTA");
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

template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64*P] (+)= A[64 x 16] * B[64*P x 16]^T, bf16 x bf16 -> f32, both
// operands K-major in shared memory (scale 1, no transpose); scale_d == 0
// starts a new sum.
__device__ __forceinline__ void wgmma_bf16_n64(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int P>
__device__ __forceinline__ void wgmma_levels(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (P == 1) wgmma_bf16_n64(d, da, db, scale_d);
  if constexpr (P == 2) wgmma_bf16_n128(d, da, db, scale_d);
}

// The stage schedule both roles walk: stages of COLS columns inside each
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

// Producer, preplaned integer entry, 4-byte staging (N_pad or seq_chunk not
// a multiple of 16): A rows from the planes of tile ti, B rows from xq level
// l of tile tj (unit weights: xq is the planes), one cp.async per word.
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

// The preplaned integer producer's source rows of one work item under
// 16-byte staging: thread pt copies chunk pt % 8 of the operand rows
// pt / 8 + 16 i (the first kARowsPer in the planes, the rest in xq seen as
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

// 0/1 bytes -> 0x00 / 0xff byte masks (no carries between bytes).
__device__ __forceinline__ uint4 mask_of_ones(uint4 c) {
  return make_uint4(c.x * 0xffu, c.y * 0xffu, c.z * 0xffu, c.w * 0xffu);
}

__device__ __forceinline__ uint4 splat4(uint32_t v) {
  return make_uint4(v, v, v, v);
}

// Write the bf16 operand of one 16-column piece: the byte masks `m` of
// columns 0..15 widened to halfword masks (byte b -> halfword b), ANDed
// with the bf16 bits of columns 0..7 (`lo`) and 8..15 (`hi`), into 16-byte
// chunks 2 ch and 2 ch + 1 of row `row`.
__device__ __forceinline__ void put_bf16(uint8_t* base, int row, int ch,
                                         uint4 m, uint4 lo, uint4 hi) {
  const uint4 m0 = make_uint4(__byte_perm(m.x, 0, 0x1100),
                              __byte_perm(m.x, 0, 0x3322),
                              __byte_perm(m.y, 0, 0x1100),
                              __byte_perm(m.y, 0, 0x3322));
  const uint4 m1 = make_uint4(__byte_perm(m.z, 0, 0x1100),
                              __byte_perm(m.z, 0, 0x3322),
                              __byte_perm(m.w, 0, 0x1100),
                              __byte_perm(m.w, 0, 0x3322));
  *reinterpret_cast<uint4*>(base + swz(row, 2 * ch)) = and4(m0, lo);
  *reinterpret_cast<uint4*>(base + swz(row, 2 * ch + 1)) = and4(m1, hi);
}

// Builder warpgroup R's share: sites [kFirst, kEnd) of G::kSites, its raw
// rows and slots, and where they start in a raw buffer.
template <class G, int R>
struct Role {
  static constexpr int kFirst = R == 0 ? 0 : G::kSitesA;
  static constexpr int kEnd =
      G::kBuilders == 2 && R == 0 ? G::kSitesA : G::kSites;
  static constexpr int kRows = (kEnd - kFirst) * G::kSrc;
  static constexpr bool kB = kEnd > G::kSitesA;  // builds B rows
  static constexpr int kSlots = R == 0 ? G::kSlots0 : G::kSlots1;
  static constexpr int kBase = R == 0 ? 0 : G::kSlots0 * kProducers * 16;
};

// The build producer's sites of one work item: thread pt of a builder
// warpgroup stages piece pt % kPieces of the A sites pt / kPieces +
// kRound i (i < kSitesA) and of the B sites pt / kPieces + kRound
// (i - kSitesA) of its share, so their raw row pointers (for the copies)
// and aux (for the build) stay in registers.
template <class G>
__device__ __forceinline__ void build_site(const Params& p, int64_t kt,
                                           int bi, int bj, int pt, int i,
                                           int& tile_idx, int& loc) {
  const bool is_a = i < G::kSitesA;
  const int s = pt / G::kPieces + G::kRound * (is_a ? i : i - G::kSitesA);
  loc = min((is_a ? bi * kWA : bj * kWB) + s, p.tile - 1);
  tile_idx = is_a ? p.tile_i[kt] : p.tile_j[kt];
}

template <class G, int R>
struct RawRows {
  const int8_t* row[Role<G, R>::kRows];
};

template <class G, int R>
struct SiteAux {
  static constexpr int kN = Role<G, R>::kEnd - Role<G, R>::kFirst;
  uint32_t maj[kN];    // the site's major allele in every byte
  uint32_t dmin[kN];   // its dominant minor allele
};

// Codes: one row per site; planes: the site's maj row, then its dmin row.
template <class G, int R, bool PRE>
__device__ __forceinline__ RawRows<G, R> raw_rows(const Params& p,
                                                  int64_t kt, int bi, int bj,
                                                  int pt) {
  using RoleT = Role<G, R>;
  RawRows<G, R> rr;
#pragma unroll
  for (int i = RoleT::kFirst; i < RoleT::kEnd; ++i) {
    const int j = i - RoleT::kFirst;
    int t, loc;
    build_site<G>(p, kt, bi, bj, pt, i, t, loc);
    if constexpr (PRE) {
      const int64_t r = (int64_t)t * 2 * p.tile + loc;
      rr.row[2 * j] = p.planes + r * p.n_pad;
      rr.row[2 * j + 1] = p.planes + (r + p.tile) * p.n_pad;
    } else {
      rr.row[j] = p.codes + ((int64_t)t * p.tile + loc) * p.n_pad;
    }
  }
  return rr;
}

template <class G, int R>
__device__ __forceinline__ SiteAux<G, R> site_aux(const Params& p,
                                                  int64_t kt, int bi, int bj,
                                                  int pt) {
  using RoleT = Role<G, R>;
  SiteAux<G, R> sa;
#pragma unroll
  for (int i = RoleT::kFirst; i < RoleT::kEnd; ++i) {
    int t, loc;
    build_site<G>(p, kt, bi, bj, pt, i, t, loc);
    const int64_t site = (int64_t)t * p.tile + loc;
    sa.maj[i - RoleT::kFirst] = (uint32_t)p.auxc[site * 3 + 0] * 0x01010101u;
    sa.dmin[i - RoleT::kFirst] = (uint32_t)p.auxc[site * 3 + 1] * 0x01010101u;
  }
  return sa;
}

// Copy `bytes` (<= 16) from src to dst, as one 16-byte cp.async or as 4-byte
// ones (zero-filled past `bytes`).
template <bool VEC16, bool L1>
__device__ __forceinline__ void fetch16(uint32_t dst, const int8_t* src,
                                        int bytes) {
  if (VEC16) {
    if (L1)
      cp_async16_ca(dst, src, bytes);
    else
      cp_async16(dst, src, bytes);
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int b = 4 * w < bytes ? 4 : 0;
      cp_async4(dst + 4 * w, src + (b > 0 ? 4 * w : 0), b);
    }
  }
}

// Copy the raw slots of one stage (columns [k0 + 16 (pt % kPieces), +16))
// into `raw` (this builder's part of a raw buffer) with cp.async, zero past
// the stage width: the source rows, then the weights (q_l rows; or two
// 8-column halves of each bf16 pass row) through L1, where the threads of
// one piece share them.
template <class G, int R, bool VEC16>
__device__ __forceinline__ void fetch_raw(const Params& p,
                                          const RawRows<G, R>& rr, int k0,
                                          int width, uint32_t raw, int pt) {
  const int col = 16 * (pt % G::kPieces);
  constexpr int kRows = Role<G, R>::kRows;
#pragma unroll
  for (int j = 0; j < Role<G, R>::kSlots; ++j) {
    const uint32_t dst = raw + (j * kProducers + pt) * 16;
    if (j < kRows) {
      const int bytes = min(max(width - col, 0), 16);
      fetch16<VEC16, false>(dst, rr.row[j] + (bytes > 0 ? k0 + col : 0),
                            bytes);
    } else if constexpr (G::kBf16) {
      const int l = (j - kRows) >> 1;   // pass
      const int c = col + 8 * ((j - kRows) & 1);
      const int bytes = 2 * min(max(width - c, 0), 8);
      const uint16_t* src = p.wb + (int64_t)l * p.n_pad + (bytes > 0 ? k0 + c : 0);
      fetch16<VEC16, true>(dst, reinterpret_cast<const int8_t*>(src), bytes);
    } else {
      const int bytes = min(max(width - col, 0), 16);
      const int8_t* src = p.q + (int64_t)(j - kRows) * p.n_pad;
      fetch16<VEC16, true>(dst, src + (bytes > 0 ? k0 + col : 0), bytes);
    }
  }
}

// Build one stage from this thread's landed raw slots: per site the maj
// and dmin byte masks (one __vcmpeq4 per code word against the site's
// major / dmin allele, or the 0/1 plane bytes times 0xff), zero past the
// stage width; int8 A rows = mask & 1 and B rows per level = mask & q_l;
// bf16 A rows = bf16(1.0) where the mask is set, B rows per pass = the
// pass's bf16 weight bits there.
template <class G, int R, bool PRE>
__device__ __forceinline__ void build_stage(const SiteAux<G, R>& ca,
                                            int width, const uint8_t* raw,
                                            uint8_t* sa, int pt) {
  using RoleT = Role<G, R>;
  constexpr int kRows = RoleT::kRows;
  const int ch = pt % G::kPieces;
  const int col = 16 * ch;
  const uint4 valid = make_uint4(col < width ? ~0u : 0u,
                                 col + 4 < width ? ~0u : 0u,
                                 col + 8 < width ? ~0u : 0u,
                                 col + 12 < width ? ~0u : 0u);
  const uint4* slot = reinterpret_cast<const uint4*>(raw) + pt;
  uint4 w[RoleT::kB ? G::kWSlots : 1];
#pragma unroll
  for (int l = 0; l < (RoleT::kB ? G::kWSlots : 0); ++l)
    w[l] = slot[(kRows + l) * kProducers];
  const uint4 one = splat4(G::kBf16 ? 0x3F803F80u : 0x01010101u);
#pragma unroll
  for (int i = RoleT::kFirst; i < RoleT::kEnd; ++i) {
    const int j = i - RoleT::kFirst;
    uint4 em, ed;
    if constexpr (PRE) {
      em = and4(mask_of_ones(slot[(2 * j) * kProducers]), valid);
      ed = and4(mask_of_ones(slot[(2 * j + 1) * kProducers]), valid);
    } else {
      const uint4 code = slot[j * kProducers];
      em = and4(eq4(code, ca.maj[j]), valid);
      ed = and4(eq4(code, ca.dmin[j]), valid);
    }
    if (i < G::kSitesA) {
      // Warpgroup s / 32 owns A rows [64 * (s / 32), +64).
      const int s = pt / G::kPieces + G::kRound * i;
      const int r = (s >> 5) * 64 + op_row(s & 31, 0);
      if constexpr (G::kBf16) {
        put_bf16(sa, r, ch, em, one, one);
        put_bf16(sa, r + 8, ch, ed, one, one);
      } else {
        *reinterpret_cast<uint4*>(sa + swz(r, ch)) = and4(em, one);
        *reinterpret_cast<uint4*>(sa + swz(r + 8, ch)) = and4(ed, one);
      }
    } else {
      const int s = pt / G::kPieces + G::kRound * (i - G::kSitesA);
      uint8_t* sb = sa + kABytes;
#pragma unroll
      for (int l = 0; l < G::kPasses; ++l) {
        const int r = l * 2 * kWB + op_row(s, 0);
        if constexpr (G::kBf16) {
          put_bf16(sb, r, ch, em, w[2 * l], w[2 * l + 1]);
          put_bf16(sb, r + 8, ch, ed, w[2 * l], w[2 * l + 1]);
        } else {
          *reinterpret_cast<uint4*>(sb + swz(r, ch)) = and4(em, w[l]);
          *reinterpret_cast<uint4*>(sb + swz(r + 8, ch)) = and4(ed, w[l]);
        }
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
// + gridDim.x, ...; in each, the reference seq chunks and their COLS-column
// steps.
template <int COLS>
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
    return min(COLS, c0 + p.seq_chunk - k0);
  }
  // Step to the next stage; true when it starts another item.
  __device__ bool next(const Params& p, int n_items) {
    k0 += COLS;
    if (k0 < c0 + p.seq_chunk) return false;
    c0 += p.seq_chunk;
    k0 = c0;
    if (c0 < p.n_pad) return false;
    item += gridDim.x;
    settle(p, n_items);
    return true;
  }
};

// Producer warpgroup, preplaned integer entry: per stage, once the
// consumers have released it, cp.async the operand rows; the full barrier
// completes when they have landed.
template <int NLEV, bool VEC16>
__device__ __forceinline__ void produce_planes(const Params& p, int n_items,
                                               uint32_t stages, uint32_t full,
                                               uint32_t empty, int pt) {
  using G = Geom<NLEV, 0, true>;
  Cursor<G::kStages> cur;
  StageWalk<G::kCols> at;
  at.item = blockIdx.x;
  at.settle(p, n_items);
  PlaneRows<NLEV> pr;
  bool fresh = true;
  for (; at.item < n_items; fresh = at.next(p, n_items)) {
    const int ti = p.tile_i[at.kt];
    const int tj = p.tile_j[at.kt];
    if (VEC16 && fresh) pr = plane_rows<NLEV>(p, ti, tj, at.bi, at.bj, pt);
    mbar_wait(empty + 8 * cur.stage, cur.phase ^ 1);
    const uint32_t sa = stages + cur.stage * G::kStageBytes;
    if (VEC16)
      stage_plane_rows<NLEV>(p, pr, at.k0, at.width(p), sa, pt);
    else
      stage_planes<NLEV>(p, ti, tj, at.bi, at.bj, at.k0, at.width(p), sa, pt);
    cp_async_arrive(full + 8 * cur.stage);
    cur.next();
  }
  cp_async_wait<0>();
}

// Builder warpgroup R, every (entry, mode) but the preplaned integer one:
// the raw slots of the next kRawDepth - 1 stages are in flight (cp.async
// into the raw buffers; walk `ahead`) while this stage (walk `at`) is
// built.  Each builder arrives on every stage's full barrier.
template <int NLEV, int NFLT, bool PRE, bool VEC16, int R>
__device__ __forceinline__ void produce_build(const Params& p, int n_items,
                                              uint8_t* gst, uint32_t raw,
                                              uint8_t* graw, uint32_t full,
                                              uint32_t empty, int pt) {
  using G = Geom<NLEV, NFLT, PRE>;
  constexpr int kDepth = G::kRawDepth;
  constexpr int kBase = Role<G, R>::kBase;
  StageWalk<G::kCols> at;
  at.item = blockIdx.x;
  at.settle(p, n_items);
  if (at.item >= n_items) return;
  StageWalk<G::kCols> ahead = at;
  RawRows<G, R> rows =
      raw_rows<G, R, PRE>(p, ahead.kt, ahead.bi, ahead.bj, pt);
  SiteAux<G, R> aux;
  if (!PRE) aux = site_aux<G, R>(p, at.kt, at.bi, at.bj, pt);
  // Fetch into buffer `slot` and step `ahead` on.
  auto fetch = [&](int slot) {
    if (ahead.item < n_items) {
      fetch_raw<G, R, VEC16>(p, rows, ahead.k0, ahead.width(p),
                             raw + slot * G::kRawBytes + kBase, pt);
      if (ahead.next(p, n_items) && ahead.item < n_items)
        rows = raw_rows<G, R, PRE>(p, ahead.kt, ahead.bi, ahead.bj, pt);
    }
    cp_async_commit();  // one group per stage, empty past the end
  };
#pragma unroll
  for (int i = 0; i < kDepth - 1; ++i) fetch(i);
  Cursor<G::kStages> cur;
  int slot = 0;  // this stage's raw buffer
  while (at.item < n_items) {
    fetch(slot == 0 ? kDepth - 1 : slot - 1);
    cp_async_wait<kDepth - 1>();  // this stage's raw slots have landed
    mbar_wait(empty + 8 * cur.stage, cur.phase ^ 1);
    build_stage<G, R, PRE>(aux, at.width(p),
                           graw + slot * G::kRawBytes + kBase,
                           gst + cur.stage * G::kStageBytes, pt);
    fence_proxy_async();  // generic-proxy writes -> wgmma reads
    mbar_arrive(full + 8 * cur.stage);
    cur.next();
    slot = slot == kDepth - 1 ? 0 : slot + 1;
    if (at.next(p, n_items) && at.item < n_items && !PRE)
      aux = site_aux<G, R>(p, at.kt, at.bi, at.bj, pt);
  }
}

// Persistent: each CTA walks work items blockIdx.x, + gridDim.x, ...; the
// stage ring runs on across items, so the producer fills the next item's
// first stages while the consumers finish the last one, and the epilogue
// warpgroup runs an item's pair algebra and stores while the consumers
// contract the next.
template <int NLEV, int NFLT, bool PRE, bool VEC16>
__global__ void __launch_bounds__(Geom<NLEV, NFLT, PRE>::kThreads, 1)
ld_majmin_wgmma(const Params p, int n_items) {
  using G = Geom<NLEV, NFLT, PRE>;
  constexpr int kStages = G::kStages;
  constexpr int kStageBytes = G::kStageBytes;
  constexpr int R = 32 * G::kPasses;  // accumulator registers per thread
  using Acc = typename std::conditional<G::kBf16, float, int32_t>::type;
  extern __shared__ uint8_t smem_raw[];

  const int tile = p.tile;
  const int tid = threadIdx.x;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t rawbuf = base + kStages * kStageBytes;
  const uint32_t cells = rawbuf + G::kRawDepth * G::kRawBytes;
  float4* const gcells = reinterpret_cast<float4*>(gbase + (cells - base));
  const uint32_t full = cells + G::kCellBytes;
  const uint32_t empty = full + 8 * (kStages + 1);
  // full[kStages] / empty[kStages]: the cells, filled by the consumers and
  // released by the epilogue warpgroup.
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, G::kProducerThreads);
      mbar_init(empty + 8 * s, kConsumers);
    }
    mbar_init(full + 8 * kStages, kConsumers);
    mbar_init(empty + 8 * kStages, kFinishers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers + G::kProducerThreads) {
    // Epilogue warpgroup: per item the pair algebra and the stores of the
    // item's pairs (A site ea + 4m, m < kPer; B site eb: consecutive
    // threads on consecutive B sites); the keep blocks of padding tile
    // pairs are zeroed.  The sites' aux is read while the consumers
    // contract, before the cells are waited for.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
                     G::kOtherRegs));
    constexpr int kPer = kPairs / kFinishers;
    constexpr int kStep = kFinishers / kWB;
    const int et = tid - kConsumers - G::kProducerThreads;
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
                     G::kOtherRegs));
    const int pt = tid - kConsumers;
    uint8_t* const graw = gbase + (rawbuf - base);
    if constexpr (!G::kBuild)
      produce_planes<NLEV, VEC16>(p, n_items, base, full, empty, pt);
    else if (G::kBuilders == 1 || pt < kProducers)
      produce_build<NLEV, NFLT, PRE, VEC16, 0>(p, n_items, gbase, rawbuf,
                                               graw, full, empty, pt);
    else if constexpr (G::kBuilders == 2)
      produce_build<NLEV, NFLT, PRE, VEC16, 1>(p, n_items, gbase, rawbuf,
                                               graw, full, empty,
                                               pt - kProducers);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
                     G::kConsumerRegs));
    // Consumer thread -> its 8 pairs of an item: A site li, B sites
    // lj0 + 8h + c.
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    float a[NLEV > 0 ? NLEV : 1];
#pragma unroll
    for (int l = 0; l < NLEV; ++l) a[l] = p.scale[l];
    Acc D[R];
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
        for (int k0 = c0; k0 < c0 + p.seq_chunk; k0 += G::kCols) {
          mbar_wait(full + 8 * cur.stage, cur.phase);
          fence_proxy_async();
          const uint32_t sa = base + cur.stage * kStageBytes;
          const uint64_t da = sw128_desc(sa + wg * 64 * kRowBytes);
          const uint64_t db = sw128_desc(sa + kABytes);
          fence_regs<R>(D);
          wgmma_fence();
          // All four K steps of a stage (32 bytes each: 32 int8 or 16
          // bf16 columns): columns past a partial stage's width are zero in
          // both operands.  Each step moves the descriptors 32 bytes
          // further into the 128-byte rows.
          wgmma_levels<G::kPasses>(D, da, db, scale_d);
          wgmma_levels<G::kPasses>(D, da + 2, db + 2, 1);
          wgmma_levels<G::kPasses>(D, da + 4, db + 4, 1);
          wgmma_levels<G::kPasses>(D, da + 6, db + 6, 1);
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

        // Combine once per seq chunk (pallas_ld.py:912-935): fragment
        // entry 4k + 2*ia + c holds row-half ia (A maj / dmin) and column c
        // of n8 block k = 8l + 2h + ib (pass l, B group h, B maj / dmin).
#pragma unroll
        for (int h = 0; h < 4; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float cell[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ia = e >> 1, ib = e & 1;
              const int i0 = 4 * (2 * h + ib) + 2 * ia + c;
              if constexpr (G::kBf16) {
                cell[e] = (float)D[i0];
                if constexpr (NFLT == 2)        // split_bf16: F_hi + F_lo
                  cell[e] = cell[e] + (float)D[32 + i0];
                if constexpr (NLEV == 1)        // lo_int8: F + alpha * J
                  cell[e] = cell[e] + a[0] * (float)D[32 + i0];
              } else {
                cell[e] = a[0] * (float)D[i0];
#pragma unroll
                for (int l = 1; l < NLEV; ++l)
                  cell[e] = cell[e] + a[l] * (float)D[32 * l + i0];
              }
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

template <int NLEV, int NFLT, bool PRE, bool VEC16>
int launch_wgmma(const Params& p, int k, cudaStream_t stream) {
  constexpr int smem = Geom<NLEV, NFLT, PRE>::kSmem;
  constexpr int threads = Geom<NLEV, NFLT, PRE>::kThreads;
  auto kern = ld_majmin_wgmma<NLEV, NFLT, PRE, VEC16>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t items = (int64_t)k * ((p.tile + kWA - 1) / kWA) *
                        ((p.tile + kWB - 1) / kWB);
  const int grid = (int)(items < sm_count() ? items : sm_count());
  kern<<<grid, threads, smem, stream>>>(p, (int)items);
  return (int)cudaGetLastError();
}

template <int NLEV, int NFLT, bool PRE>
int launch(const Params& p, int k, cudaStream_t stream) {
  // 16-byte staging needs every stage start 16-byte aligned.
  if (p.n_pad % 16 == 0 && p.seq_chunk % 16 == 0)
    return launch_wgmma<NLEV, NFLT, PRE, true>(p, k, stream);
  return launch_wgmma<NLEV, NFLT, PRE, false>(p, k, stream);
}

// The instantiation by weight mode; any other (nlev, nflt) is refused.
template <bool PRE>
int dispatch(const Params& p, int k, int nlev, int nflt, cudaStream_t stream) {
  if (k <= 0) return 0;
  if (nflt == 0 && nlev == 1) return launch<1, 0, PRE>(p, k, stream);
  if (nflt == 0 && nlev == 2) return launch<2, 0, PRE>(p, k, stream);
  if (nflt == 0 && nlev == 3) return launch<3, 0, PRE>(p, k, stream);
  if (nflt == 1 && nlev == 0) return launch<0, 1, PRE>(p, k, stream);
  if (nflt == 2 && nlev == 0) return launch<0, 2, PRE>(p, k, stream);
  if (nflt == 1 && nlev == 1) return launch<1, 1, PRE>(p, k, stream);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* scale, const void* wb, const void* auxc,
                   const void* tile_i, const void* tile_j, const void* emit,
                   void* d, void* dp, void* r2, void* keep, int tile,
                   int n_sites, int s_pad, int n_pad, int seq_chunk) {
  Params p = {};
  p.scale = static_cast<const float*>(scale);
  p.wb = static_cast<const uint16_t*>(wb);
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
// `wb` is the [nlev + nflt, n_pad] bf16 bits of the float passes (null in
// the integer modes).  Returns the CUDA error of the launch (0 = launched).
extern "C" int ld_majmin_codes(const void* codes, const void* q,
                               const void* scale, const void* wb,
                               const void* auxc, const void* tile_i,
                               const void* tile_j, const void* emit, void* d,
                               void* dp, void* r2, void* keep, int k, int tile,
                               int n_sites, int s_pad, int n_pad, int seq_chunk,
                               int nlev, int nflt, void* stream) {
  Params p = make_params(scale, wb, auxc, tile_i, tile_j, emit, d, dp, r2,
                         keep, tile, n_sites, s_pad, n_pad, seq_chunk);
  p.codes = static_cast<const int8_t*>(codes);
  p.q = static_cast<const int8_t*>(q);
  return dispatch<false>(p, k, nlev, nflt, static_cast<cudaStream_t>(stream));
}

// Entry for _ld_kernel_mm_pre: operands read from precomputed planes / xq
// (unit weights: xq is the planes; the float modes read the planes alone).
extern "C" int ld_majmin_planes(const void* planes, const void* xq,
                                const void* scale, const void* wb,
                                const void* auxc, const void* tile_i,
                                const void* tile_j, const void* emit, void* d,
                                void* dp, void* r2, void* keep, int k,
                                int tile, int n_sites, int s_pad, int n_pad,
                                int seq_chunk, int nlev, int nflt,
                                void* stream) {
  Params p = make_params(scale, wb, auxc, tile_i, tile_j, emit, d, dp, r2,
                         keep, tile, n_sites, s_pad, n_pad, seq_chunk);
  p.planes = static_cast<const int8_t*>(planes);
  p.xq = static_cast<const int8_t*>(xq);
  return dispatch<true>(p, k, nlev, nflt, static_cast<cudaStream_t>(stream));
}
