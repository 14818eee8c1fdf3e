// General P-plane weighted-LD tile kernel for Hopper (sm_90a).
//
// Replaces the general Pallas TPU kernels of the JAX package, both reached
// through weightedld_tpu/ops/pallas_ld.py:pallas_tile_stats:
//   * _ld_kernel (weighted), entry ld_general;
//   * _ld_kernel_unit (unit weights, --unweighted), entry ld_general_unit;
// both finished by _ld_finalize, and, with a planes pointer instead of the
// codes, their preplaned variant (pallas_tile_stats(preplaned=True) on the
// one-hot planes of build_planes_tiled).  They run where the factorized
// kernel of ld_majmin.cu is not proven exact: UNKNOWN codes (ambiguity
// characters) whose count margins do not absorb the per-pair removals.
//
// What it computes.  For every site pair (i, j) of a (tile_i, tile_j) tile
// pair, the reference drops the sequences whose code is outside the P
// allele planes at either site, then recomputes major and dominant minor
// from what remains (WeightedLD.py:183-211):
//   cnt_a[s] = #{A == planes[s], B valid},  cnt_b[u] = #{A valid,
//   B == planes[u]}   (valid = the code is one of the planes);
//   major / dominant minor = best / second-best score count*8 + (5 - code);
//   keep needs distinct > 1 on both sides;
// then reads the four {maj, dmin} x {maj, dmin} cells of the weighted joint
// table and runs the pair algebra of ld_majmin.cu.
//
// What bounds it.  Operations, as in the factorized kernel: each output
// pair is 13 bytes, each contracts N sequences.  Which plane rows a pair
// needs depends on its own counts, so the four selected cells are no
// matrix product; the least work of a selecting body (2P count MACs + 4
// cells per pass) runs on the CUDA cores (dp4a), not on the tensor cores,
// whose int8 rate is ~16x the CUDA cores' dp4a rate.
//
// What the design does.  It contracts the whole P x P joint on the tensor
// cores and selects afterwards, as the TPU kernel does (pallas_ld.py:
// 290-344, _ld_finalize :493-548).  Per weight pass l the joint
// J_l[s][u] = sum_n A_s(n) B_u(n) w_l(n) over the 0/1 plane indicators
// (int8 q_l levels on int8 wgmma; bf16 float passes on bf16 wgmma, where
// lo_int8's residual q, an integer <= 127, rides as a second bf16 pass as in
// ld_majmin.cu), and one more, unit pass (w = 1): its joint N[s][u] is
// exact, and its marginals are the counts, cnt_a[s] = sum_u N[s][u] and
// cnt_b[u] = sum_s N[s][u], because validity is the union of the disjoint
// planes (a restricted planes tuple included).  Under unit weights that
// pass is the only one and its joint is also the cells.  Per pair and
// column that is P^2 (passes) MACs: 100 int8 at P = 5 in int8x3 (3 levels +
// the unit pass), 75 bf16 in lo_int8 and split_bf16, 50 in bf16-exact, 25
// int8 in unit.
//
// A work item is kSA A sites x kSB B sites of a tile pair (Geom), both
// multiples of 8.  A rows are plane-major (plane s of A site a at row
// s * kSA + a), 64 per consumer warpgroup; B rows pass-major, then
// plane-major (row l * kRB + u * kSB + b, kRB = P * kSB), so one
// wgmma.m64nNk32.s32.s8.s8 (or m64nNk16.f32.bf16.bf16) per 32 bytes of
// columns gives every pass's joints, and each thread's accumulator fragment
// (rows r, r + 8; columns 2 (lane % 4) + {0, 1} + 8k) holds every pass of
// its (A row, B row) entries: the per-chunk combine needs no exchange.
// kSA = 128 / P rounded down to a multiple of 8; kSB is the largest
// multiple of 8 that keeps N = passes * kRB <= 160 (80 accumulators a
// thread) and one item's cells within 48 KB of shared memory:
//   P:                1     2     3     4     5
//   kSA:            128    64    40    32    24
//   kSB int8x3:      40    16     8     8     8   (N 160 128  96 128 160)
//   kSB int8:        48    24    16     8     8   (N 144 144 144  96 128)
//   kSB lo, split:   48    24    16     8     8   (N 144 144 144  96 120)
//   kSB exact:       48    24    16     8     8   (N  96  96  96  64  80)
//   kSB unit:        96    48    32    24    16   (N  96  96  96  96  80)
// (int8 N rounded up to a multiple of 16, pad rows unread).  Smaller
// alphabets take larger blocks; at P = 5 an item is 192 pairs (384 under
// unit weights) against the factorized body's 2,048, because every pair
// holds P^2 accumulators per pass.
//
// The schedule follows ld_majmin.cu's: persistent CTAs (one per SM; which
// items each runs, below) of two consumer warpgroups and two producer
// warpgroups (setmaxnreg: consumers 160 registers, producers 96), a ring of
// stages with mbarriers full / empty, waits that trap after 10 s.  A
// stage is two 128-byte swizzled atoms wide (256 int8 or 128 bf16
// columns: two halves side by side, each an A block and a B block) where
// shared memory holds 2 of them, else one atom; unit weights keep one
// atom (at two their producers spill).  The producers' per-stage work and
// the stage's handshakes set the pace (PERF.md), so halving the stage
// count cut the weighted rows by a fifth; 3 stages where they fit, else 2.
// In two-atom bf16 stages the second half's pieces store their upper
// chunk first (kSwapOdd), so a quarter warp's stores never share a bank.
// The producers keep up to 3 stages of raw rows in flight (cp.async, 16
// bytes where N_pad and seq_chunk are multiples of 16, else 4; zero past
// the chunk end).  The A builder takes the code row (codes entry; plane
// masks by __vcmpeq4 against each plane's code) or the P one-hot plane
// rows of build_planes_tiled (row g * P * T + s * T + i; masks = bytes *
// 0xff) of each A site and writes its P A rows (mask & 1, or bf16 1.0);
// under the integer modes of the preplaned entry those rows are the plane
// rows themselves, copied straight into the stage.  The B builder takes
// (plane, B site) tasks, which balances its share with the A builder's:
// the plane's B row in every pass (mask & q_l, the pass's bf16 weight
// bits, or 1), from the plane row (preplaned) or the site's code row
// (codes: fetched once, shared by the site's P tasks); the stage's weights
// are fetched once and shared too.  At each reference seq chunk end the
// consumers combine their fragments into the item's cells in shared
// memory: the unit joint (int32, accumulated over every chunk) and the f32
// running cells of every (s, u).  After an item's last chunk they sum each
// pair's counts, run major_dmin and the distinct > 1 test, read the four
// selected cells, run the pair algebra and store, while the producers fill
// the next item's first stages (an epilogue warpgroup of its own would
// leave the consumers fewer registers than an N = 160 wgmma needs).
//
// Which items run.  Every item runs over all N sequences, but only pairs
// gi < gj < n_sites are kept, so the items of a diagonal tile pair below
// the diagonal and those past the last site of a ragged last tile hold
// nothing to emit: in a plan of a few tile pairs, most of them diagonal or
// ragged, they are a third to a half of the items (a query of
// hiv_pol_iupac.session: 53-61 % live).  An item is live where its tile
// pair emits and some pair of its block passes that gate; for a given A
// block the live B blocks are one interval, in closed form (live_span).
// Only live items are staged, contracted and finalized; a dead item (a
// padding tile pair's too) only has its keep block zeroed, by the
// consumers before their first item.  The live items are dealt in turn,
// the n-th of the launch to CTA n mod grid, so every CTA runs floor(L /
// grid) or ceil(L / grid) of the L live items: striding over all items and
// skipping the dead would leave the CTAs whose stride meets the most live
// items to set the launch's time.  Each role of a CTA steps the same walk
// (LiveWalk) on its own, a row of the interval table at a time, with no
// table in memory.  A plan with no dead item (full off-diagonal tiles)
// runs the items of the strided walk, in the same order.
//
// Numerics that must match the JAX package bit for bit where it is exact:
//   * Counts and int8 joints are exact integers.  The weighted combine runs
//     once per reference seq chunk on every (s, u): cells = a1*J1 + a2*J2 +
//     a3*J3 (left to right), F + alpha * J (lo_int8), F_hi + F_lo
//     (split_bf16) or F (bf16-exact), then acc = cells on the first chunk
//     and acc += cells after; the unit kernel accumulates its int32 joint
//     over all of N and converts once (_ld_kernel_unit).  Selecting an
//     entry afterwards returns it bit for bit, as the reference's masked
//     sums (jw * 1.0, then + jw * 0.0) do, so the bits are those of
//     selecting first.
//   * Built with -fmad=false and without --use_fast_math; the pair algebra
//     is that of ld_majmin.cu (reciprocal multiplied in, 0.95 as an f32
//     compare).
//   * The float passes' f32 sums on the tensor cores equal the plain
//     version's float64 sums rounded once wherever every partial sum is
//     exact in f32 (the note at the top of ld_majmin.cu): lo_int8's q pass
//     and the unit pass always, its w_hi pass and bf16-exact weights in
//     [2^-5, 1] at N < 4,096; split_bf16's w_lo pass within f32 rounding.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ld_general_wgmma.cuh"

namespace {

constexpr int kPMax = 5;             // allele planes (codes 0..4)

struct Params {
  const int8_t* codes;    // [s_pad, n_pad] site-major codes   (codes)
  const int8_t* planes;   // [grid*P*T, n_pad] one-hot planes  (preplaned)
  const int8_t* q;        // [nlev, n_pad] int8 cascade levels (integer modes)
  const float* scale;     // [nlev] cascade scales a_l (lo_int8: alpha)
  const uint16_t* wb;     // [nlev + nflt, n_pad] bf16 bits of the float
                          // passes (lo_int8: w_hi, then q)
  const int32_t* tile_i;  // [k]
  const int32_t* tile_j;  // [k]
  const int32_t* emit;    // [k]
  float* d;               // [k, tile, tile]
  float* dp;
  float* r2;
  int8_t* keep;
  int tile;
  int n_sites;
  int n_pad;
  int seq_chunk;          // the reference seq chunk (unit weights: n_pad)
  int vec16;              // 16-byte copies: n_pad and seq_chunk % 16 == 0
  int packed;             // planes[s], the allele code of plane s, at bits
                          // 3s..3s+2
};

// _pair_algebra (pallas_ld.py:434-476), operation for operation; the same
// function as in ld_majmin.cu.
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

// _ld_finalize's major_dmin (pallas_ld.py:503-521), loop for loop: plane
// indices of the best and second-best score count*8 + (5 - code), and the
// number of planes with a nonzero count.
template <int P>
__device__ __forceinline__ void major_dmin(const int32_t (&cnt)[P],
                                           const Params& p, int& maj,
                                           int& dmin, int& distinct) {
  int best = -1, best_idx = 0;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int score = cnt[s] * 8 + (5 - ((p.packed >> (3 * s)) & 7));
    if (score > best) {
      best = score;
      best_idx = s;
    }
  }
  int second = -1, second_idx = 0;
  distinct = 0;
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int score = cnt[s] * 8 + (5 - ((p.packed >> (3 * s)) & 7));
    if (score > second && best_idx != s) {
      second = score;
      second_idx = s;
    }
    distinct += cnt[s] > 0 ? 1 : 0;
  }
  maj = best_idx;
  dmin = second_idx;
}

// ---------------------------------------------------------------------------
// Geometry.
// ---------------------------------------------------------------------------

constexpr int kARows = 128;          // A operand rows: 64 per consumer warpgroup
constexpr int kRowBytes = 128;       // bytes per swizzled operand row
constexpr int kABytes = kARows * kRowBytes;
constexpr int kConsumers = 256;      // two consumer warpgroups
constexpr int kProducers = 128;      // threads of one producer warpgroup
constexpr int kBuilders = 2;         // producer warpgroups: A rows, B rows
constexpr int kProducerThreads = kBuilders * kProducers;
constexpr int kThreads = kConsumers + kProducerThreads;
constexpr int kNMax = 160;           // most B rows: 80 accumulators a thread
constexpr int kCellCap = 49152;      // most bytes of one item's cells
constexpr int kSmemMax = 232448;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The shape of one (P, weight mode, entry) instantiation.  A work item is
// kSA A sites x kSB B sites of a tile pair, both multiples of 8.  A rows are
// plane-major (row s * kSA + a: plane s of A site a; rows past P * kSA are
// never read).  B rows are pass-major, then plane-major (row l * kRB + u *
// kSB + b: plane u of B site b times pass l's weight), so that every pass
// of a (row, column) of the joint lies in the same thread's accumulator
// fragment.  The passes are the weighted ones (int8 levels q_l, or bf16
// float passes) and, last, the unit pass whose joint gives the counts (its
// marginals) and, under unit weights, the cells.  Every row of a site has
// the same row % 8, so its swizzled stores share one base address.
template <int P, int NLEV, int NFLT, bool UNIT, bool PRE, int H>
struct GeomH {
  static constexpr int kP = P;
  static constexpr bool kBf16 = NFLT > 0;       // bf16 operands, f32 sums
  static constexpr int kW = UNIT ? 0 : NLEV + NFLT;  // weighted passes
  static constexpr int kPasses = kW + 1;
  // A stage is H 128-byte atoms wide: H halves side by side, each an A
  // block and a B block of 128-byte swizzled rows (128 int8 or 64 bf16
  // columns).
  static constexpr int kHalves = H;
  static constexpr int kAtomCols = kBf16 ? 64 : 128;
  static constexpr int kCols = H * kAtomCols;        // columns per stage
  static constexpr int kPiecesHalf = kAtomCols / 16;
  // In two-atom bf16 stages the 8 threads of a quarter warp store 4 pieces
  // of each half of one row, whose chunks 2c (and 2c + 1) share bank groups
  // across the halves; the second half's pieces store their upper chunk
  // first, so each store instruction covers 8 distinct bank groups.
  static constexpr bool kSwapOdd = kBf16 && H > 1;
  static constexpr int kSA = kARows / P / 8 * 8;
  // Bytes of one pair's cells: the unit joint (int32) and, weighted, the
  // f32 running cells, P x P each.
  static constexpr int kCellB = 4 * P * P * (UNIT ? 1 : 2);
  static constexpr int kG = cmin(kNMax / (8 * kPasses * P),
                                 kCellCap / (kSA * 8 * kCellB));
  static constexpr int kSB = 8 * kG;
  static constexpr int kRB = P * kSB;                // B rows per pass
  // int8 wgmma takes N in multiples of 16 above 32: pad rows are never read.
  static constexpr int kN =
      kBf16 ? kPasses * kRB : (kPasses * kRB + 15) / 16 * 16;
  static constexpr int kHalfBytes = kABytes + kN * kRowBytes;
  static constexpr int kStageBytes = H * kHalfBytes;
  // A producer thread covers one 16-column piece of a row (kPieces per
  // stage row) for tasks pt / kPieces + kRound i of its warpgroup: the A
  // builder's tasks are the A sites (kSrc raw rows each: the code row, or
  // the site's P plane rows; P A rows), the B builder's the (plane u, B
  // site) pairs (one raw row: the code row or the plane-u row; the plane's
  // B row in every pass), with kWSlots 16-byte slots of weights (q_l; two
  // per bf16 pass).
  static constexpr int kPieces = kCols / 16;
  static constexpr int kRound = kProducers / kPieces;
  static constexpr int kSrc = PRE ? P : 1;
  static constexpr int kARounds = (kSA + kRound - 1) / kRound;
  static constexpr int kBTasks = P * kSB;
  static constexpr int kBRounds = (kBTasks + kRound - 1) / kRound;
  static constexpr int kWSlots = kBf16 ? 2 * kW : kW;
  // The preplaned entry's integer A rows are its plane rows: the A builder
  // copies them straight into the stage, with no raw slots and no build.
  static constexpr bool kDirectA = PRE && !kBf16;
  static constexpr int kSlotsA = kDirectA ? 0 : kARounds * kSrc;
  // The B builder's rows: the preplaned entry one plane row per task; the
  // codes entry each B site's code row once, shared by the site's P tasks
  // (kSB x kPieces chunks of 16 bytes).
  static constexpr int kBRowSlots =
      PRE ? kBRounds : (kSB * kPieces + kProducers - 1) / kProducers;
  // The weights of a stage, fetched once and shared by every B task:
  // kWSlots x kPieces chunks of 16 bytes after the rows.
  static constexpr int kWBase = kBRowSlots * kProducers * 16;
  static constexpr int kSlotsB =
      kBRowSlots + (kWSlots * kPieces + kProducers - 1) / kProducers;
  static_assert(kWSlots * kPieces <= kProducers, "one weight chunk a thread");
  static constexpr int kRawBytes = (kSlotsA + kSlotsB) * kProducers * 16;
  static constexpr int kCellBytes = kSA * kSB * kCellB;
  static constexpr int smem(int stages, int depth) {
    return stages * kStageBytes + depth * kRawBytes + kCellBytes + 1024 +
           2 * stages * 8;
  }
  // 3 operand stages and as many raw buffers (kRawDepth - 1 stages of raw
  // rows in flight) as fit, up to 4; else 2 stages.
  static constexpr int kStages = smem(3, 2) <= kSmemMax ? 3 : 2;
  static constexpr int kRawDepth =
      smem(kStages, 4) <= kSmemMax ? 4 : smem(kStages, 3) <= kSmemMax ? 3 : 2;
  static constexpr int kSmem = smem(kStages, kRawDepth);
  static constexpr bool kFits = kSmem <= kSmemMax;
  static_assert(kG >= 1 && kN <= kNMax && kSA % 8 == 0, "block shape");
  // setmaxnreg: consumers 160 registers (at most 80 accumulators), the
  // producers 96, sharing the launch's 128 a thread.
  static constexpr int kConsumerRegs = 160;
  static constexpr int kOtherRegs = 96;
  static_assert(kConsumers * kConsumerRegs + kProducerThreads * kOtherRegs ==
                    kThreads * (65536 / kThreads / 8 * 8),
                "setmaxnreg split");
};

// Two-atom stages (half the stages, so half the ring's handshakes and the
// producers' per-stage overhead) where shared memory holds 2 of them, else
// one-atom stages.  Unit weights keep one-atom stages: their producers
// have the most tasks a stage (one pass, the largest B blocks), and at two
// atoms they spill.
constexpr int kMaxHalves = 2;
template <int P, int NLEV, int NFLT, bool UNIT, bool PRE>
using Geom = typename std::conditional<
    !UNIT && GeomH<P, NLEV, NFLT, UNIT, PRE, kMaxHalves>::kFits,
    GeomH<P, NLEV, NFLT, UNIT, PRE, kMaxHalves>,
    GeomH<P, NLEV, NFLT, UNIT, PRE, 1>>::type;

// ---------------------------------------------------------------------------
// Shared-memory layout, barriers, copies (as in ld_majmin.cu).
// ---------------------------------------------------------------------------

// Byte offset of 16-byte chunk `ch` of operand row `row` in the 128-byte
// swizzled K-major layout: 8-row atoms of 1,024 bytes, chunk ch ^ (row % 8).
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  return (row >> 3) * 1024 + (row & 7) * 128 + ((ch ^ (row & 7)) << 4);
}

// Whether piece `ch` stores its upper 8 bf16 columns first (kSwapOdd).
template <class G>
__device__ __forceinline__ bool swapped(int ch) {
  return G::kSwapOdd && (ch / G::kPiecesHalf) % 2 == 1;
}

// Byte offsets of piece `ch` (16 columns) of operand row `row` within a
// stage: its half, then its 16-byte chunk (int8) or two chunks (bf16) in
// the 128-byte swizzled K-major layout, `at` the one stored first: columns
// 0..7 of the piece, or 8..15 where swapped.
template <class G>
__device__ __forceinline__ void piece_at(int row, int ch, uint32_t& at,
                                         uint32_t& at2) {
  const uint32_t half = (ch / G::kPiecesHalf) * G::kHalfBytes;
  const int c = ch % G::kPiecesHalf;
  const int s = swapped<G>(ch) ? 1 : 0;
  at = half + swz(row, G::kBf16 ? 2 * c + s : c);
  at2 = half + swz(row, 2 * c + 1 - s);
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

// A wait of one role on another lasts at most about one work item; 10 s
// means a broken schedule.
constexpr uint64_t kWaitLimitNs = 10000000000ull;

// Wait for the phase of `bar` with the given parity to complete; a wait
// that never ends traps after kWaitLimitNs, so the launch fails with an
// error instead of holding the card.
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

template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Copy `bytes` (<= 16) from src to dst and zero-fill the rest: one 16-byte
// cp.async (through L1 where `l1`: the weight rows every thread of a piece
// reads), or four 4-byte ones where the rows are only 4-byte aligned.
__device__ __forceinline__ void fetch16(uint32_t dst, const void* src,
                                        int bytes, bool vec16, bool l1) {
  if (vec16) {
    if (l1)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                   "l"(src), "r"(bytes)
                   : "memory");
    else
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                   "l"(src), "r"(bytes)
                   : "memory");
  } else {
    const int8_t* s = static_cast<const int8_t*>(src);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int b = 4 * w < bytes ? 4 : 0;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                       dst + 4 * w),
                   "l"(s + (b > 0 ? 4 * w : 0)), "r"(b)
                   : "memory");
    }
  }
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
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

// The stage schedule's ring position.
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

// One work item = one kSA x kSB site-pair block of one tile pair.
struct Item {
  int64_t kt;
  int bi, bj;
};

template <class G>
__device__ __forceinline__ Item item_of(int item, int tile) {
  const int nb = (tile + G::kSB - 1) / G::kSB;
  const int per_tile = ((tile + G::kSA - 1) / G::kSA) * nb;
  return {item / per_tile, (item % per_tile) / nb, (item % per_tile) % nb};
}

// The live B blocks [lo, hi] of A block bi of the tile pair (ti, tj): B
// block bj is live iff it holds a pair that finalize_item can keep, some
// A site gi and B site gj of the block with gi < gj < n_sites.  With a0 =
// ti T + bi kSA, b0 = tj T + bj kSB and b1 = min(tj T + min(bj kSB + kSB,
// T), n_sites) - 1 that is b0 <= b1 (the block holds a site below
// n_sites: bj <= hi) and a0 < b1 (its last such site lies above the
// block's first A site: bj >= lo).  lo > hi where none is.
template <class G>
__device__ __forceinline__ void live_span(const Params& p, int ti, int tj,
                                          int bi, int& lo, int& hi) {
  const int nb = (p.tile + G::kSB - 1) / G::kSB;
  const int bt = tj * p.tile;
  const int a0 = ti * p.tile + bi * G::kSA;
  const int room = p.n_sites - bt;       // B sites below n_sites
  hi = room > 0 ? min(nb - 1, (room - 1) / G::kSB) : -1;
  // a0 + 1 <= b1: a0 + 2 <= n_sites and a0 + 2 - bt <= min((bj + 1) kSB, T).
  const int need = a0 + 2 - bt;
  lo = need <= 0 ? 0 : (need + G::kSB - 1) / G::kSB - 1;
  if (a0 + 2 > p.n_sites || need > p.tile) hi = -1;
}

// Whether a work item is live: its tile pair emits and live_span holds it.
template <class G>
__device__ __forceinline__ bool is_live(const Params& p, const Item& w) {
  if (__ldg(p.emit + w.kt) == 0) return false;
  int lo, hi;
  live_span<G>(p, __ldg(p.tile_i + w.kt), __ldg(p.tile_j + w.kt), w.bi, lo,
               hi);
  return lo <= w.bj && w.bj <= hi;
}

// A CTA's live work items in launch order: the launch's live items
// numbered in item order, the CTA taking numbers blockIdx.x, + gridDim.x,
// ....  In a tile pair the live rows (kt, bi) are a prefix 0..rows - 1,
// each from B block lo(bi) to the same hi (live_span): lo = 0 in rows
// 0..full - 1, so a step skips those whole rows by one division and walks
// only the rows that cross the diagonal.  Only entering a tile pair reads
// memory (its emit and tiles).  Every role of the CTA walks the same
// sequence.
template <class G>
struct LiveWalk {
  int k;          // the launch's tile pairs
  int kt, bi, bj;
  int ti, tj;     // the item's site tiles
  int hi;         // the tile pair's last live B block
  int full;       // rows 0..full - 1 are live from B block 0
  int rows;       // rows 0..rows - 1 are live
  __device__ void start(const Params& p, int n_tiles) {
    k = n_tiles;
    kt = 0;
    enter(p);
    advance(p, blockIdx.x);
  }
  __device__ bool done() const { return kt >= k; }
  __device__ Item item() const { return {kt, bi, bj}; }
  // Row bi's first live B block (live_span's lo).
  __device__ int lo(const Params& p) const {
    if (bi < full) return 0;
    return ((ti - tj) * p.tile + bi * G::kSA + 2 + G::kSB - 1) / G::kSB - 1;
  }
  // The first tile pair from kt on with a live item: its rows, and (bi,
  // bj) its first live item.  Row bi is live (live_span) iff its first A
  // site a0 = ti T + bi kSA has a0 + 2 <= n_sites and a0 + 2 - tj T <= T,
  // and starts at B block 0 iff a0 + 2 - tj T <= kSB.
  __device__ void enter(const Params& p) {
    const int na = (p.tile + G::kSA - 1) / G::kSA;
    const int nb = (p.tile + G::kSB - 1) / G::kSB;
    for (; kt < k; ++kt) {
      if (__ldg(p.emit + kt) == 0) continue;
      ti = __ldg(p.tile_i + kt);
      tj = __ldg(p.tile_j + kt);
      const int room = p.n_sites - tj * p.tile;
      hi = room > 0 ? min(nb - 1, (room - 1) / G::kSB) : -1;
      const int d = (tj - ti) * p.tile;
      const int lim = min(p.n_sites - ti * p.tile, p.tile + d) - 2;
      rows = hi < 0 || lim < 0 ? 0 : min(na, lim / G::kSA + 1);
      const int flim = G::kSB - 2 + d;
      full = flim < 0 ? 0 : min(rows, flim / G::kSA + 1);
      if (rows > 0) {
        bi = 0;
        bj = lo(p);
        return;
      }
    }
  }
  // Step n live items on.
  __device__ void advance(const Params& p, int n) {
    while (kt < k && bj + n > hi) {
      n -= hi - bj + 1;    // past this row's last, onto the next row's first
      if (++bi < full) {   // whole rows of hi + 1 live items
        const int m = min(full - bi, n / (hi + 1));
        bi += m;
        n -= m * (hi + 1);
      }
      if (bi < rows) {
        bj = lo(p);
      } else {
        ++kt;
        enter(p);
      }
    }
    bj += n;
  }
};

// The reference seq chunks of an item and their kCols-column steps.
template <class G>
struct Chunks {
  int c0 = 0, k0 = 0;
  __device__ int width(const Params& p) const {
    return min(G::kCols, c0 + p.seq_chunk - k0);
  }
  // Step to the next stage; true when the item ends.
  __device__ bool next(const Params& p) {
    k0 += G::kCols;
    if (k0 < c0 + p.seq_chunk) return false;
    c0 += p.seq_chunk;
    k0 = c0;
    if (c0 < p.n_pad) return false;
    c0 = k0 = 0;
    return true;
  }
};

// The stages of a CTA in order: its live work items (LiveWalk), in each the
// stages of Chunks.
template <class G>
struct StageWalk : LiveWalk<G>, Chunks<G> {
  __device__ void next(const Params& p) {
    if (Chunks<G>::next(p)) this->advance(p, gridDim.x);
  }
};

// ---------------------------------------------------------------------------
// Producer: raw rows by cp.async, then the operand build.
// ---------------------------------------------------------------------------

// Raw row of plane u (codes: the code row) of an A (or B) site of the
// item, rows past the tile edge clamped to the tile's last site (masked at
// the store).
template <class G, bool PRE>
__device__ __forceinline__ const int8_t* site_row(const Params& p,
                                                  const StageWalk<G>& w,
                                                  bool is_a, int site, int u) {
  const int loc = min(is_a ? w.bi * G::kSA + site : w.bj * G::kSB + site,
                      p.tile - 1);
  const int64_t t = is_a ? w.ti : w.tj;
  if constexpr (PRE)
    return p.planes + ((t * G::kP + u) * p.tile + loc) * p.n_pad;
  else
    return p.codes + (t * p.tile + loc) * p.n_pad;
}

// The byte-splat code of plane u.
__device__ __forceinline__ uint32_t plane_splat(const Params& p, int u) {
  return (uint32_t)((p.packed >> (3 * u)) & 7) * 0x01010101u;
}

// Copy builder ROLE's raw slots of one stage (columns [k0 + 16 (pt %
// kPieces), +16), zero past the stage width) into this thread's slots of a
// raw buffer: its tasks' rows (the codes entry's B builder: each B site's
// code row once), then (B builder) the stage's weights once (q_l rows, or
// two 8-column halves of each bf16 pass row), one chunk a thread.
template <class G, bool PRE, int ROLE>
__device__ __forceinline__ void fetch_raw(const Params& p,
                                          const StageWalk<G>& w, uint32_t raw,
                                          int pt) {
  const int col = 16 * (pt % G::kPieces);
  const int width = w.width(p);
  const int bytes = min(max(width - col, 0), 16);
  const int off = bytes > 0 ? w.k0 + col : 0;
  const bool v16 = p.vec16 != 0;
  auto dst = [&](int j) { return raw + (j * kProducers + pt) * 16; };
  if constexpr (ROLE == 0) {
#pragma unroll
    for (int i = 0; i < G::kARounds; ++i) {
      const int a = pt / G::kPieces + G::kRound * i;
      if (a >= G::kSA) break;
#pragma unroll
      for (int u = 0; u < G::kSrc; ++u)
        fetch16(dst(i * G::kSrc + u),
                site_row<G, PRE>(p, w, true, a, u) + off, bytes, v16, false);
    }
  } else {
#pragma unroll
    for (int i = 0; i < G::kBRounds; ++i) {
      const int t = pt / G::kPieces + G::kRound * i;
      if (t >= G::kBTasks) break;
      const int b = t % G::kSB;
      if constexpr (PRE)
        fetch16(dst(i), site_row<G, PRE>(p, w, false, b, t / G::kSB) + off,
                bytes, v16, false);
      else if (t < G::kSB)  // plane 0's task fetches the site's code row
        fetch16(raw + (b * G::kPieces + pt % G::kPieces) * 16,
                site_row<G, PRE>(p, w, false, b, 0) + off, bytes, v16,
                false);
    }
    if (pt < G::kWSlots * G::kPieces) {  // weight slot j, piece pt % kPieces
      const int j = pt / G::kPieces;
      const uint32_t wdst = raw + G::kWBase + pt * 16;
      if constexpr (G::kBf16) {
        const int c = 16 * (pt % G::kPieces) + 8 * (j & 1);
        const int b = 2 * min(max(width - c, 0), 8);
        fetch16(wdst,
                p.wb + (int64_t)(j >> 1) * p.n_pad + (b > 0 ? w.k0 + c : 0),
                b, v16, false);
      } else {
        const int c = 16 * (pt % G::kPieces);
        const int b = min(max(width - c, 0), 16);
        fetch16(wdst, p.q + (int64_t)j * p.n_pad + (b > 0 ? w.k0 + c : 0), b,
                v16, false);
      }
    }
  }
}

// Widen the byte masks of 16 columns to the halfword masks of their bf16
// values: `lo` columns 0..7 and `hi` 8..15, or the other way round where
// the piece is swapped (byte selectors sel = {0x1100, 0x3322} or {0x5544,
// 0x7766}: bytes of m.x / m.y, or of m.z / m.w).
__device__ __forceinline__ void widen(uint4 m, uint2 sel, uint4& lo,
                                      uint4& hi) {
  const uint32_t h0 = sel.x ^ 0x4444u, h1 = sel.y ^ 0x4444u;
  lo = make_uint4(__byte_perm(m.x, m.z, sel.x), __byte_perm(m.x, m.z, sel.y),
                  __byte_perm(m.y, m.w, sel.x), __byte_perm(m.y, m.w, sel.y));
  hi = make_uint4(__byte_perm(m.x, m.z, h0), __byte_perm(m.x, m.z, h1),
                  __byte_perm(m.y, m.w, h0), __byte_perm(m.y, m.w, h1));
}

// Store one 16-column piece of an operand row at byte offset `at` of the
// stage (int8: one chunk; bf16: two, at `at` and `at2`): the mask times the
// weight (int8 q_l or 1; the bf16 bits of the pass, or bf16 1.0).
template <bool BF16>
__device__ __forceinline__ void put(uint8_t* __restrict__ st, uint32_t at,
                                    uint32_t at2,
                                    uint4 m, uint4 m_hi, uint4 w_lo,
                                    uint4 w_hi) {
  *reinterpret_cast<uint4*>(st + at) = and4(m, w_lo);
  if constexpr (BF16) *reinterpret_cast<uint4*>(st + at2) = and4(m_hi, w_hi);
}

// Builder ROLE's share of one stage from this thread's landed raw slots.
// Masks: one __vcmpeq4 per code word against the plane's code, or the 0/1
// plane bytes times 0xff, zero past the stage width.  A builder: per A
// site the P A rows (int8 1, or bf16 1.0, where the mask is set).  B
// builder: per (plane u, B site) the plane's B row in every pass (the mask
// times q_l or the pass's bf16 weight bits; the unit pass: 1).  Every row
// of a site has the same row % 8 (kSA, kSB, kRB are multiples of 8), so its
// swizzled chunk offsets are the site's plus a multiple of 1,024.
template <class G, bool PRE, int ROLE>
__device__ __forceinline__ void build_stage(const Params& p, int width,
                                            const uint8_t* __restrict__ raw,
                                            uint8_t* __restrict__ sa, int pt) {
  const int ch = pt % G::kPieces;
  const int col = 16 * ch;
  // Raw bytes past the stage width are zero: plane bytes give no mask
  // there, codes (code 0) need the columns masked in a partial stage.
  const bool part = width < G::kCols;
  const uint4 valid = make_uint4(col < width ? ~0u : 0u,
                                 col + 4 < width ? ~0u : 0u,
                                 col + 8 < width ? ~0u : 0u,
                                 col + 12 < width ? ~0u : 0u);
  const uint4* slot = reinterpret_cast<const uint4*>(raw) + pt;
  const uint4 one = splat4(G::kBf16 ? 0x3F803F80u : 0x01010101u);
  // A swapped piece (piece_at) stores columns 8..15 first: its masks and
  // weights are swapped to match.
  const bool sw = swapped<G>(ch);
  const uint2 sel = sw ? make_uint2(0x5544u, 0x7766u)
                       : make_uint2(0x1100u, 0x3322u);
  if constexpr (ROLE == 0) {
#pragma unroll
    for (int i = 0; i < G::kARounds; ++i) {
      const int a = pt / G::kPieces + G::kRound * i;
      if (a >= G::kSA) break;
      uint32_t at, at2;
      piece_at<G>(a, ch, at, at2);
      uint4 code;
      if constexpr (!PRE) code = slot[i * kProducers];
#pragma unroll
      for (int u = 0; u < G::kP; ++u) {
        uint4 m, m_hi;
        if constexpr (PRE)
          m = mask_of_ones(slot[(i * G::kSrc + u) * kProducers]);
        else
          m = part ? and4(eq4(code, plane_splat(p, u)), valid)
                   : eq4(code, plane_splat(p, u));
        if constexpr (G::kBf16) widen(m, sel, m, m_hi);
        const uint32_t r8 = u * G::kSA / 8 * 1024;
        put<G::kBf16>(sa, at + r8, at2 + r8, m, m_hi, one, one);
      }
    }
  } else {
    // Weight slots: one per int8 level; two per bf16 pass (its columns 0..7
    // and 8..15 of the piece), read in the order the piece stores them.
    uint4 w[G::kWSlots > 0 ? G::kWSlots : 1];
#pragma unroll
    for (int j = 0; j < G::kWSlots; ++j)
      w[j] = reinterpret_cast<const uint4*>(raw + G::kWBase)
          [(sw ? j ^ 1 : j) * G::kPieces + ch];
    uint8_t* const sb = sa + kABytes;
#pragma unroll
    for (int i = 0; i < G::kBRounds; ++i) {
      const int t = pt / G::kPieces + G::kRound * i;
      if (t >= G::kBTasks) break;
      const int b = t % G::kSB;
      const int u = t / G::kSB;
      uint32_t at, at2;
      piece_at<G>(b, ch, at, at2);
      const uint32_t ru = u * G::kSB / 8 * 1024;
      uint4 m, m_hi;
      if constexpr (PRE) {
        m = mask_of_ones(slot[i * kProducers]);
      } else {
        m = eq4(reinterpret_cast<const uint4*>(raw)[b * G::kPieces + ch],
                plane_splat(p, u));
        if (part) m = and4(m, valid);
      }
      if constexpr (G::kBf16) widen(m, sel, m, m_hi);
#pragma unroll
      for (int l = 0; l < G::kPasses; ++l) {
        const uint32_t r8 = ru + l * G::kRB / 8 * 1024;
        if constexpr (G::kBf16)
          put<true>(sb, at + r8, at2 + r8, m, m_hi,
                    l < G::kW ? w[2 * l] : one, l < G::kW ? w[2 * l + 1] : one);
        else
          put<false>(sb, at + r8, at2 + r8, m, m_hi, l < G::kW ? w[l] : one,
                     one);
      }
    }
  }
}

// A builder of the preplaned integer modes: per stage, once the consumers
// have released it, cp.async each A site's P plane rows into their A rows
// (zero past the stage width); the full barrier completes when they have
// landed.
template <class G>
__device__ __forceinline__ void produce_direct(const Params& p, int k,
                                               uint32_t stages, uint32_t full,
                                               uint32_t empty, int pt) {
  const int ch = pt % G::kPieces;
  const int col = 16 * ch;
  const bool v16 = p.vec16 != 0;
  StageWalk<G> at;
  at.start(p, k);
  Cursor<G::kStages> cur;
  while (!at.done()) {
    const int bytes = min(max(at.width(p) - col, 0), 16);
    const int off = bytes > 0 ? at.k0 + col : 0;
    mbar_wait(empty + 8 * cur.stage, cur.phase ^ 1);
    const uint32_t sa = stages + cur.stage * G::kStageBytes;
#pragma unroll
    for (int i = 0; i < G::kARounds; ++i) {
      const int a = pt / G::kPieces + G::kRound * i;
      if (a >= G::kSA) break;
      uint32_t off_a, off_a2;
      piece_at<G>(a, ch, off_a, off_a2);
#pragma unroll
      for (int u = 0; u < G::kP; ++u)
        fetch16(sa + off_a + u * G::kSA / 8 * 1024,
                site_row<G, true>(p, at, true, a, u) + off, bytes, v16,
                false);
    }
    cp_async_arrive(full + 8 * cur.stage);
    cur.next();
    at.next(p);
  }
  cp_async_wait<0>();
}

// The B builder warpgroup's barrier (named barrier 2).
__device__ __forceinline__ void builder_sync() {
  asm volatile("bar.sync 2, %0;" ::"n"(kProducers) : "memory");
}

// Builder warpgroup ROLE: the raw slots of the next kRawDepth - 1 stages
// are in flight (cp.async into the other raw buffers; walk `ahead`) while
// this stage is built (its columns: `at`, `pending` stages fetched and not
// yet built); the full barrier completes when every thread of both
// builders has built its share.
template <class G, bool PRE, int ROLE>
__device__ __forceinline__ void produce(const Params& p, int k,
                                        uint8_t* gst, uint32_t raw,
                                        const uint8_t* graw, uint32_t full,
                                        uint32_t empty, int pt) {
  constexpr int kDepth = G::kRawDepth;
  // This builder's part of each raw buffer.
  constexpr int kBase = ROLE == 0 ? 0 : G::kSlotsA * kProducers * 16;
  StageWalk<G> ahead;
  ahead.start(p, k);
  if (ahead.done()) return;
  int pending = 0;
  auto fetch = [&](int slot) {
    if (!ahead.done()) {
      fetch_raw<G, PRE, ROLE>(p, ahead, raw + slot * G::kRawBytes + kBase,
                              pt);
      ahead.next(p);
      ++pending;
    }
    cp_async_commit();  // one group per stage, empty past the end
  };
#pragma unroll
  for (int i = 0; i < kDepth - 1; ++i) fetch(i);
  Chunks<G> at;
  Cursor<G::kStages> cur;
  int slot = 0;  // this stage's raw buffer
  // The B builder shares the stage's weights (and, in the codes entry,
  // each B site's code row) between threads: the raw buffer is refilled
  // only after every thread has built from it, and built from only after
  // every thread's copy has landed.
  constexpr bool kShared = ROLE == 1;
  while (pending > 0) {
    if constexpr (kShared) builder_sync();
    fetch(slot == 0 ? kDepth - 1 : slot - 1);
    cp_async_wait<kDepth - 1>();  // this stage's raw slots have landed
    if constexpr (kShared) builder_sync();
    mbar_wait(empty + 8 * cur.stage, cur.phase ^ 1);
    build_stage<G, PRE, ROLE>(p, at.width(p),
                              graw + slot * G::kRawBytes + kBase,
                              gst + cur.stage * G::kStageBytes, pt);
    fence_proxy_async();  // generic-proxy writes -> wgmma reads
    mbar_arrive(full + 8 * cur.stage);
    cur.next();
    slot = slot == kDepth - 1 ? 0 : slot + 1;
    at.next(p);
    --pending;
  }
}

// ---------------------------------------------------------------------------
// The body: producers, consumers.
// ---------------------------------------------------------------------------

// The consumer warpgroups' barrier (named barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// Zero the keep block of a dead item (thread t of nt): a padding tile
// pair's (emit == 0), or one that holds no pair finalize_item could keep.
// Its d, d_prime and r2 are not written: they mean something only where
// keep is set.
template <class G>
__device__ __forceinline__ void zero_keep(const Params& p, const Item& w,
                                          int t, int nt) {
  for (int q = t; q < G::kSA * G::kSB; q += nt) {
    const int li = w.bi * G::kSA + q / G::kSB;
    const int lj = w.bj * G::kSB + q % G::kSB;
    if (li < p.tile && lj < p.tile)
      p.keep[(w.kt * p.tile + li) * p.tile + lj] = 0;
  }
}

// Finalize the pairs of one live item from its cells (consumer thread ct
// of 256): the counts (the unit joint's marginals), major and dominant
// minor at both sites (_ld_finalize, pallas_ld.py:503-528), the four
// selected cells, the pair algebra and the stores.
template <class G, bool UNIT>
__device__ __forceinline__ void finalize_item(const Params& p, const Item& w,
                                              const int32_t* uj,
                                              const float* run, int ct) {
  constexpr int P = G::kP;
  const int tile = p.tile;
  const int ti = p.tile_i[w.kt];
  const int tj = p.tile_j[w.kt];
  for (int q = ct; q < G::kSA * G::kSB; q += kConsumers) {
    const int li = w.bi * G::kSA + q / G::kSB;
    const int lj = w.bj * G::kSB + q % G::kSB;
    if (li >= tile || lj >= tile) continue;
    const int64_t o = (w.kt * tile + li) * tile + lj;
    const int32_t* J = uj + q * P * P;
    int32_t ca[P], cb[P];
#pragma unroll
    for (int s = 0; s < P; ++s) ca[s] = cb[s] = 0;
#pragma unroll
    for (int s = 0; s < P; ++s)
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int32_t v = J[s * P + u];
        ca[s] += v;
        cb[u] += v;
      }
    int maj_a, dmin_a, dist_a, maj_b, dmin_b, dist_b;
    major_dmin<P>(ca, p, maj_a, dmin_a, dist_a);
    major_dmin<P>(cb, p, maj_b, dmin_b, dist_b);
    bool keep = dist_a > 1 && dist_b > 1;
    // Selecting an entry returns it bit for bit (the reference's masked
    // sums add exact zeros).
    auto cell = [&](int s, int u) {
      if constexpr (UNIT)
        return (float)J[s * P + u];
      else
        return run[q * P * P + s * P + u];
    };
    float d, dpr, r2v;
    pair_algebra(cell(maj_a, maj_b), cell(maj_a, dmin_b), cell(dmin_a, maj_b),
                 cell(dmin_a, dmin_b), keep, d, dpr, r2v);
    const int64_t gi = (int64_t)ti * tile + li;
    const int64_t gj = (int64_t)tj * tile + lj;
    keep = keep && gi < gj && gj < p.n_sites;
    p.d[o] = d;
    p.dp[o] = dpr;
    p.r2[o] = r2v;
    p.keep[o] = keep ? 1 : 0;
  }
}

// Persistent: each CTA walks its share of the live work items (LiveWalk);
// the stage ring runs on across items, so the producers fill the next
// item's first stages while the consumers combine and finalize the last
// one.  The consumers first zero the keep blocks of the dead items
// blockIdx.x, + gridDim.x, ..., a warp each in turn.
template <int P, int NLEV, int NFLT, bool UNIT, bool PRE>
__global__ void __launch_bounds__(kThreads, 1)
ld_general_wgmma(const Params p, int k) {
  using G = Geom<P, NLEV, NFLT, UNIT, PRE>;
  static_assert(G::kFits, "shared memory of one CTA");
  constexpr int kStages = G::kStages;
  constexpr int kStageBytes = G::kStageBytes;
  constexpr int kPairs = G::kSA * G::kSB;
  constexpr int R = G::kN / 2;  // accumulator registers per thread
  using Acc = typename std::conditional<G::kBf16, float, int32_t>::type;
  extern __shared__ uint8_t smem_raw[];

  const int tile = p.tile;
  const int tid = threadIdx.x;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t rawbuf = base + kStages * kStageBytes;
  const uint32_t cells = rawbuf + G::kRawDepth * G::kRawBytes;
  // The cells of one item, pair (a, b) at (a * kSB + b) * P * P: the unit
  // joint (int32) and, weighted, the f32 running cells of every (s, u).
  int32_t* const uj = reinterpret_cast<int32_t*>(gbase + (cells - base));
  float* const run = reinterpret_cast<float*>(uj + kPairs * P * P);
  const uint32_t full = cells + G::kCellBytes;
  const uint32_t empty = full + 8 * kStages;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kProducerThreads);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(G::kOtherRegs));
    const int pt = tid - kConsumers;
    const uint8_t* const graw = gbase + (rawbuf - base);
    if (pt < kProducers) {
      if constexpr (G::kDirectA)
        produce_direct<G>(p, k, base, full, empty, pt);
      else
        produce<G, PRE, 0>(p, k, gbase, rawbuf, graw, full, empty, pt);
    } else {
      produce<G, PRE, 1>(p, k, gbase, rawbuf, graw, full, empty,
                         pt - kProducers);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(G::kConsumerRegs));
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  // This thread's fragment rows: A rows r0 and r0 + 8 of the 128.
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  float a[NLEV > 0 ? NLEV : 1];
#pragma unroll
  for (int l = 0; l < NLEV; ++l) a[l] = p.scale[l];
  {
    // 32 of the CTA's candidates a warp and step, the dead ones zeroed by
    // the warp that found them.
    const int n_items = k * ((tile + G::kSA - 1) / G::kSA) *
                        ((tile + G::kSB - 1) / G::kSB);
    const int stride = gridDim.x * 32;
    for (int c = blockIdx.x + (tid >> 5) * stride; c < n_items;
         c += kConsumers / 32 * stride) {
      const int item = c + lane * gridDim.x;
      const bool dead =
          item < n_items && !is_live<G>(p, item_of<G>(item, tile));
      for (uint32_t m = __ballot_sync(~0u, dead); m != 0; m &= m - 1)
        zero_keep<G>(p, item_of<G>(c + (__ffs(m) - 1) * gridDim.x, tile),
                     lane, 32);
    }
  }
  Acc D[R];
  Cursor<kStages> cur;
  LiveWalk<G> live;
  for (live.start(p, k); !live.done(); live.advance(p, gridDim.x)) {
    const Item w = live.item();
    for (int c0 = 0; c0 < p.n_pad; c0 += p.seq_chunk) {
      int scale_d = 0;   // the chunk's first wgmma starts a new sum
      int prev = -1;     // the stage whose wgmma group may still run
#pragma unroll
      for (int i = 0; i < R; ++i) D[i] = 0;
      for (int k0 = c0; k0 < c0 + p.seq_chunk; k0 += G::kCols) {
        mbar_wait(full + 8 * cur.stage, cur.phase);
        fence_proxy_async();
        const uint32_t sa = base + cur.stage * kStageBytes;
        fence_regs<R>(D);
        wgmma_fence();
        // The four K steps of each half (32 bytes each: 32 int8 or 16 bf16
        // columns); columns past a partial stage's width are zero in both
        // operands.
#pragma unroll
        for (int h = 0; h < G::kHalves; ++h) {
          const uint32_t sh = sa + h * G::kHalfBytes;
          const uint64_t da = sw128_desc(sh + wg * 64 * kRowBytes);
          const uint64_t db = sw128_desc(sh + kABytes);
          wgmma<G::kN>(D, da, db, h == 0 ? scale_d : 1);
          wgmma<G::kN>(D, da + 2, db + 2, 1);
          wgmma<G::kN>(D, da + 4, db + 4, 1);
          wgmma<G::kN>(D, da + 6, db + 6, 1);
        }
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
      // Every consumer has finalized the last item from the cells.
      if (c0 == 0) consumers_sync();
      // Combine once per seq chunk (pallas_ld.py:290-315): fragment entry
      // 4k + 2h + c holds A row r0 + 8h and B column 8k + 2 (lane % 4) + c;
      // pass l's block starts kRB / 8 n8 blocks after pass l - 1's.
      constexpr int kStride = G::kRB / 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int arow = r0 + 8 * h;
        if (arow >= P * G::kSA) continue;
        const int s = arow / G::kSA;
        const int ia = arow - s * G::kSA;
#pragma unroll
        for (int kb = 0; kb < G::kRB / 8; ++kb)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int rb = 8 * kb + 2 * (lane & 3) + c;
            const int u = rb / G::kSB;
            const int jb = rb - u * G::kSB;
            const int i0 = 4 * kb + 2 * h + c;
            const int q = ((ia * G::kSB + jb) * P + s) * P + u;
            const int32_t ju = (int32_t)D[i0 + G::kW * kStride];
            uj[q] = c0 == 0 ? ju : uj[q] + ju;
            if constexpr (!UNIT) {
              float cell;
              if constexpr (G::kBf16) {
                cell = (float)D[i0];
                if constexpr (NFLT == 2)        // split_bf16: F_hi + F_lo
                  cell = cell + (float)D[i0 + kStride];
                if constexpr (NLEV == 1)        // lo_int8: F + alpha * J
                  cell = cell + a[0] * (float)D[i0 + kStride];
              } else {                          // sum_l a_l * J_l
                cell = a[0] * (float)D[i0];
#pragma unroll
                for (int l = 1; l < NLEV; ++l)
                  cell = cell + a[l] * (float)D[i0 + l * kStride];
              }
              run[q] = c0 == 0 ? cell : run[q] + cell;
            }
          }
      }
    }
    // Every consumer has combined the item's last chunk.
    consumers_sync();
    finalize_item<G, UNIT>(p, w, uj, run, tid);
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

// Launch one instantiation on the launch's k tile pairs.
struct Launch {
  const Params& p;
  int k;
  cudaStream_t stream;
  template <int P, int NLEV, int NFLT, bool UNIT, bool PRE>
  int run() const {
    using G = Geom<P, NLEV, NFLT, UNIT, PRE>;
    auto kern = ld_general_wgmma<P, NLEV, NFLT, UNIT, PRE>;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (e != cudaSuccess) return (int)e;
    const int64_t items = (int64_t)k * ((p.tile + G::kSA - 1) / G::kSA) *
                          ((p.tile + G::kSB - 1) / G::kSB);
    const int grid = (int)(items < sm_count() ? items : sm_count());
    kern<<<grid, kThreads, G::kSmem, stream>>>(p, k);
    return (int)cudaGetLastError();
  }
};

// Name one instantiation's work item: kSA A sites x kSB B sites.
struct Block {
  int* sa;
  int* sb;
  template <int P, int NLEV, int NFLT, bool UNIT, bool PRE>
  int run() const {
    using G = Geom<P, NLEV, NFLT, UNIT, PRE>;
    *sa = G::kSA;
    *sb = G::kSB;
    return 0;
  }
};

// The instantiation by weight mode; any other (nlev, nflt) is refused.
template <int P, bool PRE, class Op>
int by_mode(const Op& op, int nlev, int nflt, bool unit) {
  if (unit) return op.template run<P, 0, 0, true, PRE>();
  if (nflt == 0 && nlev == 2) return op.template run<P, 2, 0, false, PRE>();
  if (nflt == 0 && nlev == 3) return op.template run<P, 3, 0, false, PRE>();
  if (nlev == 0 && nflt == 1) return op.template run<P, 0, 1, false, PRE>();
  if (nlev == 0 && nflt == 2) return op.template run<P, 0, 2, false, PRE>();
  if (nlev == 1 && nflt == 1) return op.template run<P, 1, 1, false, PRE>();
  return (int)cudaErrorInvalidValue;
}

template <bool PRE, class Op>
int dispatch(const Op& op, int n_planes, int nlev, int nflt, bool unit) {
  switch (n_planes) {
    case 1: return by_mode<1, PRE>(op, nlev, nflt, unit);
    case 2: return by_mode<2, PRE>(op, nlev, nflt, unit);
    case 3: return by_mode<3, PRE>(op, nlev, nflt, unit);
    case 4: return by_mode<4, PRE>(op, nlev, nflt, unit);
    case 5: return by_mode<5, PRE>(op, nlev, nflt, unit);
  }
  return (int)cudaErrorInvalidValue;
}

// Fills the Params shared by both entries; false when the arguments are
// outside what the kernel takes.
bool make_params(Params& p, const void* codes, const void* planes,
                 const void* q, const void* scale, const void* wb,
                 const void* tile_i, const void* tile_j, const void* emit,
                 void* d, void* dp, void* r2, void* keep, int tile,
                 int n_sites, int n_pad, int seq_chunk, int n_planes,
                 int packed_planes) {
  if (n_planes < 1 || n_planes > kPMax ||
      (codes == nullptr) == (planes == nullptr))
    return false;
  if (tile <= 0 || seq_chunk <= 0 || seq_chunk % 4 || n_pad % seq_chunk)
    return false;
  p = Params{};
  p.codes = static_cast<const int8_t*>(codes);
  p.planes = static_cast<const int8_t*>(planes);
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.wb = static_cast<const uint16_t*>(wb);
  p.tile_i = static_cast<const int32_t*>(tile_i);
  p.tile_j = static_cast<const int32_t*>(tile_j);
  p.emit = static_cast<const int32_t*>(emit);
  p.d = static_cast<float*>(d);
  p.dp = static_cast<float*>(dp);
  p.r2 = static_cast<float*>(r2);
  p.keep = static_cast<int8_t*>(keep);
  p.tile = tile;
  p.n_sites = n_sites;
  p.n_pad = n_pad;
  p.seq_chunk = seq_chunk;
  p.vec16 = n_pad % 16 == 0 && seq_chunk % 16 == 0;
  p.packed = packed_planes & ((1 << (3 * n_planes)) - 1);
  return true;
}

}  // namespace

// Entry for _ld_kernel: the weighted general kernel.  Exactly one of
// `codes` ([s_pad, n_pad] site-major codes) and `planes` ([grid*P*T, n_pad]
// one-hot planes of build_planes_tiled) is non-null.  `packed_planes`
// holds the P plane codes, 3 bits each (plane s at bits 3s..3s+2).  nlev
// int8 cascade levels (2 or 3, `q` and `scale`) or nflt bf16 passes (1 or
// 2: `wb` holds their bits, [nflt, n_pad] uint16), or lo_int8 (nlev = nflt
// = 1: `wb` holds w_hi's and the residual level q's bits, `scale` alpha).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ld_general(const void* codes, const void* planes, const void* q,
                          const void* scale, const void* wb,
                          const void* tile_i, const void* tile_j,
                          const void* emit, void* d, void* dp, void* r2,
                          void* keep, int k, int tile, int n_sites, int s_pad,
                          int n_pad, int seq_chunk, int nlev, int nflt,
                          int n_planes, int packed_planes, void* stream) {
  (void)s_pad;
  Params p;
  if (!make_params(p, codes, planes, q, scale, wb, tile_i, tile_j, emit, d, dp,
                   r2, keep, tile, n_sites, n_pad, seq_chunk, n_planes,
                   packed_planes))
    return (int)cudaErrorInvalidValue;
  if (k <= 0) return 0;
  const Launch op{p, k, static_cast<cudaStream_t>(stream)};
  return planes != nullptr ? dispatch<true>(op, n_planes, nlev, nflt, false)
                           : dispatch<false>(op, n_planes, nlev, nflt, false);
}

// Entry for _ld_kernel_unit: unit weights, one int32 joint over all of N
// converted to f32 once (q, scale, wb, nlev and nflt unused).
extern "C" int ld_general_unit(const void* codes, const void* planes,
                               const void* q, const void* scale,
                               const void* wb, const void* tile_i,
                               const void* tile_j, const void* emit, void* d,
                               void* dp, void* r2, void* keep, int k, int tile,
                               int n_sites, int s_pad, int n_pad,
                               int seq_chunk, int nlev, int nflt, int n_planes,
                               int packed_planes, void* stream) {
  (void)s_pad;
  (void)nlev;
  (void)nflt;
  Params p;
  if (!make_params(p, codes, planes, q, scale, wb, tile_i, tile_j, emit, d, dp,
                   r2, keep, tile, n_sites, n_pad, seq_chunk, n_planes,
                   packed_planes))
    return (int)cudaErrorInvalidValue;
  if (k <= 0) return 0;
  p.seq_chunk = n_pad;  // one chunk: the joint converts once
  p.vec16 = n_pad % 16 == 0;
  const Launch op{p, k, static_cast<cudaStream_t>(stream)};
  return planes != nullptr ? dispatch<true>(op, n_planes, 0, 0, true)
                           : dispatch<false>(op, n_planes, 0, 0, true);
}

// The work item of the body that ld_general (ld_general_unit where `unit`)
// launches for n_planes planes, weight mode (nlev, nflt) and the preplaned
// entry where `pre`: *sa A sites x *sb B sites.  Host only, nothing runs on
// the card; cudaErrorInvalidValue (1) for what the entries refuse.
extern "C" int ld_general_block(int n_planes, int nlev, int nflt, int unit,
                                int pre, int* sa, int* sb) {
  const Block op{sa, sb};
  return pre ? dispatch<true>(op, n_planes, nlev, nflt, unit != 0)
             : dispatch<false>(op, n_planes, nlev, nflt, unit != 0);
}
