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
// What bounds it on the H100.  Like the factorized kernel, integer
// dot-product issue rate, not memory: each pair contracts N sequences for
// every count and cell it needs, and each output is 13 bytes.
//
// What the design does about that.  The TPU kernel contracts the whole
// pT x pT weighted joint plus two pT x T count blocks per tile pair in VMEM
// (p^2 * L + 2p dot products per pair and sequence word: 85 at p = 5 and
// three int8 levels), and selects four cells per pair afterwards.  Here a
// CTA owns a 32 x 32 block of site pairs (256 threads, 2 x 2 pairs each) and
// makes two passes over the sequence axis:
//   1. counts: 2p __dp4a per pair and word, of the 0/1 plane indicators of
//      one site against the validity (union of the planes) of the other;
//      this fixes each pair's major and dominant minor at both sites;
//   2. cells: the four selected cells only, L int8 levels each, combined in
//      f32 once per seq chunk -- the factorized kernel's body with maj/dmin
//      chosen per pair instead of per site.
// That is 2p + 4L dot products per pair and word (22 at p = 5, L = 3)
// instead of p^2 L + 2p.  Selecting a cell in the reference (rm + jw * 1.0,
// then + jw * 0.0) returns the joint entry bit for bit, so computing only
// the selected entries gives the same bits.  Each pass stages 64 sequence
// columns of the CTA's 32 A-side and 32 B-side sites in shared memory as
// packed 0/1 indicator words, one plane per allele plus the validity plane
// (built from the codes with __vcmpeq4, or read from the preplaned planes).
// A tile pair with emit == 0 only zeroes its keep block.
//
// Numerics that must match the JAX package bit for bit where it is exact:
//   * Counts and int8 joints are exact integers.  The weighted int8 cascade
//     combines once per seq chunk: cells = a1*J1 + a2*J2 + a3*J3 (left to
//     right), acc = cells on the first chunk and acc += cells after.  The
//     unit kernel accumulates its int32 joint over all of N and converts
//     once (_ld_kernel_unit).
//   * Built with -fmad=false and without --use_fast_math; the pair algebra
//     is that of ld_majmin.cu (reciprocal multiplied in, 0.95 as an f32
//     compare).
//   * Float weight passes (bf16-exact, split_bf16, and lo_int8's w_hi pass)
//     accumulate in f32 one staged word at a time, like the factorized
//     kernel: the f32 sum of the word's selected weights (column order) is
//     read from a 16-entry table per word and 4-bit byte mask.  Within f32
//     rounding of the reference, not bit for bit; exact, and so equal to
//     the plain version, wherever the f32 partial sums are.  lo_int8 adds
//     its int8 residual pass as F + alpha * J once per seq chunk
//     (pallas_ld.py:307-315).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;            // A-side sites per CTA
constexpr int kBN = 32;            // B-side sites per CTA
constexpr int kThreads = 256;      // 16 x 16 threads, 2 x 2 pairs each
constexpr int kKS = 64;            // sequence columns staged per step
constexpr int kKW = kKS / 4;       // packed 32-bit words per staged row
constexpr int kKWP = kKW + 1;      // padded row stride: no bank conflicts
constexpr int kPMax = 5;           // allele planes (codes 0..4)
// Words per staged plane, padded by one so that the same (row, word) of
// different planes falls in different banks (pass 2 reads a plane chosen
// per pair).
constexpr int kPlaneWords = kBM * kKWP + 1;
constexpr int kValid = kPMax;      // plane slot of the validity words

// 4-bit mask of a word of four 0/1 bytes (byte b -> bit b): the multiply
// moves each byte's bit to bits 24..27 and leaves its cross terms below.
__device__ __forceinline__ uint32_t mask4(uint32_t x) {
  return (x * 0x01020408u) >> 24;
}

struct Params {
  const int8_t* codes;    // [s_pad, n_pad] site-major codes   (codes)
  const int8_t* planes;   // [grid*P*T, n_pad] one-hot planes  (preplaned)
  const int8_t* q;        // [nlev, n_pad] int8 cascade levels
  const float* scale;     // [nlev] cascade scales a_l
  const float* wf;        // [nflt, n_pad] f32 pass weights
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
  int seq_chunk;
  int blocks_per_side;    // ceil(tile / 32)
  int n_planes;           // P
  int plane_code[kPMax];  // planes[s], the allele code of plane s
};

__device__ __forceinline__ uint32_t ld_word(const int8_t* base, int64_t off) {
  return *reinterpret_cast<const uint32_t*>(base + off);
}

__device__ __forceinline__ int at(int plane, int row, int w) {
  return plane * kPlaneWords + row * kKWP + w;
}

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

// Stage one 64-column step of 32 sites of site tile `tile_idx`, block `blk`
// of the tile: plane s of row r at at(s, r, w) as 0/1 bytes, the validity
// (union of the P planes) at at(kValid, r, w); zero beyond the tile edge
// and past `width` columns.
template <bool PRE>
__device__ __forceinline__ void stage_sites(const Params& p, uint32_t* s,
                                            int tile_idx, int blk, int k0,
                                            int width, int tid) {
  const int np = p.n_planes;
  // Rows of plane pl of one site are p.tile rows apart in the preplaned
  // layout (row g*P*T + pl*T + i).
  const int64_t plane_stride = (int64_t)p.tile * p.n_pad;
  // Not unrolled: each staged word keeps one base offset live, not one
  // address per plane and iteration (which cost the preplaned variant
  // 200 registers).
#pragma unroll 1
  for (int e = tid; e < kBM * kKW; e += kThreads) {
    const int row = e / kKW;
    const int w = e % kKW;
    const int loc = blk * kBM + row;
    const bool in = 4 * w < width && loc < p.tile;
    const int64_t off =
        ((int64_t)tile_idx * (PRE ? np : 1) * p.tile + loc) * p.n_pad + k0 +
        4 * w;
    uint32_t valid = 0u;
    uint32_t code = 0u;
    if (!PRE && in) code = ld_word(p.codes, off);
#pragma unroll
    for (int pl = 0; pl < kPMax; ++pl) {
      if (pl < np) {
        uint32_t ind = 0u;
        if (in) {
          if (PRE) {
            ind = ld_word(p.planes, off + pl * plane_stride);
          } else {
            ind = __vcmpeq4(code, (uint32_t)p.plane_code[pl] * 0x01010101u) &
                  0x01010101u;
          }
        }
        s[at(pl, row, w)] = ind;
        valid |= ind;
      }
    }
    s[at(kValid, row, w)] = valid;
  }
}

// _ld_finalize's major_dmin (pallas_ld.py:503-521), loop for loop: plane
// indices of the best and second-best score count*8 + (5 - code).
__device__ __forceinline__ void major_dmin(const int32_t (&cnt)[kPMax],
                                           const Params& p, int& maj,
                                           int& dmin, int& distinct) {
  int best = -1, best_idx = 0;
#pragma unroll
  for (int s = 0; s < kPMax; ++s) {
    if (s < p.n_planes) {
      const int score = cnt[s] * 8 + (5 - p.plane_code[s]);
      if (score > best) {
        best = score;
        best_idx = s;
      }
    }
  }
  int second = -1, second_idx = 0;
  distinct = 0;
#pragma unroll
  for (int s = 0; s < kPMax; ++s) {
    if (s < p.n_planes) {
      const int score = cnt[s] * 8 + (5 - p.plane_code[s]);
      if (score > second && best_idx != s) {
        second = score;
        second_idx = s;
      }
      distinct += cnt[s] > 0 ? 1 : 0;
    }
  }
  maj = best_idx;
  dmin = second_idx;
}

// NLEV > 0: int8 passes, cells J_l = dp4a((A_sel & B_sel), q_l) (UNIT: one
// count pass with q = 1 over all of N); NFLT > 0: f32 passes; both
// (lo_int8, NLEV = NFLT = 1): the w_hi pass and the residual level.  PRE
// selects the operand source: false = codes, true = preplaned one-hot
// planes.
// The second launch bound is the resident CTAs per SM the register
// allocation must allow: unbounded, ptxas gave the preplaned int8x3 variant
// 193-200 registers (one CTA per SM, 2.4x slower); the unit variants fit
// three CTAs.
template <int NLEV, int NFLT, bool PRE, bool UNIT>
__global__ void __launch_bounds__(kThreads, UNIT ? 3 : 2)
ld_general_kernel(const Params p) {
  constexpr int NA = NLEV > 0 ? NLEV : 1;
  constexpr int NF = NFLT > 0 ? NFLT : 1;
  constexpr bool LO = NLEV > 0 && NFLT > 0;
  __shared__ uint32_t sA[(kPMax + 1) * kPlaneWords];
  __shared__ uint32_t sB[(kPMax + 1) * kPlaneWords];
  __shared__ uint32_t sQ[NA][kKW];
  // Float passes: per staged word and 4-bit byte mask, the f32 sum of the
  // selected weights of its four columns, added in column order.
  __shared__ float sT[NF][kKW][16];

  const int bps = p.blocks_per_side;
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

  // ---- Pass 1: the per-pair count marginals over all of N. -------------
  int32_t ca[2][2][kPMax], cb[2][2][kPMax];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int s = 0; s < kPMax; ++s) ca[r][c][s] = cb[r][c][s] = 0;

  for (int k0 = 0; k0 < p.n_pad; k0 += kKS) {
    const int width = min(kKS, p.n_pad - k0);
    __syncthreads();  // the previous step's operands are consumed
    stage_sites<PRE>(p, sA, ti, bi, k0, width, tid);
    stage_sites<PRE>(p, sB, tj, bj, k0, width, tid);
    __syncthreads();
#pragma unroll 2
    for (int w = 0; w < kKW; ++w) {
      int va[2], vb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) va[r] = (int)sA[at(kValid, ty + 16 * r, w)];
#pragma unroll
      for (int c = 0; c < 2; ++c) vb[c] = (int)sB[at(kValid, tx + 16 * c, w)];
#pragma unroll
      for (int s = 0; s < kPMax; ++s) {
        if (s < p.n_planes) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int ia = (int)sA[at(s, ty + 16 * r, w)];
#pragma unroll
            for (int c = 0; c < 2; ++c)
              ca[r][c][s] = __dp4a(ia, vb[c], ca[r][c][s]);
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int ib = (int)sB[at(s, tx + 16 * c, w)];
#pragma unroll
            for (int r = 0; r < 2; ++r)
              cb[r][c][s] = __dp4a(va[r], ib, cb[r][c][s]);
          }
        }
      }
    }
  }

  // Per pair: word offsets of the selected planes' rows (A major, A dmin,
  // B major, B dmin) and the distinct > 1 verdict.
  int off[2][2][4];
  bool keep2[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int maj_a, dmin_a, dist_a, maj_b, dmin_b, dist_b;
      major_dmin(ca[r][c], p, maj_a, dmin_a, dist_a);
      major_dmin(cb[r][c], p, maj_b, dmin_b, dist_b);
      keep2[r][c] = dist_a > 1 && dist_b > 1;
      off[r][c][0] = at(maj_a, ty + 16 * r, 0);
      off[r][c][1] = at(dmin_a, ty + 16 * r, 0);
      off[r][c][2] = at(maj_b, tx + 16 * c, 0);
      off[r][c][3] = at(dmin_b, tx + 16 * c, 0);
    }

  // ---- Pass 2: the four selected cells, combined per seq chunk. ---------
  int32_t J[NA][2][2][4];
  float F[NF][2][2][4];
  float acc[2][2][4];
  const int chunk = UNIT ? p.n_pad : p.seq_chunk;

  for (int c0 = 0; c0 < p.n_pad; c0 += chunk) {
#pragma unroll
    for (int l = 0; l < NA; ++l)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) J[l][r][c][e] = 0;
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) F[f][r][c][e] = 0.0f;

    for (int k0 = c0; k0 < c0 + chunk; k0 += kKS) {
      const int width = min(kKS, c0 + chunk - k0);
      __syncthreads();
      stage_sites<PRE>(p, sA, ti, bi, k0, width, tid);
      stage_sites<PRE>(p, sB, tj, bj, k0, width, tid);
      if (NLEV > 0 && !UNIT) {
        for (int e = tid; e < NA * kKW; e += kThreads) {
          const int l = e / kKW;
          const int w = e % kKW;
          sQ[l][w] = 4 * w < width
                         ? ld_word(p.q, (int64_t)l * p.n_pad + k0 + 4 * w)
                         : 0u;
        }
      }
      if (NFLT > 0) {
        for (int e = tid; e < NF * kKW * 16; e += kThreads) {
          const int f = e / (kKW * 16);
          const int w = (e / 16) % kKW;
          const int m = e % 16;
          float t = 0.0f;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (((m >> b) & 1) && 4 * w + b < width)
              t = t + p.wf[(int64_t)f * p.n_pad + k0 + 4 * w + b];
          sT[f][w][m] = t;
        }
      }
      __syncthreads();

      if (NLEV > 0) {
#pragma unroll 2
        for (int w = 0; w < kKW; ++w) {
          int qw[NA];
#pragma unroll
          for (int l = 0; l < NA; ++l) qw[l] = UNIT ? 0 : (int)sQ[l][w];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const uint32_t am = sA[off[r][c][0] + w];
              const uint32_t ad = sA[off[r][c][1] + w];
              const uint32_t bm = sB[off[r][c][2] + w];
              const uint32_t bd = sB[off[r][c][3] + w];
              const uint32_t x[4] = {am & bm, am & bd, ad & bm, ad & bd};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if (UNIT) {
                  J[0][r][c][e] += __popc(x[e]);  // 0/1 bytes: popc = sum
                } else {
#pragma unroll
                  for (int l = 0; l < NA; ++l)
                    J[l][r][c][e] = __dp4a((int)x[e], qw[l], J[l][r][c][e]);
                }
              }
            }
        }
      }
      if (NFLT > 0) {
        for (int w = 0; w < kKW; ++w) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const uint32_t am = sA[off[r][c][0] + w];
              const uint32_t ad = sA[off[r][c][1] + w];
              const uint32_t bm = sB[off[r][c][2] + w];
              const uint32_t bd = sB[off[r][c][3] + w];
              const uint32_t m[4] = {mask4(am & bm), mask4(am & bd),
                                     mask4(ad & bm), mask4(ad & bd)};
#pragma unroll
              for (int f = 0; f < NF; ++f)
#pragma unroll
                for (int e = 0; e < 4; ++e) F[f][r][c][e] += sT[f][w][m[e]];
            }
        }
      }
    }

    // Combine once per seq chunk (pallas_ld.py:290-302, 307-315); the unit
    // kernel's single chunk converts its int32 joint once (:405-422).
    float a[NA];
#pragma unroll
    for (int l = 0; l < NA; ++l) a[l] = (NLEV > 0 && !UNIT) ? p.scale[l] : 1.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float cells;
          if (UNIT) {
            cells = (float)J[0][r][c][e];
          } else if (LO) {
            cells = F[0][r][c][e] + a[0] * (float)J[0][r][c][e];
          } else if (NLEV > 0) {
            cells = a[0] * (float)J[0][r][c][e];
#pragma unroll
            for (int l = 1; l < NA; ++l)
              cells = cells + a[l] * (float)J[l][r][c][e];
          } else {
            cells = F[0][r][c][e];
#pragma unroll
            for (int f = 1; f < NF; ++f) cells = cells + F[f][r][c][e];
          }
          acc[r][c][e] = c0 == 0 ? cells : acc[r][c][e] + cells;
        }
  }

  // Finalize (pallas_ld.py:526-560): distinct > 1 on both sides, the pair
  // algebra, then the strict upper triangle of true sites.
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (li[r] >= tile || lj[c] >= tile) continue;
      const int64_t gi = (int64_t)ti * tile + li[r];
      const int64_t gj = (int64_t)tj * tile + lj[c];
      bool keep = keep2[r][c];
      float d, dpr, r2v;
      pair_algebra(acc[r][c][0], acc[r][c][1], acc[r][c][2], acc[r][c][3],
                   keep, d, dpr, r2v);
      keep = keep && gi < gj && gj < p.n_sites;
      const int64_t o = (kt * tile + li[r]) * tile + lj[c];
      p.d[o] = d;
      p.dp[o] = dpr;
      p.r2[o] = r2v;
      p.keep[o] = keep ? 1 : 0;
    }
}

template <int NLEV, int NFLT, bool PRE, bool UNIT>
int launch(const Params& p, int k, cudaStream_t stream) {
  const int64_t blocks = (int64_t)k * p.blocks_per_side * p.blocks_per_side;
  ld_general_kernel<NLEV, NFLT, PRE, UNIT>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool PRE>
int dispatch(const Params& p, int k, int nlev, int nflt, cudaStream_t stream) {
  if (nflt == 0 && nlev == 2) return launch<2, 0, PRE, false>(p, k, stream);
  if (nflt == 0 && nlev == 3) return launch<3, 0, PRE, false>(p, k, stream);
  if (nlev == 0 && nflt == 1) return launch<0, 1, PRE, false>(p, k, stream);
  if (nlev == 0 && nflt == 2) return launch<0, 2, PRE, false>(p, k, stream);
  if (nlev == 1 && nflt == 1) return launch<1, 1, PRE, false>(p, k, stream);
  return (int)cudaErrorInvalidValue;
}

// Fills the Params shared by both entries; false when the arguments are
// outside what the kernel takes.
bool make_params(Params& p, const void* codes, const void* planes,
                 const void* q, const void* scale, const void* wf,
                 const void* tile_i, const void* tile_j, const void* emit,
                 void* d, void* dp, void* r2, void* keep, int tile,
                 int n_sites, int n_pad, int seq_chunk, int n_planes,
                 int packed_planes) {
  if (n_planes < 1 || n_planes > kPMax || (codes == nullptr) == (planes == nullptr))
    return false;
  if (tile <= 0 || seq_chunk <= 0 || seq_chunk % 4 || n_pad % seq_chunk)
    return false;
  p = Params{};
  p.codes = static_cast<const int8_t*>(codes);
  p.planes = static_cast<const int8_t*>(planes);
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.wf = static_cast<const float*>(wf);
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
  p.blocks_per_side = (tile + kBM - 1) / kBM;
  p.n_planes = n_planes;
  for (int s = 0; s < kPMax; ++s)
    p.plane_code[s] = s < n_planes ? (packed_planes >> (3 * s)) & 7 : 0;
  return true;
}

}  // namespace

// Entry for _ld_kernel: the weighted general kernel.  Exactly one of
// `codes` ([s_pad, n_pad] site-major codes) and `planes` ([grid*P*T, n_pad]
// one-hot planes of build_planes_tiled) is non-null.  `packed_planes`
// holds the P plane codes, 3 bits each (plane s at bits 3s..3s+2).  nlev
// int8 cascade levels (2 or 3, `q` and `scale`) or nflt f32 passes (1 or
// 2, `wf`), or lo_int8 (nlev = nflt = 1: w_hi in `wf`, the residual level
// in `q` and `scale`).  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int ld_general(const void* codes, const void* planes, const void* q,
                          const void* scale, const void* wf,
                          const void* tile_i, const void* tile_j,
                          const void* emit, void* d, void* dp, void* r2,
                          void* keep, int k, int tile, int n_sites, int s_pad,
                          int n_pad, int seq_chunk, int nlev, int nflt,
                          int n_planes, int packed_planes, void* stream) {
  (void)s_pad;
  Params p;
  if (!make_params(p, codes, planes, q, scale, wf, tile_i, tile_j, emit, d, dp,
                   r2, keep, tile, n_sites, n_pad, seq_chunk, n_planes,
                   packed_planes))
    return (int)cudaErrorInvalidValue;
  if (k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return planes != nullptr ? dispatch<true>(p, k, nlev, nflt, s)
                           : dispatch<false>(p, k, nlev, nflt, s);
}

// Entry for _ld_kernel_unit: unit weights, one int32 joint over all of N
// converted to f32 once (seq_chunk, q, scale, wf, nlev and nflt unused).
extern "C" int ld_general_unit(const void* codes, const void* planes,
                               const void* q, const void* scale,
                               const void* wf, const void* tile_i,
                               const void* tile_j, const void* emit, void* d,
                               void* dp, void* r2, void* keep, int k, int tile,
                               int n_sites, int s_pad, int n_pad,
                               int seq_chunk, int nlev, int nflt, int n_planes,
                               int packed_planes, void* stream) {
  (void)s_pad;
  (void)nlev;
  (void)nflt;
  Params p;
  if (!make_params(p, codes, planes, q, scale, wf, tile_i, tile_j, emit, d, dp,
                   r2, keep, tile, n_sites, n_pad, seq_chunk, n_planes,
                   packed_planes))
    return (int)cudaErrorInvalidValue;
  if (k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return planes != nullptr
             ? launch<1, 0, true, true>(p, k, s)
             : launch<1, 0, false, true>(p, k, s);
}
