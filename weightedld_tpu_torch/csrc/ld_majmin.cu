// Factorized major/dominant-minor weighted-LD tile kernel for Hopper (sm_90a).
//
// Replaces the two factorized Pallas TPU kernels of the JAX package:
//   * weightedld_tpu/ops/pallas_ld.py:_ld_kernel_mm (entry
//     pallas_tile_stats_majmin), which builds the per-site [maj; dmin]
//     indicator planes from the int8 codes and the per-site aux in-kernel;
//   * weightedld_tpu/ops/pallas_ld.py:_ld_kernel_mm_pre (entry
//     pallas_tile_stats_majmin_pre), which reads the planes and the
//     weight-scaled int8 cascade planes (xq) precomputed in device memory.
// Both share one body here, templated on the operand source (PRE), and the
// finalize algebra of pallas_ld.py:_pair_algebra.
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
// What bounds it on the H100.  At the main-path shape (N = 1,000 sequences,
// int8x3) each pair needs 4 cells x 3 levels x N/4 = 3,000 packed int8 dot
// products and each output is 13 bytes, so the kernel is bound by integer
// dot-product issue rate, not by memory: per pair it reads a few bytes of
// operands from shared memory for every dp4a it issues.
//
// What the design does about that.  Each CTA owns a 32 x 32 block of site
// pairs inside one tile pair (the TPU's 2T x 2T f32 accumulator, 1 MiB at
// T = 256, does not fit an SM).  The CTA stages 64 sequence columns of its
// 2 x 32 A-side rows (per cascade level) and 2 x 32 B-side rows in shared
// memory as packed 32-bit words, and each of its 256 threads keeps 2 x 2
// pairs x 4 cells x NLEV int32 joints in registers, issuing 16 __dp4a per
// level for every 8 shared-memory words it reads (operand reuse of 2 x 2).
// The sequence loop runs inside the CTA; a CTA loads its own tile indices
// and a tile pair with emit == 0 only zeroes its keep block.  Tensor-core
// (wgmma) int8 MMA and TMA staging are left for later work.
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
  int blocks_per_side;    // ceil(tile / 32)
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

// NLEV > 0: int8 passes (A operand = indicator * q_l); NFLT > 0: f32 passes
// (A operand = indicator, weights staged separately); both (LO, lo_int8):
// sA holds indicator * q and sI the indicator.  PRE selects the operand
// source: false = codes + aux (the _ld_kernel_mm build), true =
// precomputed planes / xq (the _ld_kernel_mm_pre inputs; under LO the
// planes and the q row, with planes * q built while staging, as JAX builds
// xq in-kernel for this mode: the same int8 bytes without a second
// [2*s_pad, n_pad] array in device memory).
template <int NLEV, int NFLT, bool PRE>
__global__ void __launch_bounds__(kThreads)
ld_majmin_kernel(const Params p) {
  constexpr int NA = NLEV > 0 ? NLEV : 1;
  constexpr int NF = NFLT > 0 ? NFLT : 1;
  constexpr bool LO = NLEV > 0 && NFLT > 0;
  __shared__ uint32_t sA[NA][2][kBM][kKWP];
  __shared__ uint32_t sI[LO ? 2 : 1][kBM][kKWP];
  __shared__ uint32_t sB[2][kBN][kKWP];
  // Float passes: per staged word and 4-bit byte mask, the f32 sum of the
  // selected weights of its four columns, added in column order.
  __shared__ float sT[NF][kKW][16];
  __shared__ int32_t sAuxA[kBM][2];
  __shared__ int32_t sAuxB[kBN][2];

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

  int32_t J[NA][2][2][4];
  float F[NF][2][2][4];
  float acc[2][2][4];
  const int64_t plane_level = (int64_t)2 * p.s_pad * p.n_pad;

  for (int c0 = 0; c0 < p.n_pad; c0 += p.seq_chunk) {
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
          if constexpr (LO) {
            // 0/1 plane bytes times 0xff are byte masks (no carries).
            const uint32_t pm =
                va ? ld_word(p.planes, ra * p.n_pad + col) : 0u;
            const uint32_t pd =
                va ? ld_word(p.planes, (ra + tile) * p.n_pad + col) : 0u;
            const uint32_t qw = va ? ld_word(p.xq, col) : 0u;
            sA[0][0][row][w] = (pm * 0xffu) & qw;
            sA[0][1][row][w] = (pd * 0xffu) & qw;
            sI[0][row][w] = pm;
            sI[1][row][w] = pd;
          } else if (NLEV > 0) {
#pragma unroll
            for (int l = 0; l < NA; ++l) {
              const int8_t* xl = p.xq + l * plane_level;
              sA[l][0][row][w] = va ? ld_word(xl, ra * p.n_pad + col) : 0u;
              sA[l][1][row][w] =
                  va ? ld_word(xl, (ra + tile) * p.n_pad + col) : 0u;
            }
          } else {
            sA[0][0][row][w] = va ? ld_word(p.planes, ra * p.n_pad + col) : 0u;
            sA[0][1][row][w] =
                va ? ld_word(p.planes, (ra + tile) * p.n_pad + col) : 0u;
          }
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
          if (NLEV > 0) {
#pragma unroll
            for (int l = 0; l < NA; ++l) {
              const uint32_t qw = va ? ld_word(p.q, (int64_t)l * p.n_pad + col)
                                     : 0u;
              sA[l][0][row][w] = ema & qw;  // one-hot * q_l fits int8
              sA[l][1][row][w] = eda & qw;
            }
            if constexpr (LO) {
              sI[0][row][w] = ema & 0x01010101u;
              sI[1][row][w] = eda & 0x01010101u;
            }
          } else {
            sA[0][0][row][w] = ema & 0x01010101u;
            sA[0][1][row][w] = eda & 0x01010101u;
          }
          sB[0][row][w] = emb & 0x01010101u;
          sB[1][row][w] = edb & 0x01010101u;
        }
      }
      if (NFLT > 0) {
        for (int s = tid; s < NF * kKW * 16; s += kThreads) {
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
      }
      __syncthreads();

      if (NLEV > 0) {
#pragma unroll 4
        for (int w = 0; w < kKW; ++w) {
          int bm[2], bd[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            bm[c] = (int)sB[0][tx + 16 * c][w];
            bd[c] = (int)sB[1][tx + 16 * c][w];
          }
#pragma unroll
          for (int l = 0; l < NA; ++l) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int am = (int)sA[l][0][ty + 16 * r][w];
              const int ad = (int)sA[l][1][ty + 16 * r][w];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                J[l][r][c][0] = __dp4a(am, bm[c], J[l][r][c][0]);
                J[l][r][c][1] = __dp4a(am, bd[c], J[l][r][c][1]);
                J[l][r][c][2] = __dp4a(ad, bm[c], J[l][r][c][2]);
                J[l][r][c][3] = __dp4a(ad, bd[c], J[l][r][c][3]);
              }
            }
          }
        }
      }
      if (NFLT > 0) {
        for (int w = 0; w < kKW; ++w) {
          uint32_t am[2], ad[2], bm[2], bd[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if constexpr (LO) {
              am[r] = sI[0][ty + 16 * r][w];
              ad[r] = sI[1][ty + 16 * r][w];
            } else {
              am[r] = sA[0][0][ty + 16 * r][w];
              ad[r] = sA[0][1][ty + 16 * r][w];
            }
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
              for (int f = 0; f < NF; ++f) {
                F[f][r][c][0] += sT[f][w][m0];
                F[f][r][c][1] += sT[f][w][m1];
                F[f][r][c][2] += sT[f][w][m2];
                F[f][r][c][3] += sT[f][w][m3];
              }
            }
        }
      }
    }

    // Combine once per seq chunk (pallas_ld.py:912-920, 926-930, 937-940).
    float a[NA];
#pragma unroll
    for (int l = 0; l < NA; ++l) a[l] = NLEV > 0 ? p.scale[l] : 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float cells;
          if (LO) {
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

  // Finalize (pallas_ld.py:946-969): per-site distinct > 1 on both sides,
  // the pair algebra, then the strict upper triangle of true sites.
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (li[r] >= tile || lj[c] >= tile) continue;
      const int64_t gi = (int64_t)ti * tile + li[r];
      const int64_t gj = (int64_t)tj * tile + lj[c];
      bool keep = p.auxc[gi * 3 + 2] > 1 && p.auxc[gj * 3 + 2] > 1;
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

template <int NLEV, int NFLT, bool PRE>
int launch(const Params& p, int k, cudaStream_t stream) {
  const int64_t blocks = (int64_t)k * p.blocks_per_side * p.blocks_per_side;
  ld_majmin_kernel<NLEV, NFLT, PRE>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool PRE>
int dispatch(const Params& p, int k, int nlev, int nflt, cudaStream_t stream) {
  if (k <= 0) return 0;
  if (nflt == 0 && nlev == 1) return launch<1, 0, PRE>(p, k, stream);
  if (nflt == 0 && nlev == 2) return launch<2, 0, PRE>(p, k, stream);
  if (nflt == 0 && nlev == 3) return launch<3, 0, PRE>(p, k, stream);
  if (nlev == 0 && nflt == 1) return launch<0, 1, PRE>(p, k, stream);
  if (nlev == 0 && nflt == 2) return launch<0, 2, PRE>(p, k, stream);
  if (nlev == 1 && nflt == 1) return launch<1, 1, PRE>(p, k, stream);
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
  p.blocks_per_side = (tile + kBM - 1) / kBM;
  return p;
}

}  // namespace

// Entry for _ld_kernel_mm: operands built from the codes and the aux.
// Returns cudaGetLastError() after the launch (0 = launched).
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
// (lo_int8, nlev = nflt = 1: xq is the [n_pad] int8 q row).
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
