// LD-decay distance bins over one batch of pair statistics, for Hopper.
//
// Replaces no Pallas kernel: the JAX package reduces a batch's bins with
// XLA (weightedld_tpu/parallel/sharded.py:make_decay_runner), which fuses
// the per-bin selects into one read of the batch's resident stats.  Eager
// PyTorch cannot fuse them: the plain version
// (weightedld_tpu_torch/parallel/analytics.py:decay_batch_plain) makes a
// [K, T, T] distance tensor, then two compares, three ands, two selects and
// four sums over [K, T, T] per bin.  This kernel is that fusion.
//
// What it computes.  For the K tile pairs of a batch (stats [K, T, T]: r2
// and D' float32, keep one byte) and the site positions sm_pad[S_pad], per
// distance bin b (edges[b] <= |pos_b - pos_a| < edges[b+1], integers):
// the kept-pair count, the r2 sum, the |D'| sum over the kept pairs whose
// D' is finite and that finite count, as [B, 4] float64.  Only kept slots
// count (padding slots hold NaN and keep == 0); a kept in-bin NaN r2 makes
// its bin's sum NaN, as torch.where(m, r2, 0).sum() does.
//
// What bounds it.  Memory: 9 bytes a pair slot (keep 1, r2 4, D' 4) read
// once, 10.9 GB a scan of the 49,152-site session cell (18,528 tile pairs
// of T = 256), 3.26 ms at 3.35 TB/s.  The positions are 8 bytes a row and
// column, served by L1 and L2.
//
// What the design does.  Each byte is read at most once a launch, with
// 16-byte loads (four floats a thread, four keep bytes as one word) marked
// streaming; the distance is computed in int32 registers from the
// positions, so no [K, T, T] distance, mask or select is ever stored.  A
// first small kernel (ld_decay_spans) takes each tile's smallest and
// largest position, so a tile pair whose distances all lie outside
// [edges[0], edges[B]) is skipped whole, without reading its keep bytes:
// short-range edges read only the tile pairs near the diagonal.  Inside a
// tile pair, a vector's r2 and D' are loaded only where one of its four
// slots is kept and lies in [edges[0], edges[B]): a slot outside every bin
// needs only its keep byte.  Blocks walk slabs of 512 vectors (a slab
// never crosses a tile pair) in a fixed grid-stride order, two vectors a
// thread in flight (four took 99 registers, half the blocks an SM and 1.5x
// the time).  The bins are a compile-time linear scan over at most 8
// edges, kernel parameters, with register accumulators; more bins run in
// chunks of 8, one launch of the same kernel each, and each chunk reads
// only the tile pairs and vectors inside its own edges, so across chunks
// every byte is still read about once.  A tile index outside [0, S_pad /
// T) stops the kernel with a device fault before any read of sm_pad.  Sums are float64 from the first add (counts are exact
// integers), and every cross-thread sum runs in a fixed order: a fixed
// shuffle tree in a warp, warps in order in a block, and the blocks'
// partials in a second kernel (ld_decay_merge), so a batch gives the same
// bits every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;                   // vectors in flight a thread
constexpr int kSlab = kThreads * kUnroll;    // vectors a block step
constexpr int kChunkBins = 8;                // bins a launch
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const uint8_t* keep;
  const float* r2;
  const float* dp;
  const int* sm_pad;
  const int* tile_i;
  const int* tile_j;
  const int2* span;   // [n_tiles]: each tile's smallest and largest position
  double* part;   // [grid, nb, 4]: count, r2 sum, |D'| sum, finite count
  int k;
  int tile;
  int n_tiles;    // S_pad / tile: the range of tile_i and tile_j
};

struct Edges {
  int e[kChunkBins + 1];
};

template <int V>
struct Vec;

template <>
struct Vec<4> {
  static __device__ __forceinline__ void keep(const uint8_t* p,
                                              bool (&out)[4]) {
    const unsigned w = __ldcs(reinterpret_cast<const unsigned*>(p));
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = ((w >> (8 * j)) & 0xffu) != 0u;
  }
  static __device__ __forceinline__ void vals(const float* p,
                                              float (&out)[4]) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  static __device__ __forceinline__ void pos(const int* p, int (&out)[4]) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec<1> {
  static __device__ __forceinline__ void keep(const uint8_t* p,
                                              bool (&out)[1]) {
    out[0] = __ldcs(p) != 0;
  }
  static __device__ __forceinline__ void vals(const float* p,
                                              float (&out)[1]) {
    out[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void pos(const int* p, int (&out)[1]) {
    out[0] = __ldg(p);
  }
};

__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) <= 3.402823466e38f;        // false for NaN and +-inf
}

// Whether tile pair k may hold a distance in [lo, hi): its distances lie in
// [dmin, dmax], from the two tiles' spans.  A tile index out of range
// stops the kernel before sm_pad is read.
__device__ __forceinline__ bool pair_in(const Args& a, int k, int lo, int hi) {
  const int ti = __ldg(a.tile_i + k), tj = __ldg(a.tile_j + k);
  if (static_cast<unsigned>(ti) >= static_cast<unsigned>(a.n_tiles) ||
      static_cast<unsigned>(tj) >= static_cast<unsigned>(a.n_tiles))
    __trap();
  const int2 sa = a.span[ti], sb = a.span[tj];
  const long long dmin = max(0LL, max(static_cast<long long>(sb.x) - sa.y,
                                      static_cast<long long>(sa.x) - sb.y));
  const long long dmax = max(static_cast<long long>(sb.y) - sa.x,
                             static_cast<long long>(sa.y) - sb.x);
  return dmax >= lo && dmin < hi;
}

// Every slot of the batch whose tile pair may hold a distance in [lo, hi),
// handed to f(in, d, r, p) one at a time: in (kept and lo <= d < hi), the
// distance d, r2 r and D' p (zero where no slot of its 4-slot vector is
// in: those bytes are not read).  A block takes the units (slabs) u =
// blockIdx.x, + gridDim.x, ... in order; the threads first test the
// block's next kThreads units at once and list those whose tile pair may
// hold a distance in range, so that skipping a unit costs no serial
// round trip to memory.
template <int V, class F>
__device__ __forceinline__ void walk(const Args& a, int lo, int hi, F&& f) {
  __shared__ int units[kThreads];
  __shared__ int warp_n[kWarps];
  const int t = a.tile;
  const int qrow = t / V;                    // vectors a row
  const int nvec = t * qrow;                 // vectors a tile pair
  const int nslab = (nvec + kSlab - 1) / kSlab;
  const long long n_units = static_cast<long long>(a.k) * nslab;
  const size_t tt = static_cast<size_t>(t) * t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r0 = blockIdx.x; r0 < n_units; r0 += stride) {
    const long long uc = r0 + static_cast<long long>(threadIdx.x) * gridDim.x;
    const bool act = uc < n_units &&
                     pair_in(a, static_cast<int>(uc / nslab), lo, hi);
    const unsigned m = __ballot_sync(kFull, act);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int at = 0, n_act = 0;
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? warp_n[w] : 0;
      n_act += warp_n[w];
    }
    if (act) units[at + __popc(m & ((1u << lane) - 1u))] = static_cast<int>(uc);
    __syncthreads();
    for (int q = 0; q < n_act; ++q) {
      const int u = units[q];
      const int k = u / nslab;
      const int v0 = (u - k * nslab) * kSlab + static_cast<int>(threadIdx.x);
      const size_t base = static_cast<size_t>(k) * tt;
      const int ti = __ldg(a.tile_i + k), tj = __ldg(a.tile_j + k);
      const int* pa_t = a.sm_pad + static_cast<size_t>(ti) * t;
      const int* pb_t = a.sm_pad + static_cast<size_t>(tj) * t;
      bool in[kUnroll][V];
      int d[kUnroll][V];
      bool any[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        const int v = v0 + i * kThreads;
        any[i] = false;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          in[i][j] = false;
          d[i][j] = 0;
        }
        if (v < nvec) {
          const int row = v / qrow;
          const int col = (v - row * qrow) * V;
          bool kp[V];
          int pb[V];
          Vec<V>::keep(a.keep + base + static_cast<size_t>(v) * V, kp);
          Vec<V>::pos(pb_t + col, pb);
          const int pa = __ldg(pa_t + row);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            d[i][j] = abs(pb[j] - pa);
            in[i][j] = kp[j] && d[i][j] >= lo && d[i][j] < hi;
            any[i] = any[i] || in[i][j];
          }
        }
      }
      float r[kUnroll][V];
      float p[kUnroll][V];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        if (any[i]) {
          const size_t off = base + static_cast<size_t>(v0 + i * kThreads) * V;
          Vec<V>::vals(a.r2 + off, r[i]);
          Vec<V>::vals(a.dp + off, p[i]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) r[i][j] = p[i][j] = 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
#pragma unroll
        for (int j = 0; j < V; ++j) f(in[i][j], d[i][j], r[i][j], p[i][j]);
      }
    }
    __syncthreads();                         // units[] is rewritten next
  }
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  return x;
}

// NB <= kChunkBins bins known at compile time, per-thread accumulators in
// registers.
template <int NB, int V>
__global__ void __launch_bounds__(kThreads)
    ld_decay_bins_regs(const Args a, const Edges ed) {
  __shared__ double red[kWarps][NB * 4];
  unsigned cnt[NB], fin[NB];
  double sr[NB], sp[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    cnt[b] = fin[b] = 0u;
    sr[b] = sp[b] = 0.0;
  }
  walk<V>(a, ed.e[0], ed.e[NB], [&](bool in, int d, float r, float p) {
    if (!in) return;
    const bool ok = finite(p);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (d >= ed.e[b] && d < ed.e[b + 1]) {
        cnt[b] += 1u;
        sr[b] += static_cast<double>(r);
        if (ok) {
          fin[b] += 1u;
          sp[b] += static_cast<double>(fabsf(p));
        }
      }
    }
  });
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const double q[4] = {static_cast<double>(cnt[b]), sr[b], sp[b],
                         static_cast<double>(fin[b])};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const double s = warp_sum(q[c]);
      if (lane == 0) red[warp][b * 4 + c] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < NB * 4) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    a.part[static_cast<size_t>(blockIdx.x) * NB * 4 + threadIdx.x] = s;
  }
}

// span[t] = (smallest, largest) of sm_pad[t * tile, (t + 1) * tile), one
// warp a tile.
__global__ void __launch_bounds__(kThreads)
    ld_decay_spans(const int* sm_pad, int n_tiles, int tile, int2* span) {
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= n_tiles) return;                   // whole warps leave together
  const int* p = sm_pad + static_cast<size_t>(t) * tile;
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
  for (int i = lane; i < tile; i += 32) {
    const int x = __ldg(p + i);
    lo = min(lo, x);
    hi = max(hi, x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_down_sync(kFull, lo, off));
    hi = max(hi, __shfl_down_sync(kFull, hi, off));
  }
  if (lane == 0) span[t] = make_int2(lo, hi);
}

// out[c] = sum over the grid's blocks g, in a fixed order, of
// part[g, c], one warp per column c: lane l sums g = l, l + 32, ... in
// order, then a fixed shuffle tree.
__global__ void __launch_bounds__(kThreads)
    ld_decay_merge(const double* part, int grid, int width, double* out) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= width) return;                     // whole warps leave together
  double s = 0.0;
  for (int g = lane; g < grid; g += 32) s += part[static_cast<size_t>(g) * width + c];
  s = warp_sum(s);
  if (lane == 0) out[c] = s;
}

// Launch `kern` on as many blocks as fit the card at once, at most
// max_grid and the batch's n_units slabs; *grid gets the count.
template <class Kern>
cudaError_t launch(Kern kern, const Args& a, const Edges& ed, int n_units,
                   int max_grid, cudaStream_t stream, int* grid) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                       0);
  if (rc != cudaSuccess) return rc;
  int g = per_sm * nsm;
  if (g > max_grid) g = max_grid;
  if (g > n_units) g = n_units;
  if (g < 1) g = 1;
  kern<<<g, kThreads, 0, stream>>>(a, ed);
  *grid = g;
  return cudaGetLastError();
}

template <int V>
cudaError_t run_chunk(const Args& a, const Edges& ed, int nb, int n_units,
                      int max_grid, cudaStream_t s, int* grid) {
  switch (nb) {
    case 1: return launch(ld_decay_bins_regs<1, V>, a, ed, n_units, max_grid, s, grid);
    case 2: return launch(ld_decay_bins_regs<2, V>, a, ed, n_units, max_grid, s, grid);
    case 3: return launch(ld_decay_bins_regs<3, V>, a, ed, n_units, max_grid, s, grid);
    case 4: return launch(ld_decay_bins_regs<4, V>, a, ed, n_units, max_grid, s, grid);
    case 5: return launch(ld_decay_bins_regs<5, V>, a, ed, n_units, max_grid, s, grid);
    case 6: return launch(ld_decay_bins_regs<6, V>, a, ed, n_units, max_grid, s, grid);
    case 7: return launch(ld_decay_bins_regs<7, V>, a, ed, n_units, max_grid, s, grid);
    case 8: return launch(ld_decay_bins_regs<8, V>, a, ed, n_units, max_grid, s, grid);
    default: return cudaErrorInvalidValue;
  }
}
static_assert(kChunkBins == 8, "run_chunk instantiates 1..kChunkBins");

}  // namespace

// The [n_bins, 4] float64 bins of one batch into out (see the top of the
// file), in ceil(n_bins / 8) launches of the bins kernel; span is int32
// scratch of n_tiles * 2 (8-byte aligned), part float64 scratch of
// max_grid * min(n_bins, 8) * 4, edges a host array of n_bins + 1
// ascending int32, n_tiles the tiles of sm_pad, vec 4 (tile % 4 == 0,
// r2 / dp / sm_pad 16-byte and keep 4-byte aligned) or 1.  Returns the
// first CUDA error, or cudaErrorInvalidValue for arguments out of range.
extern "C" int ld_decay_bins(const void* keep, const void* r2, const void* dp,
                             const void* sm_pad, const void* tile_i,
                             const void* tile_j, const void* edges, void* span,
                             void* part, void* out, int k, int tile, int n_tiles,
                             int n_bins, int max_grid, int vec, void* stream) {
  if (k <= 0 || tile <= 0 || n_tiles <= 0 || n_bins <= 0 || max_grid <= 0 ||
      (vec != 1 && vec != 4) || tile % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nvec = static_cast<long long>(tile) * (tile / vec);
  const long long nslab = (nvec + kSlab - 1) / kSlab;
  if (nvec > 0x7fffffffLL || k * nslab > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint8_t*>(keep),
               static_cast<const float*>(r2),
               static_cast<const float*>(dp),
               static_cast<const int*>(sm_pad),
               static_cast<const int*>(tile_i),
               static_cast<const int*>(tile_j),
               static_cast<const int2*>(span),
               static_cast<double*>(part), k, tile, n_tiles};
  const int* e = static_cast<const int*>(edges);
  double* o = static_cast<double*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_units = static_cast<int>(k * nslab);
  ld_decay_spans<<<(n_tiles + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      a.sm_pad, n_tiles, tile, static_cast<int2*>(span));
  cudaError_t rc0 = cudaGetLastError();
  if (rc0 != cudaSuccess) return static_cast<int>(rc0);
  for (int c0 = 0; c0 < n_bins; c0 += kChunkBins) {
    const int nb = n_bins - c0 < kChunkBins ? n_bins - c0 : kChunkBins;
    Edges ed{};
    for (int b = 0; b <= nb; ++b) ed.e[b] = e[c0 + b];
    int grid = 0;
    cudaError_t rc = vec == 4 ? run_chunk<4>(a, ed, nb, n_units, max_grid, s, &grid)
                              : run_chunk<1>(a, ed, nb, n_units, max_grid, s, &grid);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const int width = nb * 4;
    ld_decay_merge<<<(width + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        a.part, grid, width, o + static_cast<size_t>(c0) * 4);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}
