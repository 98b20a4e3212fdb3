// Product-Epanechnikov photon splat for NVIDIA Hopper (sm_90a).
//
// Replaces cpm_tpu/pallas/splat_mxu.py:_splat_kernel (launched by
// splat_product_pallas). Both compute
//
//   light[z, y, x, c] = sum_p Kz[p, z] * Ky[p, y] * Kx[p, x] * P[p, c],
//   K(d) = max(0.75 * (1 - d^2), 0),  d = (centre - p) / r,
//
// with voxel centres at (i + 0.5) / n and powers P that already carry the
// irradiance scale and the validity mask (either sign).
//
// The TPU kernel runs the sum as a dense matrix product because a TPU has
// no float atomics. With r * n ~ 1 a deposit reaches 2 or 3 voxel centres
// per axis, so only ~2e-4 of the dense terms are nonzero; on a GPU the sum
// is a scatter.
//
// What bounds it: bytes. Each deposit is 24 B in, the grid 12 B a cell out,
// and the arithmetic (~8 nonzero cells x 3 channels a deposit) is far
// below the card's fp32 rate. Against 3.35 TB/s the least time is 2.9 us
// for 262,144 deposits into 65^3 (6.29 MB + 3.30 MB) and 0.121 ms for
// 16,777,216 deposits into 65^3 (402.7 MB + 3.3 MB). What a scatter pays
// above that is atomic traffic, ~24 float atomics a deposit; PERF.md has
// the measured times of both designs beside these bounds.
//
// Two designs, chosen by the wrapper from the deposits per output cell
// (kernels/splat_product.py: choose_design):
//
// direct  One thread per deposit adds its nonzero terms to the grid with
//         global atomics (fire-and-forget reductions in L2). One launch.
//         Its time follows the number of atomics, whatever their
//         addresses: L2 takes so many float reductions a second and no
//         more, ~340 of them per output float at 16.8 M deposits.
//
// tiled   Combine on the SM, touch L2 once per tile cell:
//         1. bin_count: deposits per output brick (8^3 cells), a
//            shared-memory histogram per block, one global atomic per
//            brick and block;
//         2. bin_scan: one block scans the counts into segment offsets and
//            cuts every non-empty brick into work items of at most `seg`
//            deposits, so a dense brick is shared between blocks and an
//            empty one costs nothing;
//         3. bin_fill: a counting sort; each live deposit's index goes to
//            its brick's segment (unused slots are dropped here);
//         4. splat_tiled: one block per work item zeroes a shared-memory
//            tile of the brick plus the halo a support can reach
//            ((8 + 2 * halo)^3 x 3 floats), reads its segment of indices
//            with coalesced loads, gathers each deposit, adds every term
//            with shared-memory atomics, and adds the tile's nonzero
//            floats to the grid once.
//         Shared-memory float atomics are compare-and-swap loops on this
//         card (ATOMS.CAST.SPIN), so the tile pass is bound by the SM's
//         load/store unit, not by L2. The binning's time follows the
//         slots, used or not; the direct design's follows the used ones.
//         On a traced frame's deposits (15-18% of the slots used) the
//         tiled design wins from ~30 slots a cell (0.69 against 1.01 ms at
//         61); at one a cell its four launches cost three times the
//         atomics they save.
//
// Both designs compute each axis weight once per deposit and axis, rounded
// step by step as the plain version rounds it (the _rn intrinsics keep nvcc
// from fusing 1 - d * d into one multiply-add): near the edge of the
// support 1 - d^2 cancels most of its digits, and a different rounding
// there moves a weight by ~1e-5 of its peak. Summation order varies
// between runs (atomics), so results match the plain version to rounding,
// not bit for bit.
//
// The splat's backward (splat_grad_kernel) is its transpose: the gradient
// of a deposit's power is the kernel-weighted sum of the grid's gradient
// over the same window,
//
//   dP[p, c] = sum_{z,y,x} Kz[p, z] * Ky[p, y] * Kx[p, x] * G[z, y, x, c],
//
// with the same weights, the floats axis_weight computes. The Pallas
// kernel has no backward (the reference differentiates an XLA splat), so
// this one is new. It is a gather: one thread per slot reads the nonzero
// cells of its window from G (3.3 MB at 65^3, held in L2; mostly 8 of
// them at the default frame's r * n = 1.0001) and writes its 12 bytes
// once, with no atomics. What bounds it is bytes: 12 B of position read
// and 12 B of gradient written a slot, and G read once, 9.6 MB or 2.9 us
// at 262,144 slots into 65^3. A live slot's weights cost it most of its
// instructions when each takes an IEEE division for its cell centre (15
// at W = 5), so a block divides the d + h + w centres once into shared
// memory, and as many blocks as the card keeps resident stride over the
// slots, so that each block's division serves many slots. On an H100 it is
// faster on the frame-sized lists and slower on the large frame's 16.8 M
// slots than one division a weight; other designs (block compaction of the
// live slots, their rows spread over lanes, windows trimmed to their
// nonzero cells, a table in global memory or one a slot tile) were slower
// on the driven list or on most lists (PERF.md §6). An unused slot (x >=
// 1e30 or NaN, float16's +inf included) writes 0 without reaching a
// weight: an infinite position would make NaN there, and 0 * NaN stays NaN
// after the powers' validity mask.
//
// The brick of a deposit and the cells it reaches both derive from integer
// cell indices: brick = clamp(floor(p * n), 0, n - 1) / 8 per axis, and a
// window never leaves [cell - halo, cell + halo] for
// halo = ceil(r * n + 0.51), so every term lands inside its brick's tile.
// kernels/splat_product.py holds the same geometry in Python.

#include <cuda_runtime.h>

namespace {

constexpr int kBrick = 8;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ float epan(float d) {
  return fmaxf(__fmul_rn(0.75f, __fsub_rn(1.0f, __fmul_rn(d, d))), 0.0f);
}

// Weight of cell i of an n-cell axis for a deposit at p:
// K(((i + 0.5) / n - p) / r), as splat_mxu.py:_splat_kernel computes it.
__device__ __forceinline__ float axis_weight(int i, int n, float p,
                                             float inv_r) {
  float c = __fdiv_rn((float)i + 0.5f, (float)n);
  return epan(__fmul_rn(__fsub_rn(c, p), inv_r));
}

// Inclusive cell window [lo, hi] of the deposit's support along one axis,
// clamped to [0, n - 1]; false when it is empty. It holds every cell whose
// centre lies inside the support and at most two more.
__device__ __forceinline__ bool axis_window(float p, float r, int n,
                                            int* lo, int* hi) {
  float a = fmaxf(floorf((p - r) * n - 0.5f), 0.0f);
  float b = fminf(ceilf((p + r) * n - 0.5f), (float)(n - 1));
  if (!(a <= b)) return false;
  *lo = (int)a;
  *hi = (int)b;
  return true;
}

// The cell that holds p: clamp(floor(p * n), 0, n - 1).
__device__ __forceinline__ int axis_cell(float p, int n) {
  float c = floorf(__fmul_rn(p, (float)n));
  return (int)fminf(fmaxf(c, 0.0f), (float)(n - 1));
}

struct Dims {
  int d, h, w;        // cells
  int nbz, nby, nbx;  // bricks
};

// Brick key of a deposit, or -1 for an unused slot (FLT_MAX sentinel).
__device__ __forceinline__ int brick_key(const float* __restrict__ pos,
                                         size_t i, Dims g) {
  float px = pos[3 * i];
  if (!(px < 1e30f)) return -1;
  int bx = axis_cell(px, g.w) / kBrick;
  int by = axis_cell(pos[3 * i + 1], g.h) / kBrick;
  int bz = axis_cell(pos[3 * i + 2], g.d) / kBrick;
  return (bz * g.nby + by) * g.nbx + bx;
}

// Adds to the grid in global memory.
struct GridSink {
  float* out;
  int h, w;
  __device__ __forceinline__ float* row(int z, int y) const {
    return out + ((size_t)z * h + y) * w * 3;
  }
};

// Adds to a brick's tile in shared memory; (oz, oy, ox) is the tile's
// first cell, t its cells per axis.
struct TileSink {
  float* tile;
  int oz, oy, ox, t;
  __device__ __forceinline__ float* row(int z, int y) const {
    return tile + (((z - oz) * t + (y - oy)) * t - ox) * 3;
  }
};

__device__ __forceinline__ void add_cell(float* cell, float v0, float v1,
                                         float v2) {
  atomicAdd(cell + 0, v0);
  atomicAdd(cell + 1, v1);
  atomicAdd(cell + 2, v2);
}

// Adds one deposit's nonzero terms to the sink. W > 0: the windows hold at
// most W cells per axis and every weight is computed once, into registers
// (the loops unroll). W == 0: any window; the y and x weights are
// recomputed inside the loops.
template <int W, class Sink>
__device__ __forceinline__ void add_deposit(float px, float py, float pz,
                                            float p0, float p1, float p2,
                                            int x0, int x1, int y0, int y1,
                                            int z0, int z1, float inv_r,
                                            int d, int h, int w,
                                            const Sink& sink) {
  if constexpr (W > 0) {
    float kx[W], ky[W], kz[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      kx[j] = x0 + j <= x1 ? axis_weight(x0 + j, w, px, inv_r) : 0.0f;
      ky[j] = y0 + j <= y1 ? axis_weight(y0 + j, h, py, inv_r) : 0.0f;
      kz[j] = z0 + j <= z1 ? axis_weight(z0 + j, d, pz, inv_r) : 0.0f;
    }
#pragma unroll
    for (int jz = 0; jz < W; ++jz) {
      if (kz[jz] == 0.0f) continue;
#pragma unroll
      for (int jy = 0; jy < W; ++jy) {
        float a = kz[jz] * ky[jy];
        if (a == 0.0f) continue;
        float* row = sink.row(z0 + jz, y0 + jy) + 3 * x0;
#pragma unroll
        for (int jx = 0; jx < W; ++jx) {
          float k = kx[jx];
          if (k == 0.0f) continue;
          add_cell(row + 3 * jx, a * (k * p0), a * (k * p1), a * (k * p2));
        }
      }
    }
  } else {
    for (int z = z0; z <= z1; ++z) {
      float kz = axis_weight(z, d, pz, inv_r);
      if (kz == 0.0f) continue;
      for (int y = y0; y <= y1; ++y) {
        float a = kz * axis_weight(y, h, py, inv_r);
        if (a == 0.0f) continue;
        float* row = sink.row(z, y);
        for (int x = x0; x <= x1; ++x) {
          float k = axis_weight(x, w, px, inv_r);
          if (k == 0.0f) continue;
          add_cell(row + 3 * x, a * (k * p0), a * (k * p1), a * (k * p2));
        }
      }
    }
  }
}

// axis_weight of cell i of an axis whose cell centres are c: the same
// float, with the centre read and not divided.
__device__ __forceinline__ float centre_weight(const float* c, int i,
                                               float p, float inv_r) {
  return epan(__fmul_rn(__fsub_rn(c[i], p), inv_r));
}

// Adds one deposit's kernel-weighted sum of the grid gradient g over its
// window to acc, the transpose of add_deposit<W> (same weights, same
// skipped zeros); c holds the cell centres of z, then y, then x.
template <int W>
__device__ __forceinline__ void gather_deposit(float px, float py, float pz,
                                               int x0, int x1, int y0, int y1,
                                               int z0, int z1, float inv_r,
                                               int d, int h, int w,
                                               const float* __restrict__ g,
                                               const float* c,
                                               float (&acc)[3]) {
  auto row = [&](int z, int y) { return g + ((size_t)z * h + y) * w * 3; };
  const float *cz = c, *cy = c + d, *cx = c + d + h;
  if constexpr (W > 0) {
    float kx[W], ky[W], kz[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      kx[j] = x0 + j <= x1 ? centre_weight(cx, x0 + j, px, inv_r) : 0.0f;
      ky[j] = y0 + j <= y1 ? centre_weight(cy, y0 + j, py, inv_r) : 0.0f;
      kz[j] = z0 + j <= z1 ? centre_weight(cz, z0 + j, pz, inv_r) : 0.0f;
    }
#pragma unroll
    for (int jz = 0; jz < W; ++jz) {
      if (kz[jz] == 0.0f) continue;
#pragma unroll
      for (int jy = 0; jy < W; ++jy) {
        float a = kz[jz] * ky[jy];
        if (a == 0.0f) continue;
        const float* r = row(z0 + jz, y0 + jy) + 3 * x0;
#pragma unroll
        for (int jx = 0; jx < W; ++jx) {
          float k = kx[jx];
          if (k == 0.0f) continue;
          float wgt = a * k;
          acc[0] += wgt * r[3 * jx];
          acc[1] += wgt * r[3 * jx + 1];
          acc[2] += wgt * r[3 * jx + 2];
        }
      }
    }
  } else {
    for (int z = z0; z <= z1; ++z) {
      float kz = centre_weight(cz, z, pz, inv_r);
      if (kz == 0.0f) continue;
      for (int y = y0; y <= y1; ++y) {
        float a = kz * centre_weight(cy, y, py, inv_r);
        if (a == 0.0f) continue;
        const float* r = row(z, y);
        for (int x = x0; x <= x1; ++x) {
          float k = centre_weight(cx, x, px, inv_r);
          if (k == 0.0f) continue;
          float wgt = a * k;
          acc[0] += wgt * r[3 * x];
          acc[1] += wgt * r[3 * x + 1];
          acc[2] += wgt * r[3 * x + 2];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- direct

template <int W>
__global__ void splat_direct_kernel(const float* __restrict__ pos,
                                    const float* __restrict__ pw, int m,
                                    float r, float inv_r, int d, int h,
                                    int w, float* __restrict__ out) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)m) return;
  float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
  if (!(px < 1e30f)) return;  // unused slot (FLT_MAX sentinel)
  int x0, x1, y0, y1, z0, z1;
  if (!axis_window(px, r, w, &x0, &x1) || !axis_window(py, r, h, &y0, &y1) ||
      !axis_window(pz, r, d, &z0, &z1))
    return;
  add_deposit<W>(px, py, pz, pw[3 * i], pw[3 * i + 1], pw[3 * i + 2], x0, x1,
                 y0, y1, z0, z1, inv_r, d, h, w, GridSink{out, h, w});
}

// -------------------------------------------------------------- backward

// dpw[i] = the splat's transpose applied to g at slot i; one thread per
// slot, the blocks striding over the slots, every slot written (0 for an
// unused one). A block first divides the d + h + w cell centres into its
// shared memory (z, then y, then x), the floats axis_weight divides.
template <int W>
__global__ void splat_grad_kernel(const float* __restrict__ pos,
                                  const float* __restrict__ g, int m, float r,
                                  float inv_r, int d, int h, int w,
                                  float* __restrict__ dpw) {
  extern __shared__ float centres[];
  for (int t = threadIdx.x; t < d + h + w; t += blockDim.x) {
    const int n = t < d ? d : t < d + h ? h : w;
    const int j = t < d ? t : t < d + h ? t - d : t - d - h;
    centres[t] = __fdiv_rn((float)j + 0.5f, (float)n);
  }
  __syncthreads();
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < (size_t)m; i += (size_t)gridDim.x * blockDim.x) {
    float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
    float acc[3] = {0.0f, 0.0f, 0.0f};
    int x0, x1, y0, y1, z0, z1;
    if (px < 1e30f && axis_window(px, r, w, &x0, &x1) &&
        axis_window(py, r, h, &y0, &y1) && axis_window(pz, r, d, &z0, &z1))
      gather_deposit<W>(px, py, pz, x0, x1, y0, y1, z0, z1, inv_r, d, h, w,
                        g, centres, acc);
    dpw[3 * i] = acc[0];
    dpw[3 * i + 1] = acc[1];
    dpw[3 * i + 2] = acc[2];
  }
}

// --------------------------------------------------------------- binning

// Adds one to hist[key] for every lane with key >= 0 and returns the
// lane's rank among the deposits of its key counted so far in this block.
// Lanes of one warp with the same key share one shared-memory atomic.
// All 32 lanes of the warp must call it.
__device__ __forceinline__ int hist_add(int* hist, int key) {
  unsigned peers = __match_any_sync(0xffffffffu, key);
  int lane = threadIdx.x & 31;
  int leader = __ffs(peers) - 1;
  int base = 0;
  if (key >= 0 && lane == leader) base = atomicAdd(&hist[key], __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// Block b takes deposits [b * chunk, (b + 1) * chunk). chunk is a multiple
// of the block's threads, so a warp's lanes loop together.
__global__ void bin_count_kernel(const float* __restrict__ pos, int m,
                                 int chunk, Dims g, int nb,
                                 int* __restrict__ counts) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < nb; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  size_t lo = (size_t)blockIdx.x * chunk;
  for (int k = 0; k < chunk; k += blockDim.x) {
    size_t i = lo + k + threadIdx.x;
    hist_add(hist, i < (size_t)m ? brick_key(pos, i, g) : -1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    if (hist[b] != 0) atomicAdd(&counts[b], hist[b]);
}

// One block. offsets[b] = deposits in bricks before b (offsets[nb] = all
// live deposits); every non-empty brick is cut into work items
// (brick, first, end) of at most seg deposits; *n_items counts them.
__global__ void bin_scan_kernel(const int* __restrict__ counts, int nb,
                                int seg, int* __restrict__ offsets,
                                int* __restrict__ n_items,
                                int* __restrict__ work) {
  __shared__ int s_dep[kScanThreads];
  __shared__ int s_item[kScanThreads];
  int t = threadIdx.x;
  int per = (nb + kScanThreads - 1) / kScanThreads;
  int b0 = min(t * per, nb), b1 = min(b0 + per, nb);
  int dep = 0, item = 0;
  for (int b = b0; b < b1; ++b) {
    dep += counts[b];
    item += (counts[b] + seg - 1) / seg;
  }
  s_dep[t] = dep;
  s_item[t] = item;
  __syncthreads();
  for (int step = 1; step < kScanThreads; step <<= 1) {
    int a = t >= step ? s_dep[t - step] : 0;
    int c = t >= step ? s_item[t - step] : 0;
    __syncthreads();
    s_dep[t] += a;
    s_item[t] += c;
    __syncthreads();
  }
  dep = s_dep[t] - dep;  // exclusive
  item = s_item[t] - item;
  for (int b = b0; b < b1; ++b) {
    int c = counts[b];
    offsets[b] = dep;
    for (int first = dep; first < dep + c; first += seg) {
      work[3 * item + 0] = b;
      work[3 * item + 1] = first;
      work[3 * item + 2] = min(first + seg, dep + c);
      ++item;
    }
    dep += c;
  }
  if (t == kScanThreads - 1) {
    offsets[nb] = s_dep[t];
    *n_items = s_item[t];
  }
}

// Counting sort, second pass: the block counts its chunk again, reserves a
// range in every brick's segment with one global atomic, and writes each
// live deposit's index to its place. (Indices, not the deposits' 24 bytes:
// the index list of 16.8 M deposits stays in the 50 MB L2 while its sectors
// fill up; scattered 24-byte copies do not, and this pass then takes
// several times as long.)
__global__ void bin_fill_kernel(const float* __restrict__ pos, int m,
                                int chunk, Dims g, int nb,
                                const int* __restrict__ offsets,
                                int* __restrict__ cursor,
                                int* __restrict__ order) {
  extern __shared__ int sm[];
  int* cnt = sm;
  int* base = sm + nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) cnt[b] = 0;
  __syncthreads();
  size_t lo = (size_t)blockIdx.x * chunk;
  for (int k = 0; k < chunk; k += blockDim.x) {
    size_t i = lo + k + threadIdx.x;
    hist_add(cnt, i < (size_t)m ? brick_key(pos, i, g) : -1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int c = cnt[b];
    if (c != 0) base[b] = offsets[b] + atomicAdd(&cursor[b], c);
    cnt[b] = 0;
  }
  __syncthreads();
  for (int k = 0; k < chunk; k += blockDim.x) {
    size_t i = lo + k + threadIdx.x;
    int key = i < (size_t)m ? brick_key(pos, i, g) : -1;
    int rank = hist_add(cnt, key);
    if (key >= 0) order[base[key] + rank] = (int)i;
  }
}

// ----------------------------------------------------------------- tiled

__device__ __forceinline__ void load_deposit(const float* __restrict__ pos,
                                             const float* __restrict__ pw,
                                             size_t p, float (&v)[6]) {
  v[0] = pos[3 * p], v[1] = pos[3 * p + 1], v[2] = pos[3 * p + 2];
  v[3] = pw[3 * p], v[4] = pw[3 * p + 1], v[5] = pw[3 * p + 2];
}

// One block per work item (brick, first, end) of the sorted index list.
template <int W>
__global__ void splat_tiled_kernel(const float* __restrict__ pos,
                                   const float* __restrict__ pw,
                                   const int* __restrict__ order,
                                   const int* __restrict__ work,
                                   const int* __restrict__ n_items, float r,
                                   float inv_r, Dims g, int halo,
                                   float* __restrict__ out) {
  if ((int)blockIdx.x >= *n_items) return;
  extern __shared__ float tile[];
  const int t = kBrick + 2 * halo;
  const int row_floats = t * 3;
  const int tile_floats = t * t * row_floats;
  int brick = work[3 * blockIdx.x];
  int first = work[3 * blockIdx.x + 1], end = work[3 * blockIdx.x + 2];
  int bx = brick % g.nbx, by = (brick / g.nbx) % g.nby;
  int bz = brick / (g.nbx * g.nby);
  int ox = bx * kBrick - halo, oy = by * kBrick - halo;
  int oz = bz * kBrick - halo;

  for (int i = threadIdx.x; i < tile_floats; i += blockDim.x) tile[i] = 0.0f;
  __syncthreads();

  TileSink sink{tile, oz, oy, ox, t};
  // The gather of the next deposit is in flight while this one is added.
  float nx[6];
  int i = first + threadIdx.x;
  if (i < end) load_deposit(pos, pw, order[i], nx);
  for (; i < end; i += blockDim.x) {
    float px = nx[0], py = nx[1], pz = nx[2];
    float p0 = nx[3], p1 = nx[4], p2 = nx[5];
    if (i + (int)blockDim.x < end)
      load_deposit(pos, pw, order[i + blockDim.x], nx);
    int x0, x1, y0, y1, z0, z1;
    if (!axis_window(px, r, g.w, &x0, &x1) ||
        !axis_window(py, r, g.h, &y0, &y1) ||
        !axis_window(pz, r, g.d, &z0, &z1))
      continue;
    // No window leaves its brick's tile (see the note at the top); the
    // clamps only keep a fault in that argument from writing outside it.
    x0 = max(x0, ox), x1 = min(x1, ox + t - 1);
    y0 = max(y0, oy), y1 = min(y1, oy + t - 1);
    z0 = max(z0, oz), z1 = min(z1, oz + t - 1);
    add_deposit<W>(px, py, pz, p0, p1, p2, x0, x1, y0, y1, z0, z1, inv_r,
                   g.d, g.h, g.w, sink);
  }
  __syncthreads();

  // Flush: add the tile's nonzero floats to the grid. Every x-row of the
  // tile is one contiguous run of floats there, cut to the grid's extent.
  int gx0 = max(ox, 0), gx1 = min(ox + t, g.w);
  int n = (gx1 - gx0) * 3;
  for (int i = threadIdx.x; i < tile_floats; i += blockDim.x) {
    float v = tile[i];
    if (v == 0.0f) continue;
    int f = i % row_floats, ry = (i / row_floats) % t;
    int rz = i / (row_floats * t);
    int z = oz + rz, y = oy + ry, k = f - (gx0 - ox) * 3;
    if (z < 0 || z >= g.d || y < 0 || y >= g.h || k < 0 || k >= n) continue;
    atomicAdd(out + (((size_t)z * g.h + y) * g.w + gx0) * 3 + k, v);
  }
}

Dims make_dims(int d, int h, int w) {
  return Dims{d, h, w, (d + kBrick - 1) / kBrick, (h + kBrick - 1) / kBrick,
              (w + kBrick - 1) / kBrick};
}

// Dynamic shared memory above 48 KB has to be asked for.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int W>
cudaError_t launch_direct(const float* pos, const float* pw, int m, float r,
                          float inv_r, int d, int h, int w, float* out,
                          cudaStream_t stream) {
  int blocks = (int)(((long long)m + kThreads - 1) / kThreads);
  splat_direct_kernel<W><<<blocks, kThreads, 0, stream>>>(pos, pw, m, r,
                                                          inv_r, d, h, w, out);
  return cudaGetLastError();
}

// As many blocks as the card keeps resident with the centres' shared
// memory, or one a kThreads slots where that is fewer.
template <int W>
cudaError_t launch_grad(const float* pos, const float* g, int m, float r,
                        float inv_r, int d, int h, int w, float* dpw,
                        cudaStream_t stream) {
  const size_t smem = (size_t)(d + h + w) * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = allow_smem(splat_grad_kernel<W>, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, splat_grad_kernel<W>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long tiles = ((long long)m + kThreads - 1) / kThreads;
  const int blocks = (int)(tiles < (long long)sms * per_sm
                               ? tiles
                               : (long long)sms * per_sm);
  splat_grad_kernel<W><<<blocks, kThreads, smem, stream>>>(pos, g, m, r,
                                                           inv_r, d, h, w,
                                                           dpw);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_tiled(const float* pos, const float* pw, const int* order,
                         const int* work, const int* n_items, int max_items,
                         float r, float inv_r, Dims g, int halo, float* out,
                         cudaStream_t stream) {
  int t = kBrick + 2 * halo;
  size_t smem = (size_t)t * t * t * 3 * sizeof(float);
  cudaError_t err = allow_smem(splat_tiled_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  splat_tiled_kernel<W><<<max_items, kThreads, smem, stream>>>(
      pos, pw, order, work, n_items, r, inv_r, g, halo, out);
  return cudaGetLastError();
}

}  // namespace

// Every entry point enqueues on the given stream, allocates nothing, does
// not synchronise, and returns the first CUDA error of its calls and
// launches (0 for none).

// Direct design: zeroes out (d, h, w, 3) and adds the splat of m deposits,
// one thread each. width: cells a window can hold per axis
// (5 or 8 keep the weights; anything else recomputes them).
extern "C" int cpm_splat_direct(const float* pos, const float* pw, int m,
                                float r, float inv_r, int d, int h, int w,
                                int width, float* out, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)d * h * w * 3 * sizeof(float), stream);
  if (err != cudaSuccess || m == 0) return (int)err;
  switch (width) {
    case 5:
      return (int)launch_direct<5>(pos, pw, m, r, inv_r, d, h, w, out, stream);
    case 8:
      return (int)launch_direct<8>(pos, pw, m, r, inv_r, d, h, w, out, stream);
    default:
      return (int)launch_direct<0>(pos, pw, m, r, inv_r, d, h, w, out, stream);
  }
}

// Backward of the splat: writes dpw (m, 3), the transpose of the splat of
// m deposits applied to the grid gradient g (d, h, w, 3), one thread per
// slot, (d + h + w) * 4 bytes of shared memory a block (at most 227 KB).
// width as for cpm_splat_direct.
extern "C" int cpm_splat_grad(const float* pos, const float* g, int m,
                              float r, float inv_r, int d, int h, int w,
                              int width, float* dpw, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (m == 0) return 0;
  switch (width) {
    case 5:
      return (int)launch_grad<5>(pos, g, m, r, inv_r, d, h, w, dpw, stream);
    case 8:
      return (int)launch_grad<8>(pos, g, m, r, inv_r, d, h, w, dpw, stream);
    default:
      return (int)launch_grad<0>(pos, g, m, r, inv_r, d, h, w, dpw, stream);
  }
}

// Bins m deposits by output brick. meta is scratch of
// 3 * nb + 2 + 3 * max_items ints (nb bricks): counts [nb], cursors [nb],
// offsets [nb + 1], the number of work items [1], the work items
// [3 * max_items]. order is scratch of m ints; its first offsets[nb] hold
// the live deposits' indices grouped by brick. chunk (a multiple of 256) is
// the deposits per block of the counting passes, seg the most deposits of
// a work item; max_items >= non-empty bricks + m / seg.
extern "C" int cpm_bin_deposits(const float* pos, int m, int chunk, int seg,
                                int d, int h, int w, int* meta, int* order,
                                void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  Dims g = make_dims(d, h, w);
  int nb = g.nbz * g.nby * g.nbx;
  int* counts = meta;
  int* cursor = meta + nb;
  int* offsets = meta + 2 * nb;
  int* n_items = meta + 3 * nb + 1;
  int* work = meta + 3 * nb + 2;
  cudaError_t err =
      cudaMemsetAsync(meta, 0, 2 * (size_t)nb * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  int blocks = (int)(((long long)m + chunk - 1) / chunk);
  size_t hist = (size_t)nb * sizeof(int);
  if ((err = allow_smem(bin_count_kernel, hist)) != cudaSuccess ||
      (err = allow_smem(bin_fill_kernel, 2 * hist)) != cudaSuccess)
    return (int)err;
  if (blocks > 0) {
    bin_count_kernel<<<blocks, kThreads, hist, stream>>>(pos, m, chunk, g, nb,
                                                         counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  bin_scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, nb, seg, offsets,
                                                  n_items, work);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (blocks > 0) {
    bin_fill_kernel<<<blocks, kThreads, 2 * hist, stream>>>(
        pos, m, chunk, g, nb, offsets, cursor, order);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// Tiled design, after cpm_bin_deposits of the same pos into meta and order:
// zeroes out (d, h, w, 3) and adds every work item's tile. halo: cells a
// support can reach beyond its deposit's cell; width: 5 or 8 (wider
// windows are the direct design's).
extern "C" int cpm_splat_tiled(const float* pos, const float* pw,
                               const int* order, const int* meta,
                               int max_items, float r, float inv_r, int d,
                               int h, int w, int halo, int width, float* out,
                               void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  Dims g = make_dims(d, h, w);
  int nb = g.nbz * g.nby * g.nbx;
  const int* n_items = meta + 3 * nb + 1;
  const int* work = meta + 3 * nb + 2;
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)d * h * w * 3 * sizeof(float), stream);
  if (err != cudaSuccess || max_items == 0) return (int)err;
  switch (width) {
    case 5:
      return (int)launch_tiled<5>(pos, pw, order, work, n_items, max_items, r,
                                  inv_r, g, halo, out, stream);
    case 8:
      return (int)launch_tiled<8>(pos, pw, order, work, n_items, max_items, r,
                                  inv_r, g, halo, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
