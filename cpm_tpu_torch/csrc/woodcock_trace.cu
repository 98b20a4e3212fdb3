// Woodcock (delta) tracking of every light sample through the
// TF-classified volume, with scattering, absorption and per-interaction
// photon deposits: the whole trace of cpm_tpu_torch/ops/tracer.py, and the
// majorant grids it reads, on the card.
//
// Replaces cpm_tpu/ops/tracer.py:255-601 (trace_photons): the
// lax.while_loop that advances every lane by K flights per iteration, the
// packed brick table its one gather per flight reads, and the staged lane
// compaction that narrows the loop as lanes end; and :165-176
// (_majorant_grids), the one jitted program that builds the grids.
//
// The grids (trace_grids_*_kernel, three launches a trace, nothing read
// back): each macrocell's (min, max) of the volume (cells start at voxel 0,
// the last one partial), the ring-dilated range's largest TF opacity
// (core/types.py:piecewise_opacity's operations, clamped at 0, times
// tau_max), the capped Chebyshev distance to the nearest cell with a
// nonzero majorant, eroded by one cell, and the largest majorant. The
// distance is taken as its x part along each row of cells, then the y and
// z parts over those, which is the plain version's six-pass erosion
// exactly (small integers in float). They are written as one interleaved
// (gz, gy, gx, 2) table of (majorant, distance), so that a flight reads
// both with one 8-byte load; the majorant and distance tensors the plain
// version reads are strided views of it.
//
// The trace (woodcock_trace_kernel, one launch): a thread runs one lane's
// own loop, as photontracer.cl does, its state in registers, the volume
// and the table read with plain cached loads (a trilinear fetch is eight of
// them). A flight's chain is what bounds the kernel: each flight waits on
// the gathers of the one before (the majorant it carries, the cell it
// stands in), so a warp takes as long as its longest lane's chain of
// dependent flights. What the design does about it:
// - the next flight's draws (three threefry blocks; they depend only on the
//   lane's stream and its step) are computed while the current flight's
//   loads are in flight, not ahead of them;
// - a transfer function is evaluated at its one surviving segment, found
//   by compares against the points in shared memory, with one division:
//   the where chain of the plain version keeps the last segment with
//   x >= pos[s] (NaN compares false and keeps the first opacity), so the
//   bits are the chain's. Where both transfer functions' points (8 bytes
//   a point) and a compaction's staging would not fit in a block's shared
//   memory, the wrapper launches the kernel's twin that reads the points
//   and opacities from device memory instead (the same body as
//   woodcock_trace_global_tf_kernel; for the grids,
//   trace_grids_majorant_global_tf_kernel): the same compares on the same
//   floats, so the same bits;
// - the macrocell of a voxel index is a shift or a multiply-high by a
//   reciprocal the wrapper computed, not an integer division by a runtime
//   value (the indices are non-negative and below 2^32 / cell, where both
//   give the quotient);
// - where a list holds more lanes than the card keeps resident (the large
//   frame's 4,194,304), the grid is what the card keeps resident, every
//   compact_every flights a block packs its live lanes into its lowest
//   threads through shared memory (the GPU form of the reference's staged
//   compaction: warps left without a lane stop issuing), and its freed
//   threads take the next lane numbers from a global counter. Below that
//   a thread runs one lane and a block ends with its longest lane: the
//   compaction's barriers make every warp of a block wait for the slowest
//   one's flights, and on the chain-bound lists that costs more than the
//   issue slots it frees (PERF.md). A lane's draws depend on its stream
//   and its own step only, and it writes only its own slots, so neither
//   the order nor the slot a lane runs in changes a bit of the result.
//
// Rounding follows the plain version operation for operation, as torch
// runs it on the card: one IEEE operation per torch operator, in the same
// order, built with --fmad=false and without fast math, the same libm
// calls (logf, sinf, cosf, acosf, atan2f, sqrtf), and a host divisor of a
// CUDA tensor applied as a multiplication by its float reciprocal. So the
// kernel's lanes equal the plain version's bit for bit.
//
// Draws: threefry-2x32 (20 rounds) keyed by (k0, k1), counter (lane id,
// step * 3 + j) for j < 3, five uniforms per flight, as ops/rng.py. A lane
// runs while it is active and its step is below the step limit
// K * ceil(max_steps / K): the plain loop tests its condition only every K
// flights, and an active lane's own step is the loop's global step.
//
// Counters: where args->counts is given (core/telemetry.py hands it over
// only while a profiler records) the kernel adds its acceptance tests
// (tentative collisions) and its accepted collisions (scatters and
// absorptions) to it, as the plain loop counts them. A lane carries both:
// n_int, and its tape count n_evt, which the wrapper has it count without
// a tape by record_events = -1 (no row is written below 0), so that the
// flight loop is the same code with counters or without. Outside the
// flight loop, at each compaction and at the kernel's end, each thread
// hands over the counts of the lane it ended: one warp reduction, added by
// the warp's first thread to the warp's slot in shared memory at a
// compaction, and to the card's counters at the end (one atomicAdd a
// warp).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBlock = 256;  // the trace's largest block
constexpr int kGridThreads = 256;  // the grids' blocks
constexpr int kHistory = 512;
constexpr int kCounters = 2;  // tentative, accepted collisions
constexpr int kLaneWords = 24;  // words of a lane's state (struct Lane)
constexpr int kAbsorbed = 1;
constexpr int kFirstDone = 2;
constexpr float kFltMax = 3.4028234663852886e38f;
constexpr float kBoundaryEps = 1e-5f;  // ops/tracer.py:_BOUNDARY_EPS
// Python's 2.0 * math.pi and 1 / (4 pi) as torch rounds them for float32.
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);
constexpr float kInv4Pi = (float)(1.0 / (4.0 * 3.141592653589793));

// Phase types (ops/phase.py) and event-tape codes (ops/tracer.py).
constexpr int kIsotropic = 0;
constexpr int kHenyeyGreenstein = 1;  // 2: Schlick
constexpr int kEvtNull = 0;
constexpr int kEvtScatter = 1;
constexpr int kEvtAbsorb = 2;
constexpr int kEvtForced = 3;
constexpr int kEvtFirst = 4;

}  // namespace

// One trace's arguments; kernels/woodcock_trace.py mirrors this layout
// with ctypes (pointers, then 32-bit integers, then floats, then the
// counters' pointer).
struct TraceArgs {
  const float* volume;      // (D, H, W)
  const float2* table;      // (gz, gy, gx) (majorant x tau_max, distance)
  const float* maj_global;  // () max of the majorants, on the card
  const float* tf_pos;      // (tf_n,) transfer function points
  const float* tf_opa;      // their opacities, tf_stride floats apart
  const float* tfs_pos;     // (tfs_n,) scattering transfer function
  const float* tfs_opa;
  const float* origins;     // (N, 3)
  const float* directions;  // (N, 3)
  const float* powers;      // (N, 3)
  const float* tspan;       // (N, 2)
  const long long* lane_ids;  // (N,) random stream of each lane
  float* out_pos;    // (I, N, 3), FLT_MAX where unused
  float* out_pow;    // (I, N, 3), zeros where unused
  float* out_dir;    // (I, N, 2), zeros where unused
  float* exit_power;  // (N,)
  float* exit_dir;    // (N, 2)
  float* evt_pos;    // (N, E, 3) event tape, or null
  float* evt_maj;    // (N, E)
  int* evt_type;     // (N, E)
  int* n_evt;        // (N,)
  int* hist;         // (512,) active lanes per flight, or null
  int* max_active;   // (1,) most flights a lane was active for
  unsigned long long* warp_flights;  // (1,) flights issued by a warp
  int* next_lane;    // (1,) lanes claimed past the grid's own, or null
  int n;
  int d, h, w;
  int gz, gy, gx;
  int tf_n, tfs_n;
  int tf_stride, tfs_stride;
  unsigned int k0, k1;
  int max_i;
  int step_limit;
  int cell_shift;          // log2(cell) for a power of two, else -1
  unsigned int cell_mul;   // ceil(2^32 / cell) otherwise
  int ring;
  int phase_type;
  int nss;  // no single scattering
  int clipped;
  int record_events;  // E, 0 without a tape, -1: none, tests counted
  int compact_every;  // flights between two compactions, 0 for none
  int tf_global;      // 1: the points read from device memory, opacities
                      // contiguous (tf_stride = tfs_stride = 1)
  float vdims[3];     // (W, H, D)
  float cell_ext[3];  // texture extent of a macrocell, (x, y, z)
  float clip_lo[3];
  float clip_hi[3];
  float step_size;
  float sbi;           // SAMPLING_BASE_INTERVAL_RCP
  float cell_min_ext;  // texture extent of one skippable cell
  float phase_g;
  float inv_max_i;     // float32 1 / max_interactions
  unsigned long long* counts;  // (kCounters,) added to, or null
};

// The grids' arguments (kernels/woodcock_trace.py:_GridArgs).
struct GridArgs {
  const float* volume;  // (D, H, W)
  const float* tf_pos;  // (tf_n,)
  const float* tf_opa;  // (tf_n,) at tf_stride floats apart
  float* minmax;        // (gz, gy, gx, 2) scratch: each cell's (min, max)
  float* row_max;       // (gz * gy) scratch: each row's largest majorant
  int* dx;              // (gz, gy, gx) scratch: capped x part of a distance
  float* table;         // (gz, gy, gx, 2) out: (majorant, distance)
  float* maj_global;    // () out
  int d, h, w;
  int gz, gy, gx;
  int tf_n, tf_stride;
  int cell, ring, cap;
  int tf_global;  // 1: the points read from device memory, tf_stride 1
  float tau;
};

namespace {

// torch's maximum / minimum / clamp: a NaN operand gives NaN.
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a > b ? a : b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : (a < b ? a : b);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return (x != x) ? x : (x < lo ? lo : x);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return (x != x) ? x : (x < lo ? lo : (x > hi ? hi : x));
}

// A point or opacity of a transfer function: from shared memory, or with
// kGlobal through the read-only cache from device memory.
template <bool kGlobal>
__device__ __forceinline__ float tf_at(const float* p, int s) {
  if constexpr (kGlobal) {
    return __ldg(p + s);
  } else {
    return p[s];
  }
}

// The piecewise-linear opacity of a transfer function's point list at x
// (core/types.py:piecewise_opacity), its points and opacities in shared
// memory (in device memory with kGlobal): the where chain keeps the last
// segment s < n - 1 with x >= pos[s], the first opacity where none holds
// (NaN compares false). Found by compares, then that one segment's width,
// parameter, clip and lerp, with the chain's operations in its order.
template <bool kGlobal>
__device__ __forceinline__ float tf_opacity(const float* pos,
                                            const float* opa, int n,
                                            float x) {
  int sel = -1;
#pragma unroll 4
  for (int s = 0; s + 1 < n; ++s)
    sel = x >= tf_at<kGlobal>(pos, s) ? s : sel;
  if (sel < 0) return tf_at<kGlobal>(opa, 0);
  const float ps = tf_at<kGlobal>(pos, sel);
  const float den = clamp_min(tf_at<kGlobal>(pos, sel + 1) - ps, 1e-12f);
  const float t = clamp((x - ps) / den, 0.0f, 1.0f);
  const float cs = tf_at<kGlobal>(opa, sel);
  return cs + (tf_at<kGlobal>(opa, sel + 1) - cs) * t;
}

// A transfer function's points and its opacities (tf_stride floats apart
// in device memory) into ``pos`` and ``opa`` of shared memory.
__device__ __forceinline__ void stage_tf(const float* tf_pos,
                                         const float* tf_opa, int stride,
                                         int n, float* pos, float* opa) {
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    pos[s] = tf_pos[s];
    opa[s] = tf_opa[(long long)s * stride];
  }
}

// Largest of a block's values (NaN if any is), in every thread; ``red`` is
// kGridThreads / 32 floats of shared memory.
__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = tmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int nw = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int k = 1; k < nw; ++k) m = tmax(m, red[k]);
  __syncthreads();
  return m;
}

// --- the grids ------------------------------------------------------------

// Each macrocell's (min, max) (ops/minmax.py:sequence_min_max): block
// (bx, cy, cz) takes the cells [bx * cpb, (bx + 1) * cpb) of row (cy, cz),
// cpb = 256 / cell of them (one for a wider cell), a thread the voxel
// columns x = x0 + threadIdx.x + 256 k of them, so every column it reads
// lies in one cell and a warp reads 32 neighbouring voxels a load.
__global__ void __launch_bounds__(kGridThreads)
trace_grids_minmax_kernel(const GridArgs a) {
  __shared__ float s_lo[kGridThreads], s_hi[kGridThreads];
  const int cpb = a.cell < kGridThreads ? kGridThreads / a.cell : 1;
  const int cx0 = blockIdx.x * cpb;
  const int cy = blockIdx.y, cz = blockIdx.z;
  const int x0 = cx0 * a.cell, x1 = min((cx0 + cpb) * a.cell, a.w);
  const int y0 = cy * a.cell, y1 = min(y0 + a.cell, a.h);
  const int z0 = cz * a.cell, z1 = min(z0 + a.cell, a.d);
  float lo = __int_as_float(0x7f800000), hi = -lo;
  for (int x = x0 + (int)threadIdx.x; x < x1; x += blockDim.x) {
    for (int z = z0; z < z1; ++z) {
#pragma unroll 8
      for (int y = y0; y < y1; ++y) {
        const float v = __ldg(a.volume + ((long long)z * a.h + y) * a.w + x);
        lo = tmin(lo, v);
        hi = tmax(hi, v);
      }
    }
  }
  s_lo[threadIdx.x] = lo;
  s_hi[threadIdx.x] = hi;
  __syncthreads();
  const int c = threadIdx.x;
  if (c < cpb && cx0 + c < a.gx) {
    const int t0 = cpb > 1 ? c * a.cell : 0;
    const int t1 = cpb > 1 ? t0 + a.cell : blockDim.x;
    float l = s_lo[t0], h = s_hi[t0];
    for (int t = t0 + 1; t < t1; ++t) {
      l = tmin(l, s_lo[t]);
      h = tmax(h, s_hi[t]);
    }
    const long long i = ((long long)cz * a.gy + cy) * a.gx + cx0 + c;
    a.minmax[2 * i] = l;
    a.minmax[2 * i + 1] = h;
  }
}

// One row (cy, cz) of cells a block: each cell's majorant
// (ops/majorant.py:build_majorant_grid; opacity_range_max over the
// ring-dilated (min, max), windows clipped at the borders, clamped at 0,
// times tau), the row's largest majorant, and each cell's distance along
// the row to the nearest cell with a nonzero majorant (cap + 1 for none
// within cap). The points in shared memory after the row, or with
// kTfGlobal read from device memory.
template <bool kTfGlobal>
__device__ __forceinline__ void majorant_row(const GridArgs& a) {
  extern __shared__ float sm[];  // [gx] majorants, [tf_n] points, opacities
  __shared__ float red[kGridThreads / 32];
  float* row = sm;
  const float* pos = a.tf_pos;
  const float* opa = a.tf_opa;
  if constexpr (!kTfGlobal) {
    float* spos = sm + a.gx;
    stage_tf(a.tf_pos, a.tf_opa, a.tf_stride, a.tf_n, spos, spos + a.tf_n);
    pos = spos;
    opa = spos + a.tf_n;
  }
  __syncthreads();
  const int cy = blockIdx.x, cz = blockIdx.y;
  const long long row0 = ((long long)cz * a.gy + cy) * a.gx;
  const int z0 = max(cz - a.ring, 0), z1 = min(cz + a.ring, a.gz - 1);
  const int y0 = max(cy - a.ring, 0), y1 = min(cy + a.ring, a.gy - 1);
  float most = -__int_as_float(0x7f800000);
  for (int cx = threadIdx.x; cx < a.gx; cx += blockDim.x) {
    const int x0 = max(cx - a.ring, 0), x1 = min(cx + a.ring, a.gx - 1);
    float lo = __int_as_float(0x7f800000), hi = -lo;
    for (int z = z0; z <= z1; ++z) {
      for (int y = y0; y <= y1; ++y) {
        const float2* mm = reinterpret_cast<const float2*>(a.minmax)
                           + ((long long)z * a.gy + y) * a.gx;
        for (int x = x0; x <= x1; ++x) {
          const float2 v = mm[x];
          lo = tmin(lo, v.x);
          hi = tmax(hi, v.y);
        }
      }
    }
    float m = tmax(tf_opacity<kTfGlobal>(pos, opa, a.tf_n, lo),
                   tf_opacity<kTfGlobal>(pos, opa, a.tf_n, hi));
    for (int s = 0; s < a.tf_n; ++s) {
      const float p = tf_at<kTfGlobal>(pos, s);
      if (p >= lo && p <= hi) m = tmax(m, tf_at<kTfGlobal>(opa, s));
    }
    const float maj = clamp_min(m, 0.0f) * a.tau;
    row[cx] = maj;
    a.table[2 * (row0 + cx)] = maj;
    most = tmax(most, maj);
  }
  most = block_max(most, red);
  if (threadIdx.x == 0) a.row_max[(long long)cz * a.gy + cy] = most;
  const int reach = min(a.cap, a.gx - 1);
  for (int cx = threadIdx.x; cx < a.gx; cx += blockDim.x) {
    int best = row[cx] > 0.0f ? 0 : a.cap + 1;
    for (int k = 1; k <= reach && best > a.cap; ++k) {
      if ((cx - k >= 0 && row[cx - k] > 0.0f) ||
          (cx + k < a.gx && row[cx + k] > 0.0f))
        best = k;
    }
    a.dx[row0 + cx] = best;
  }
}

__global__ void __launch_bounds__(kGridThreads)
trace_grids_majorant_kernel(const GridArgs a) {
  majorant_row<false>(a);
}

__global__ void __launch_bounds__(kGridThreads)
trace_grids_majorant_global_tf_kernel(const GridArgs a) {
  majorant_row<true>(a);
}

// Each cell's distance (ops/majorant.py:empty_distance_grid): the
// Chebyshev distance k to the nearest cell with a nonzero majorant is the
// least over the rows (z + dz, y + dy) of max(|dz|, |dy|, that row's x
// part); after cap passes of the erosion a cell holds min(k, cap + 1), the
// last min-window gives min(k - 1, cap + 1) (0 at k = 0) and the clamp
// min(., cap). Block 0 also writes the largest majorant.
__global__ void __launch_bounds__(kGridThreads)
trace_grids_distance_kernel(const GridArgs a) {
  __shared__ float red[kGridThreads / 32];
  const long long n = (long long)a.gz * a.gy * a.gx;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int cx = (int)(i % a.gx);
    const int cy = (int)((i / a.gx) % a.gy);
    const int cz = (int)(i / ((long long)a.gx * a.gy));
    int best = a.cap + 1;
    const int z0 = max(cz - a.cap, 0), z1 = min(cz + a.cap, a.gz - 1);
    const int y0 = max(cy - a.cap, 0), y1 = min(cy + a.cap, a.gy - 1);
    for (int z = z0; z <= z1; ++z) {
      const int dz = abs(z - cz);
      if (dz >= best) continue;
#pragma unroll 4
      for (int y = y0; y <= y1; ++y) {
        const int k = max(max(dz, abs(y - cy)),
                          __ldg(a.dx + ((long long)z * a.gy + y) * a.gx + cx));
        best = min(best, k);
      }
    }
    a.table[2 * i + 1] = (float)min(a.cap, max(best - 1, 0));
  }
  if (blockIdx.x == 0) {
    float most = -__int_as_float(0x7f800000);
    for (int r = threadIdx.x; r < a.gz * a.gy; r += blockDim.x)
      most = tmax(most, a.row_max[r]);
    most = block_max(most, red);
    if (threadIdx.x == 0) *a.maj_global = most;
  }
}

// --- the trace ------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (ops/rng.py:threefry2x32).
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t c0, uint32_t c1,
                                         uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int r = 0; r < 20; ++r) {
    x0 += x1;
    x1 = rotl(x1, rot[r % 8]) ^ x0;
    if ((r + 1) % 4 == 0) {
      const int g = (r + 1) / 4;
      x0 += ks[g % 3];
      x1 += ks[(g + 1) % 3] + (uint32_t)g;
    }
  }
  o0 = x0;
  o1 = x1;
}

__device__ __forceinline__ float bits_to_uniform(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

// The five uniforms of a lane's flight ``step``: three threefry blocks.
__device__ __forceinline__ void draws(const TraceArgs& a, uint32_t c0,
                                      int step, float u[5]) {
  uint32_t r[6];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    threefry(a.k0, a.k1, c0, (uint32_t)step * 3u + (uint32_t)j, r[2 * j],
             r[2 * j + 1]);
#pragma unroll
  for (int j = 0; j < 5; ++j) u[j] = bits_to_uniform(r[j]);
}

// Continuous voxel coordinate along one axis, clamped to [0, dim - 1]
// (ops/sampling.py:voxel_coords).
__device__ __forceinline__ float voxel_coord(float p, float dim) {
  return clamp(p * dim - 0.5f, 0.0f, dim - 1.0f);
}

// The macrocell of a voxel index v >= 0: v // cell.
__device__ __forceinline__ int cell_of(const TraceArgs& a, int v) {
  return a.cell_shift >= 0 ? v >> a.cell_shift
                           : (int)__umulhi((unsigned)v, a.cell_mul);
}

// The slab test of one ray against the clip box (ops/intersect.py:ray_box)
// with t0 = 0 and t1 = 3.4e38.
__device__ bool ray_box(const float o[3], const float dir[3],
                        const float lo[3], const float hi[3], float& t_near,
                        float& t_far) {
  float tn = 0.0f, tf = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float d = dir[a];
    float inv;
    if (fabsf(d) > 1e-30f) {
      inv = 1.0f / d;
    } else {
      const float sg = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
      inv = sg * 1e30f + (d == 0.0f ? 1.0f : 0.0f) * 1e30f;
    }
    const float ta = (lo[a] - o[a]) * inv;
    const float tb = (hi[a] - o[a]) * inv;
    const float mn = tmin(ta, tb);
    const float mx = tmax(ta, tb);
    tn = a == 0 ? mn : tmax(tn, mn);
    tf = a == 0 ? mx : tmin(tf, mx);
  }
  t_near = tmax(tn, 0.0f);
  t_far = tmin(tf, 3.4e38f);
  return t_near <= t_far;
}

// Direction -> (theta, phi) (core/types.py:encode_direction).
__device__ __forceinline__ void encode_direction(const float dir[3],
                                                 float* out) {
  out[0] = acosf(clamp(dir[2], -1.0f, 1.0f));
  out[1] = atan2f(dir[1], dir[0]);
}

// A direction at polar angle acos(cos_theta) around wi, azimuth 2 pi u2
// (ops/phase.py:_from_cos_theta with _orthonormal_frame).
__device__ void from_cos_theta(const float wi[3], float cos_theta, float u2,
                               float wo[3]) {
  const float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta,
                                          0.0f));
  const float phi = kTwoPi * u2;
  const float sign = wi[2] >= 0.0f ? 1.0f : -1.0f;
  const float a = -(1.0f / (sign + wi[2]));
  const float b = (wi[0] * wi[1]) * a;
  const float t[3] = {1.0f + (sign * (wi[0] * wi[0])) * a, sign * b,
                      (-sign) * wi[0]};
  const float bv[3] = {b, sign + (wi[1] * wi[1]) * a, -wi[1]};
  const float ca = sin_theta * cosf(phi);
  const float sb = sin_theta * sinf(phi);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wo[c] = (t[c] * ca + bv[c] * sb) + wi[c] * cos_theta;
  }
}

// Phase-function direction and pdf (ops/phase.py:sample_phase).
__device__ float sample_phase(int type, const float wi[3], float g, float u1,
                              float u2, float wo[3]) {
  if (type == kIsotropic) {
    from_cos_theta(wi, 1.0f - 2.0f * u1, u2, wo);
    return kInv4Pi;
  }
  const bool safe = fabsf(g) > 1e-3f;
  const float gs = safe ? g : 1.0f;
  float cos_theta;
  if (type == kHenyeyGreenstein) {
    const float sqr = (1.0f - gs * gs) / ((1.0f + gs) - (2.0f * gs) * u1);
    const float cos_hg = ((1.0f + gs * gs) - sqr * sqr) / (2.0f * gs);
    cos_theta = clamp(safe ? cos_hg : 1.0f - 2.0f * u1, -1.0f, 1.0f);
  } else {  // Schlick
    const float cos_sl = ((2.0f * u1 + gs) - 1.0f)
                         / (((2.0f * gs) * u1 - gs) + 1.0f);
    cos_theta = clamp(safe ? cos_sl : 1.0f - 2.0f * u1, -1.0f, 1.0f);
  }
  from_cos_theta(wi, cos_theta, u2, wo);
  if (!safe) return kInv4Pi;
  if (type == kHenyeyGreenstein) {
    const float g2 = g * g;
    const float denom = clamp_min((1.0f + g2) - (2.0f * g) * cos_theta,
                                  1e-8f);
    return (kInv4Pi * (1.0f - g2)) / (denom * sqrtf(denom));
  }
  const float denom = clamp_min(1.0f + g * cos_theta, 1e-4f);
  return (kInv4Pi * (1.0f - g * g)) / (denom * denom);
}

// A transfer function's point list, in shared memory or in device memory.
struct Tf {
  const float* pos;
  const float* opa;
  int n;
};

// A live lane between two flights: kLaneWords words, which the compaction
// moves through shared memory.
struct Lane {
  float pos[3], dir[3], power[3];
  float t, t_end, maj_carry, dist_carry;
  float u[5];    // this flight's draws
  int idx;       // the lane's place in the list, where it writes
  uint32_t c0;   // its random stream
  int step, n_int, n_evt;
  int flags;     // kAbsorbed | kFirstDone
};

// Word k of lane slot r in the compaction's staging area: [k][slots].
__device__ __forceinline__ void stage_lane(float* s, int slots, int r,
                                           const Lane& L) {
  const float f[kLaneWords] = {
      L.pos[0], L.pos[1], L.pos[2], L.dir[0], L.dir[1], L.dir[2],
      L.power[0], L.power[1], L.power[2], L.t, L.t_end, L.maj_carry,
      L.dist_carry, L.u[0], L.u[1], L.u[2], L.u[3], L.u[4],
      __int_as_float(L.idx), __uint_as_float(L.c0), __int_as_float(L.step),
      __int_as_float(L.n_int), __int_as_float(L.n_evt),
      __int_as_float(L.flags)};
#pragma unroll
  for (int k = 0; k < kLaneWords; ++k) s[k * slots + r] = f[k];
}

__device__ __forceinline__ void unstage_lane(const float* s, int slots,
                                             int r, Lane& L) {
  float f[kLaneWords];
#pragma unroll
  for (int k = 0; k < kLaneWords; ++k) f[k] = s[k * slots + r];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    L.pos[c] = f[c];
    L.dir[c] = f[3 + c];
    L.power[c] = f[6 + c];
  }
  L.t = f[9];
  L.t_end = f[10];
  L.maj_carry = f[11];
  L.dist_carry = f[12];
#pragma unroll
  for (int j = 0; j < 5; ++j) L.u[j] = f[13 + j];
  L.idx = __float_as_int(f[18]);
  L.c0 = __float_as_uint(f[19]);
  L.step = __float_as_int(f[20]);
  L.n_int = __float_as_int(f[21]);
  L.n_evt = __float_as_int(f[22]);
  L.flags = __float_as_int(f[23]);
}

// A lane's exit power and direction and its tape count; ``most`` keeps the
// most flights a lane of this thread was active for.
__device__ __forceinline__ void finish_lane(const TraceArgs& a,
                                            const Lane& L, int& most) {
  a.exit_power[L.idx] = (L.flags & kAbsorbed) ? kFltMax : L.power[0];
  encode_direction(L.dir, a.exit_dir + 2 * (long long)L.idx);
  if (a.record_events > 0) a.n_evt[L.idx] = L.n_evt;
  most = max(most, L.step);
}

// Load lane ``idx`` of the list; false (its exits written) where it makes
// no flight: the plain loop's active = t < t_end, and a step limit of 0.
__device__ bool start_lane(const TraceArgs& a, int idx, float maj_global,
                           Lane& L, int& most) {
  const long long li = idx;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    L.pos[c] = a.origins[3 * li + c];
    L.dir[c] = a.directions[3 * li + c];
    // A CUDA tensor divided by a host number: times its reciprocal.
    L.power[c] = a.powers[3 * li + c] * a.inv_max_i;
  }
  L.t = a.tspan[2 * li];
  L.t_end = a.tspan[2 * li + 1];
  if (a.clipped) {
    float ct0, ct1;
    const bool chit = ray_box(L.pos, L.dir, a.clip_lo, a.clip_hi, ct0, ct1);
    L.t = tmax(L.t, chit ? ct0 : 0.0f);
    L.t_end = tmin(L.t_end, chit ? ct1 : -1.0f);
  }
  L.idx = idx;
  L.c0 = (uint32_t)(unsigned long long)a.lane_ids[idx];
  L.step = 0;
  L.n_int = 0;
  L.n_evt = 0;
  L.flags = a.nss ? 0 : kFirstDone;
  L.maj_carry = maj_global;
  L.dist_carry = 0.0f;
  if (!(L.t < L.t_end) || a.step_limit <= 0) {
    finish_lane(a, L, most);
    return false;
  }
  draws(a, L.c0, 0, L.u);
  return true;
}

// One flight of a live lane (the plain loop's body, ops/tracer.py); true
// while the lane goes on: active, and its step below the step limit.
template <bool kTfGlobal>
__device__ __forceinline__ bool flight(const TraceArgs& a, const Tf& tf,
                                       const Tf& tfs, float maj_global,
                                       int* hist, unsigned* warp_flights,
                                       Lane& L) {
  if (hist != nullptr) {
    // One shared add per group of this warp's lanes at this step, and one
    // count of the warp's pass through this flight (the SIMT efficiency is
    // the active lane-flights over 32 of them).
    const unsigned act = __activemask();
    const unsigned same = __match_any_sync(act, L.step);
    if ((threadIdx.x & 31) == __ffs(same) - 1) {
      atomicAdd(&hist[min(L.step, kHistory - 1)], __popc(same));
    }
    if ((threadIdx.x & 31) == __ffs(act) - 1) atomicAdd(warp_flights, 1u);
  }
  const float fring = (float)a.ring;

  // --- macrocell delta-tracking step ---
  float t_cell = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float pc = L.pos[c] + L.t * L.dir[c];
    const int cell = cell_of(a, (int)floorf(voxel_coord(pc, a.vdims[c])));
    const float cf = (float)cell;
    const float face = L.dir[c] > 0.0f
                           ? ((cf + 1.0f) + fring) * a.cell_ext[c]
                           : (cf - fring) * a.cell_ext[c];
    const float tc = fabsf(L.dir[c]) > 1e-12f ? (face - L.pos[c]) / L.dir[c]
                                              : __int_as_float(0x7f800000);
    t_cell = c == 0 ? tc : tmin(t_cell, tc);
  }
  t_cell = tmax(t_cell, L.t);
  const float maj_op = L.maj_carry;
  const float dt = (-logf(clamp_min(L.u[0], 1e-12f)))
                   / clamp_min(maj_op * a.sbi, 1e-12f);
  const float t_tent = L.t + dt;
  const bool empty = maj_op <= 0.0f;
  const bool skip = empty || t_tent > t_cell;
  const float t_jump = L.t + clamp_min(L.dist_carry - 1.0f, 0.0f)
                                 * a.cell_min_ext;
  const float t_clamp = empty ? tmax(t_cell, t_jump) : t_cell;
  const float t_new = skip ? t_clamp + kBoundaryEps : t_tent;
  if (t_new > L.t_end) {  // exited
    ++L.step;
    return false;
  }

  float p[3], cc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p[c] = L.pos[c] + t_new * L.dir[c];
    cc[c] = voxel_coord(p[c], a.vdims[c]);
  }
  const int gi =
      (min(cell_of(a, (int)floorf(cc[2])), a.gz - 1) * a.gy
       + min(cell_of(a, (int)floorf(cc[1])), a.gy - 1)) * a.gx
      + min(cell_of(a, (int)floorf(cc[0])), a.gx - 1);
  const float2 at_p = __ldg(a.table + gi);  // (majorant, distance) at p

  // The trilinear fetch's eight loads (ops/sampling.py:_trilinear), issued
  // before the next flight's draws so that those overlap them.
  float cfr[3], v[8];
  if (!skip) {
    int lo[3], hi[3];
    const int dims[3] = {a.w, a.h, a.d};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float f0 = floorf(cc[c]);
      cfr[c] = cc[c] - f0;
      lo[c] = (int)f0;
      hi[c] = min(lo[c] + 1, dims[c] - 1);
    }
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const long long base =
            ((long long)(dz ? hi[2] : lo[2]) * a.h + (dy ? hi[1] : lo[1]))
            * a.w;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          v[4 * dz + 2 * dy + dx] = __ldg(a.volume + base
                                          + (dx ? hi[0] : lo[0]));
        }
      }
    }
  }
  float un[5];
  draws(a, L.c0, L.step + 1, un);

  bool collide = false, interact = false, first_event = false;
  bool do_scatter = false;
  float albedo = 0.0f, opacity = 0.0f;
  if (!skip) {
    // Corners summed z, then y, then x, each weight (wx * wy) * wz.
    float vol = 0.0f;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const float wz = dz ? cfr[2] : 1.0f - cfr[2];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float wy = dy ? cfr[1] : 1.0f - cfr[1];
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float wx = dx ? cfr[0] : 1.0f - cfr[0];
          const float wgt = (wx * wy) * wz;
          vol = vol + v[4 * dz + 2 * dy + dx] * wgt;
        }
      }
    }
    opacity = tf_opacity<kTfGlobal>(tf.pos, tf.opa, tf.n, vol);
    // Acceptance against the local majorant: P = sigma / sigma_maj.
    collide = L.u[1] * maj_op < opacity;
    if (collide) {
      const bool first_done = L.flags & kFirstDone;
      first_event = !first_done;
      interact = first_done;
      const float scat_w = tf_opacity<kTfGlobal>(tfs.pos, tfs.opa, tfs.n,
                                                 vol);
      albedo = scat_w / clamp_min(scat_w + opacity, 1e-8f);
      do_scatter = interact && L.n_int + 1 < a.max_i && L.u[2] < albedo;
    }
    if (a.record_events) {
      // Every acceptance test, in the reference's priority: rejected,
      // first event, forced stop at the cap, scatter, absorption.
      if (L.n_evt < a.record_events) {
        const long long row = (long long)L.idx * a.record_events + L.n_evt;
        int etype = do_scatter ? kEvtScatter : kEvtAbsorb;
        if (L.n_int + 1 >= a.max_i) etype = kEvtForced;
        if (first_event) etype = kEvtFirst;
        if (!collide) etype = kEvtNull;
#pragma unroll
        for (int c = 0; c < 3; ++c) a.evt_pos[3 * row + c] = p[c];
        a.evt_maj[row] = maj_op;
        a.evt_type[row] = etype;
      }
      ++L.n_evt;
    }
  }

  bool active;
  if (interact) {
    // --- interaction (photontracer.cl:158-197): deposit at slot n_int with
    // the incoming direction ---
    const float op = clamp_min(opacity, 0.01f);
    float stored[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float power_in = L.power[c] / op;
      stored[c] = do_scatter ? power_in * albedo : power_in;
    }
    const long long slot = (long long)L.n_int * a.n + L.idx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.out_pos[3 * slot + c] = p[c];
      a.out_pow[3 * slot + c] = stored[c];
    }
    encode_direction(L.dir, a.out_dir + 2 * slot);
#pragma unroll
    for (int c = 0; c < 3; ++c) L.power[c] = do_scatter ? stored[c] : kFltMax;
    L.n_int += 1;
    L.flags = do_scatter ? L.flags & ~kAbsorbed : L.flags | kAbsorbed;
  }
  if (do_scatter || first_event) {
    float new_dir[3];
    const float pdf = sample_phase(a.phase_type, L.dir, a.phase_g, L.u[3],
                                   L.u[4], new_dir);
    float bt0, bt1;
    const bool hit = ray_box(p, new_dir, a.clip_lo, a.clip_hi, bt0, bt1);
    if (first_event) {
      const float pc = clamp_min(pdf, 1e-8f);
#pragma unroll
      for (int c = 0; c < 3; ++c) L.power[c] = L.power[c] / pc;
      L.flags |= kFirstDone;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      L.pos[c] = p[c];
      L.dir[c] = new_dir[c];
    }
    // Nudge past the interaction point (photontracer.cl:181-183).
    L.t = bt0 + 0.5f * a.step_size;
    L.t_end = bt1;
    active = hit;
    // The next segment may start in another cell: carry the global
    // majorant for one flight.
    L.maj_carry = maj_global;
    L.dist_carry = 0.0f;
  } else {
    active = !collide;
    if (!interact) L.t = t_new;
    L.maj_carry = at_p.x;
    L.dist_carry = at_p.y;
  }
  ++L.step;
#pragma unroll
  for (int j = 0; j < 5; ++j) L.u[j] = un[j];
  return active && L.step < a.step_limit;
}

// The sum of v over the warp's 32 threads (all of them present).
__device__ __forceinline__ unsigned long long warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, (unsigned)v);
}

// Block b starts with lanes [b * blockDim, (b + 1) * blockDim); with
// compaction, every compact_every flights it packs its live lanes into its
// lowest threads and, where next_lane is given, its free threads take the
// lanes gridDim * blockDim + next_lane++ while there are any. Both
// transfer functions' points and opacities sit in shared memory before the
// staging area, or with kTfGlobal are read from device memory.
template <bool kTfGlobal>
__device__ __forceinline__ void trace_lanes(const TraceArgs& a) {
  extern __shared__ float smem[];  // [points, opacities of both TFs][staging]
  __shared__ int hist[kHistory];
  __shared__ int s_live[kMaxBlock / 32];
  __shared__ int s_claim;
  __shared__ unsigned s_warp_flights;
  __shared__ unsigned long long s_counts[kMaxBlock / 32][kCounters];
  int* const hp = a.hist != nullptr ? hist : nullptr;
  if (hp != nullptr) {
    for (int k = threadIdx.x; k < kHistory; k += blockDim.x) hist[k] = 0;
    if (threadIdx.x == 0) s_warp_flights = 0;
  }
  const bool counting = a.counts != nullptr;
  if (counting && (threadIdx.x & 31) == 0) {
    // The warp's first thread owns its slot: no barrier before or after.
#pragma unroll
    for (int k = 0; k < kCounters; ++k) s_counts[threadIdx.x >> 5][k] = 0;
  }
  Tf tf = {a.tf_pos, a.tf_opa, a.tf_n};
  Tf tfs = {a.tfs_pos, a.tfs_opa, a.tfs_n};
  float* stage = smem;
  if constexpr (!kTfGlobal) {
    float* const tfs_pos = smem + 2 * a.tf_n;
    tf = {smem, smem + a.tf_n, a.tf_n};
    tfs = {tfs_pos, tfs_pos + a.tfs_n, a.tfs_n};
    stage = tfs_pos + 2 * a.tfs_n;
    stage_tf(a.tf_pos, a.tf_opa, a.tf_stride, a.tf_n, smem, smem + a.tf_n);
    stage_tf(a.tfs_pos, a.tfs_opa, a.tfs_stride, a.tfs_n, tfs_pos,
             tfs_pos + a.tfs_n);
  }
  __syncthreads();

  const float maj_global = *a.maj_global;
  const int slots = blockDim.x;
  const int first_claimed = gridDim.x * slots;
  int most = 0;
  Lane L;
  L.n_evt = 0;  // a thread with no lane hands over nothing
  L.n_int = 0;
  const int first = blockIdx.x * slots + threadIdx.x;
  bool has = first < a.n && start_lane(a, first, maj_global, L, most);
  bool more = a.next_lane != nullptr;  // lanes may be left to claim
  const int per_phase = a.compact_every > 0 ? a.compact_every : INT_MAX;

  for (;;) {
    for (int f = 0; f < per_phase && has; ++f) {
      has = flight<kTfGlobal>(a, tf, tfs, maj_global, hp, &s_warp_flights,
                              L);
      if (!has) finish_lane(a, L, most);
    }
    if (a.compact_every <= 0) break;
    if (counting) {
      // The lanes ended in this phase hand over their counts (a live lane
      // keeps its own; an ended lane's are handed over once).
      const unsigned long long t = warp_sum(has ? 0 : L.n_evt);
      const unsigned long long c = warp_sum(has ? 0 : L.n_int);
      if ((threadIdx.x & 31) == 0) {
        s_counts[threadIdx.x >> 5][0] += t;
        s_counts[threadIdx.x >> 5][1] += c;
      }
    }
    // Pack the live lanes into the lowest threads, in thread order.
    const unsigned live = __ballot_sync(0xffffffffu, has);
    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
    if (wl == 0) s_live[warp] = __popc(live);
    __syncthreads();
    int rank = __popc(live & ((1u << wl) - 1u)), total = 0;
    for (int k = 0; k < (slots + 31) >> 5; ++k) {
      rank += k < warp ? s_live[k] : 0;
      total += s_live[k];
    }
    if (has) stage_lane(stage, slots, rank, L);
    // The free threads' lanes: one claim of the block (-1: none made,
    // INT_MAX: none left).
    if (threadIdx.x == 0) {
      s_claim = -1;
      if (more && total < slots) {
        const int got = atomicAdd(a.next_lane, slots - total);
        s_claim = got < a.n - first_claimed ? got : INT_MAX;
      }
    }
    __syncthreads();
    const int claim = s_claim;
    if (claim == INT_MAX) more = false;
    has = threadIdx.x < total;
    if (has) {
      unstage_lane(stage, slots, threadIdx.x, L);
    } else if (claim >= 0 && claim != INT_MAX) {
      const int idx = first_claimed + claim + (threadIdx.x - total);
      has = idx < a.n && start_lane(a, idx, maj_global, L, most);
    }
    // A thread left with no lane holds an ended lane's counts, handed
    // over, or a copy of a live lane now in another thread.
    if (counting && !has) L.n_evt = L.n_int = 0;
    if (total == 0 && !more) break;  // the same in every thread
  }

  if (hp != nullptr) {
    // The flights a lane was active for: the most of this warp, then one
    // atomic of the warp.
    const unsigned m = __reduce_max_sync(0xffffffffu, (unsigned)most);
    if ((threadIdx.x & 31) == 0 && m > 0) atomicMax(a.max_active, (int)m);
    __syncthreads();
    for (int k = threadIdx.x; k < kHistory; k += blockDim.x) {
      if (hist[k]) atomicAdd(a.hist + k, hist[k]);
    }
    if (threadIdx.x == 0)
      atomicAdd(a.warp_flights, (unsigned long long)s_warp_flights);
  }
  if (counting) {
    // Every lane has ended: the last ones' counts and the warp's slot, one
    // add each to the card's.
    const unsigned long long t = warp_sum(L.n_evt);
    const unsigned long long c = warp_sum(L.n_int);
    if ((threadIdx.x & 31) == 0) {
      const unsigned long long* s = s_counts[threadIdx.x >> 5];
      if (t + s[0] != 0ull) atomicAdd(a.counts, t + s[0]);
      if (c + s[1] != 0ull) atomicAdd(a.counts + 1, c + s[1]);
    }
  }
}

__global__ void __launch_bounds__(kMaxBlock)
woodcock_trace_kernel(const TraceArgs a) {
  trace_lanes<false>(a);
}

__global__ void __launch_bounds__(kMaxBlock)
woodcock_trace_global_tf_kernel(const TraceArgs a) {
  trace_lanes<true>(a);
}

}  // namespace

// Returned where a block would need more shared memory than the card has
// (apart from every CUDA error's code and its negative).
constexpr int kTooMuchShared = -100000;

// The kernels whose blocks may hold transfer functions in shared memory,
// as cpm_woodcock_shared_limit numbers them.
constexpr int kTraceKernel = 0;
constexpr int kGridsKernel = 1;

static const void* trace_kernel(int tf_global) {
  return tf_global ? (const void*)woodcock_trace_global_tf_kernel
                   : (const void*)woodcock_trace_kernel;
}

static const void* grids_kernel(int tf_global) {
  return tf_global ? (const void*)trace_grids_majorant_global_tf_kernel
                   : (const void*)trace_grids_majorant_kernel;
}

// Lets ``kernel`` take ``bytes`` of dynamic shared memory a block on the
// current card: past the 48 KB every kernel may take, it opts in, up to
// what a block may have beside the kernel's static arrays. 0, a CUDA error,
// or kTooMuchShared.
static int allow_shared(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  if (bytes + fa.sharedSizeBytes > (size_t)optin) return kTooMuchShared;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Dynamic shared memory of one trace block: both transfer functions'
// points and opacities unless they are read from device memory, and with
// compaction the lanes' staging area.
static size_t trace_smem(const TraceArgs& a, int block) {
  size_t floats = a.tf_global ? 0 : 2 * (size_t)(a.tf_n + a.tfs_n);
  if (a.compact_every > 0) floats += (size_t)kLaneWords * block;
  return floats * sizeof(float);
}

// The dynamic shared memory a block of ``which`` (kTraceKernel or
// kGridsKernel, holding its transfer functions in shared memory) may take
// on the current card: the card's opt-in limit a block
// (cudaDevAttrMaxSharedMemoryPerBlockOptin) less the kernel's static
// arrays; minus a CUDA error. The wrappers hold the bytes trace_smem and
// cpm_trace_grids would need against it before they launch, and read the
// transfer functions from device memory past it.
extern "C" int cpm_woodcock_shared_limit(int which) {
  if (which != kTraceKernel && which != kGridsKernel)
    return -(int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(
        &fa, which == kTraceKernel ? trace_kernel(0) : grids_kernel(0));
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)fa.sharedSizeBytes;
}

// Resident trace blocks of ``block`` threads per SM of the current card at
// ``smem`` bytes of dynamic shared memory, for the kernel that reads its
// transfer functions from shared memory (tf_global 0) or from device
// memory (1); kTooMuchShared, or minus a CUDA error.
extern "C" int cpm_woodcock_occupancy(int block, int smem, int tf_global) {
  const void* kernel = trace_kernel(tf_global);
  const int allowed = allow_shared(kernel, (size_t)smem);
  if (allowed != 0) return allowed == kTooMuchShared ? allowed : -allowed;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel, block, (size_t)smem);
  return err == cudaSuccess ? n : -(int)err;
}

// The trace in ``grid`` blocks of ``block`` threads (block a multiple of
// 32, at most kMaxBlock; kernels/woodcock_trace.py:launch_shape), by the
// kernel that args->tf_global names; next_lane is zeroed here. 0, a CUDA
// error or kTooMuchShared.
extern "C" int cpm_woodcock_trace(const TraceArgs* args, int grid, int block,
                                  void* stream_) {
  const TraceArgs a = *args;
  cudaStream_t stream = (cudaStream_t)stream_;
  if (a.n <= 0) return 0;
  if (block < 32 || block > kMaxBlock || block % 32 != 0 || grid < 1)
    return (int)cudaErrorInvalidConfiguration;
  if (a.tf_global && (a.tf_stride != 1 || a.tfs_stride != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = trace_smem(a, block);
  const void* kernel = trace_kernel(a.tf_global);
  const int allowed = allow_shared(kernel, smem);
  if (allowed != 0) return allowed;
  if (a.next_lane != nullptr) {
    const cudaError_t err =
        cudaMemsetAsync(a.next_lane, 0, sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (a.tf_global) {
    woodcock_trace_global_tf_kernel<<<grid, block, smem, stream>>>(a);
  } else {
    woodcock_trace_kernel<<<grid, block, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The majorant grids of one trace: three launches, the majorant kernel the
// one args->tf_global names. 0, a CUDA error or kTooMuchShared (a row of
// cells, and unless they are read from device memory the points, beyond a
// block's shared memory).
extern "C" int cpm_trace_grids(const GridArgs* args, void* stream_) {
  const GridArgs a = *args;
  cudaStream_t stream = (cudaStream_t)stream_;
  if (a.tf_global && a.tf_stride != 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (a.gx + (a.tf_global ? 0 : 2 * (size_t)a.tf_n));
  const int allowed = allow_shared(grids_kernel(a.tf_global), smem);
  if (allowed != 0) return allowed;
  const int cpb = a.cell < kGridThreads ? kGridThreads / a.cell : 1;
  trace_grids_minmax_kernel<<<dim3((a.gx + cpb - 1) / cpb, a.gy, a.gz),
                              kGridThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.tf_global) {
    trace_grids_majorant_global_tf_kernel<<<dim3(a.gy, a.gz), kGridThreads,
                                            smem, stream>>>(a);
  } else {
    trace_grids_majorant_kernel<<<dim3(a.gy, a.gz), kGridThreads, smem,
                                  stream>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long cells = (long long)a.gz * a.gy * a.gx;
  trace_grids_distance_kernel<<<(unsigned)((cells + kGridThreads - 1)
                                           / kGridThreads),
                                kGridThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
