// Woodcock (delta) tracking of every light sample through the
// TF-classified volume, with scattering, absorption and per-interaction
// photon deposits: the whole trace of cpm_tpu_torch/ops/tracer.py in one
// launch, one thread per lane.
//
// Replaces cpm_tpu/ops/tracer.py:255-601 (trace_photons): the
// lax.while_loop that advances every lane by K flights per iteration, the
// packed brick table its one gather per flight reads, and the staged lane
// compaction that narrows the loop as lanes end. On a GPU a lane runs its
// own loop, as photontracer.cl does: its state lives in registers, the
// volume and the majorant and distance grids are read with plain cached
// loads (a trilinear fetch is eight of them), and a thread whose lane has
// ended retires. That retirement is the GPU form of the compaction: a warp
// runs as long as its longest lane, and the SM takes up other warps when a
// whole warp has ended.
//
// What bounds it: the bytes it must move (the volume, the light samples,
// the lane ids, the deposits and the exits) take some microseconds at the
// card's memory rate, and so do its operations (three threefry blocks and
// about two hundred float operations per active lane and flight). Neither
// is what binds: each flight of a lane waits on the gathers of the one
// before (the majorant it carries, the cell it stands in), so a warp's
// time is its longest lane's chain of dependent flights. The design keeps
// blocks small (64 threads) so that even a retrace of a few thousand lanes
// spreads over every SM, and does no work for a lane that is no longer
// active: no volume fetch for a flight that is clamped at a block exit or
// lands past the lane's end, and no phase sampling without a scatter.
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;
constexpr int kHistory = 512;
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
// with ctypes (pointers, then 32-bit integers, then floats).
struct TraceArgs {
  const float* volume;      // (D, H, W)
  const float* maj;         // (gz, gy, gx) majorant opacity x tau_max
  const float* dist;        // (gz, gy, gx) capped empty-space distance
  const float* maj_global;  // () max of maj, on the card
  const float* tf_pos;      // (tf_n,) transfer function points
  const float* tf_opa;      // (tf_n,) their opacities
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
  int n;
  int d, h, w;
  int gz, gy, gx;
  int tf_n, tfs_n;
  unsigned int k0, k1;
  int max_i;
  int step_limit;
  int cell_vox;
  int ring;
  int phase_type;
  int nss;  // no single scattering
  int clipped;
  int record_events;  // E, 0 without a tape
  float vdims[3];     // (W, H, D)
  float cell_ext[3];  // texture extent of a macrocell, (x, y, z)
  float clip_lo[3];
  float clip_hi[3];
  float step_size;
  float sbi;           // SAMPLING_BASE_INTERVAL_RCP
  float cell_min_ext;  // texture extent of one skippable cell
  float phase_g;
  float inv_max_i;     // float32 1 / max_interactions
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

// The piecewise-linear opacity of a transfer function's point list
// (core/types.py:TransferFunction.sample_opacity).
__device__ float tf_opacity(const float* __restrict__ pos,
                            const float* __restrict__ opa, int np, float x) {
  float acc = __ldg(opa);
  for (int s = 0; s + 1 < np; ++s) {
    const float ps = __ldg(pos + s);
    const float den = clamp_min(__ldg(pos + s + 1) - ps, 1e-12f);
    const float t = clamp((x - ps) / den, 0.0f, 1.0f);
    const float cs = __ldg(opa + s);
    const float seg = cs + (__ldg(opa + s + 1) - cs) * t;
    if (x >= ps) acc = seg;
  }
  return acc;
}

// Continuous voxel coordinate along one axis, clamped to [0, dim - 1]
// (ops/sampling.py:voxel_coords).
__device__ __forceinline__ float voxel_coord(float p, float dim) {
  return clamp(p * dim - 0.5f, 0.0f, dim - 1.0f);
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

__global__ void __launch_bounds__(kBlock)
woodcock_trace_kernel(const TraceArgs a) {
  __shared__ int hist[kHistory];
  const bool stats = a.hist != nullptr;
  if (stats) {
    for (int k = threadIdx.x; k < kHistory; k += blockDim.x) hist[k] = 0;
    __syncthreads();
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  int step = 0;
  if (lane < a.n) {
    const long long nl = a.n;
    const long long li = lane;
    float pos[3], dir[3], power[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pos[c] = a.origins[3 * li + c];
      dir[c] = a.directions[3 * li + c];
      // A CUDA tensor divided by a host number: times its reciprocal.
      power[c] = a.powers[3 * li + c] * a.inv_max_i;
    }
    float t = a.tspan[2 * li];
    float t_end = a.tspan[2 * li + 1];
    if (a.clipped) {
      float ct0, ct1;
      const bool chit = ray_box(pos, dir, a.clip_lo, a.clip_hi, ct0, ct1);
      t = tmax(t, chit ? ct0 : 0.0f);
      t_end = tmin(t_end, chit ? ct1 : -1.0f);
    }
    const uint32_t c0 = (uint32_t)(unsigned long long)a.lane_ids[lane];
    const float maj_global = *a.maj_global;
    bool active = t < t_end;
    bool absorbed = false;
    bool first_done = !a.nss;
    int n_int = 0;
    int n_evt = 0;
    float maj_carry = maj_global;
    float dist_carry = 0.0f;
    const float fring = (float)a.ring;

    while (active && step < a.step_limit) {
      if (stats) {
        // One shared add per group of this warp's lanes at this step.
        const unsigned same = __match_any_sync(__activemask(), step);
        if ((threadIdx.x & 31) == __ffs(same) - 1) {
          atomicAdd(&hist[min(step, kHistory - 1)], __popc(same));
        }
      }
      float u[6];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        uint32_t r0, r1;
        threefry(a.k0, a.k1, c0, (uint32_t)step * 3u + (uint32_t)j, r0, r1);
        u[2 * j] = bits_to_uniform(r0);
        u[2 * j + 1] = bits_to_uniform(r1);
      }

      // --- macrocell delta-tracking step ---
      float t_cell = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float pc = pos[c] + t * dir[c];
        const int cell = (int)floorf(voxel_coord(pc, a.vdims[c])) / a.cell_vox;
        const float cf = (float)cell;
        const float face = dir[c] > 0.0f
                               ? ((cf + 1.0f) + fring) * a.cell_ext[c]
                               : (cf - fring) * a.cell_ext[c];
        const float tf = fabsf(dir[c]) > 1e-12f ? (face - pos[c]) / dir[c]
                                                : __int_as_float(0x7f800000);
        t_cell = c == 0 ? tf : tmin(t_cell, tf);
      }
      t_cell = tmax(t_cell, t);
      const float maj_op = maj_carry;
      const float dt = (-logf(clamp_min(u[0], 1e-12f)))
                       / clamp_min(maj_op * a.sbi, 1e-12f);
      const float t_tent = t + dt;
      const bool empty = maj_op <= 0.0f;
      const bool skip = empty || t_tent > t_cell;
      const float t_jump = t + clamp_min(dist_carry - 1.0f, 0.0f)
                                   * a.cell_min_ext;
      const float t_clamp = empty ? tmax(t_cell, t_jump) : t_cell;
      const float t_new = skip ? t_clamp + kBoundaryEps : t_tent;
      const bool exited = t_new > t_end;
      if (exited) {
        active = false;
        ++step;
        break;
      }

      float p[3];
      int vi[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p[c] = pos[c] + t_new * dir[c];
        vi[c] = (int)floorf(voxel_coord(p[c], a.vdims[c]));
      }
      const int gi = (min(vi[2] / a.cell_vox, a.gz - 1) * a.gy
                      + min(vi[1] / a.cell_vox, a.gy - 1)) * a.gx
                     + min(vi[0] / a.cell_vox, a.gx - 1);
      const float maj_at_p = __ldg(a.maj + gi);
      const float dist_at_p = __ldg(a.dist + gi);

      bool collide = false, interact = false, first_event = false;
      bool do_scatter = false;
      float albedo = 0.0f, opacity = 0.0f;
      if (!skip) {
        // Trilinear fetch (ops/sampling.py:_trilinear): corners summed
        // z, then y, then x, each weight (wx * wy) * wz.
        float cfr[3];
        int lo[3], hi[3];
        const int dims[3] = {a.w, a.h, a.d};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float cc = voxel_coord(p[c], a.vdims[c]);
          const float f0 = floorf(cc);
          cfr[c] = cc - f0;
          lo[c] = (int)f0;
          hi[c] = min(lo[c] + 1, dims[c] - 1);
        }
        float vol = 0.0f;
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          const int cz = dz ? hi[2] : lo[2];
          const float wz = dz ? cfr[2] : 1.0f - cfr[2];
#pragma unroll
          for (int dy = 0; dy < 2; ++dy) {
            const int cy = dy ? hi[1] : lo[1];
            const float wy = dy ? cfr[1] : 1.0f - cfr[1];
            const long long base = ((long long)cz * a.h + cy) * a.w;
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
              const int cx = dx ? hi[0] : lo[0];
              const float wx = dx ? cfr[0] : 1.0f - cfr[0];
              const float wgt = (wx * wy) * wz;
              vol = vol + __ldg(a.volume + base + cx) * wgt;
            }
          }
        }
        opacity = tf_opacity(a.tf_pos, a.tf_opa, a.tf_n, vol);
        // Acceptance against the local majorant: P = sigma / sigma_maj.
        collide = u[1] * maj_op < opacity;
        if (collide) {
          first_event = !first_done;
          interact = first_done;
          const float scat_w = tf_opacity(a.tfs_pos, a.tfs_opa, a.tfs_n, vol);
          albedo = scat_w / clamp_min(scat_w + opacity, 1e-8f);
          do_scatter = interact && n_int + 1 < a.max_i && u[2] < albedo;
        }
        if (a.record_events) {
          // Every acceptance test, in the reference's priority: rejected,
          // first event, forced stop at the cap, scatter, absorption.
          if (n_evt < a.record_events) {
            const long long row = (long long)lane * a.record_events + n_evt;
            int etype = do_scatter ? kEvtScatter : kEvtAbsorb;
            if (n_int + 1 >= a.max_i) etype = kEvtForced;
            if (first_event) etype = kEvtFirst;
            if (!collide) etype = kEvtNull;
#pragma unroll
            for (int c = 0; c < 3; ++c) a.evt_pos[3 * row + c] = p[c];
            a.evt_maj[row] = maj_op;
            a.evt_type[row] = etype;
          }
          ++n_evt;
        }
      }

      if (interact) {
        // --- interaction (photontracer.cl:158-197): deposit at slot
        // n_int with the incoming direction ---
        const float op = clamp_min(opacity, 0.01f);
        float power_in[3], stored[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          power_in[c] = power[c] / op;
          stored[c] = do_scatter ? power_in[c] * albedo : power_in[c];
        }
        const long long slot = (long long)n_int * nl + lane;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          a.out_pos[3 * slot + c] = p[c];
          a.out_pow[3 * slot + c] = stored[c];
        }
        encode_direction(dir, a.out_dir + 2 * slot);
#pragma unroll
        for (int c = 0; c < 3; ++c) power[c] = do_scatter ? stored[c] : kFltMax;
        n_int += 1;
        absorbed = !do_scatter;
      }
      const bool change_dir = do_scatter || first_event;
      if (change_dir) {
        float new_dir[3];
        const float pdf = sample_phase(a.phase_type, dir, a.phase_g, u[3],
                                       u[4], new_dir);
        float bt0, bt1;
        const bool hit = ray_box(p, new_dir, a.clip_lo, a.clip_hi, bt0, bt1);
        if (first_event) {
          const float pc = clamp_min(pdf, 1e-8f);
#pragma unroll
          for (int c = 0; c < 3; ++c) power[c] = power[c] / pc;
          first_done = true;
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          pos[c] = p[c];
          dir[c] = new_dir[c];
        }
        // Nudge past the interaction point (photontracer.cl:181-183).
        t = bt0 + 0.5f * a.step_size;
        t_end = bt1;
        active = hit;
        // The next segment may start in another cell: carry the global
        // majorant for one flight.
        maj_carry = maj_global;
        dist_carry = 0.0f;
      } else {
        active = !collide;
        if (!interact) t = t_new;
        maj_carry = maj_at_p;
        dist_carry = dist_at_p;
      }
      ++step;
    }

    a.exit_power[lane] = absorbed ? kFltMax : power[0];
    encode_direction(dir, a.exit_dir + 2 * li);
    if (a.record_events) a.n_evt[lane] = n_evt;
  }
  if (stats) {
    // The flights a lane was active for: the most of this warp, then one
    // atomic of the warp.
    const unsigned most = __reduce_max_sync(0xffffffffu, (unsigned)step);
    if ((threadIdx.x & 31) == 0 && most > 0) {
      atomicMax(a.max_active, (int)most);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < kHistory; k += blockDim.x) {
      if (hist[k]) atomicAdd(a.hist + k, hist[k]);
    }
  }
}

}  // namespace

extern "C" int cpm_woodcock_trace(const TraceArgs* args, void* stream) {
  const TraceArgs a = *args;
  if (a.n <= 0) return 0;
  const int blocks = (a.n + kBlock - 1) / kBlock;
  woodcock_trace_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
