// The shear-warp sweep's plane scan: every intermediate ray marched front
// to back over every plane, classified through the transfer function, lit
// from the light volume and composited, in one launch (sweep_scan_kernel);
// and its backward (sweep_scan_grad_kernel), which marches each ray again
// and yields the gradients of the volume, the light volume and the
// transfer function's positions and colours.
//
// Replaces cpm_tpu/ops/sweep_render.py:203-271 (_scan_planes): the
// lax.scan over planes whose trilinear fetch of a whole plane is a lerp
// between two slabs and two hat-matrix products, and, for the backward,
// jax.grad of that scan. The port's plain version (ops/sweep_render.py,
// _scan_planes_torch and _scan_planes_grad_torch) runs one torch step per
// plane, about a hundred operators each.
//
// What bounds it: the bytes (the volume and the light volume read once,
// the (V, U, 4) image written once) take some microseconds at the card's
// memory rate; the operations (about two hundred float operations per
// sample, 768^2 rays x 128 planes at the default frame) take about a
// quarter of a millisecond at the fp32 rate. So the forward is bound by
// its operations, and the design is one thread per ray that keeps its
// colour and transmittance in registers for the whole march: no
// intermediate leaves the chip, and a sample's eight voxels and the light
// volume's eight texels are plain cached loads. The hat matrices of the
// TPU form become the two taps of each axis that they would select: a
// 2 x 2 sum per slab instead of a product with mostly zeros. A warp is 32
// neighbouring rays of one row, so its loads of a plane fall on a few
// neighbouring voxels; a plane's two slabs of the volume are what the
// resident warps read at once, which keeps them in the L2 even where the
// whole volume is larger (256^3).
//
// The backward adds into the volume's and light volume's gradients with
// atomics. Neighbouring rays of a warp hit the same voxels, so each
// corner's contributions are summed first over the run of lanes that share
// the voxel (a segmented warp reduction), and the run's first lane makes
// the one atomic add. The transfer function's gradient (5 P entries) is
// summed per thread in shared memory and reduced per block before one
// global add per entry.
//
// Rounding follows the plain version operation for operation where it
// can: one IEEE operation per torch operator, in the same order, built
// with --fmad=false and without fast math, expf for torch.exp. The plain
// version samples through torch.matmul, whose sums of the two taps (and of
// zeros) round in the library's own way, so the two agree to rounding and
// not bit for bit. No early ray termination, and a masked sample's
// emission is still multiplied by zero, as in the plain loop.
//
// Non-finite texels (a float16 light volume holds +inf) give the plain
// version's NaN: its hat-matrix products meet every texel of a plane's
// slab with every ray, mostly with weight 0, and 0 x inf is NaN. So a
// sample is NaN wherever its plane's lerped slab holds a non-finite texel
// that its own taps do not read; the taps it reads give inf or NaN by
// their own arithmetic, and a tap that the edge clamps onto the first is
// not read twice (the hat matrix holds one weight there). Each plane's
// count of non-finite texels comes with the constants; a plane without
// any costs one compare.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // threads of a block: rays of one row
constexpr int kMaxTf = 16;   // transfer-function points the table holds
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// One scan's arguments; kernels/sweep_scan.py mirrors this layout with
// ctypes (pointers, then 32-bit integers, then floats).
struct ScanArgs {
  const float* vol;          // (na, nc, nb) slabs along the marching axis
  const float* light;        // (na2, nc2, nb2, 3)
  const float* tf_pos;       // (tf_n,)
  const float* tf_col;       // (tf_n, 4)
  const long long* k0;       // (S,) the volume's slab pair of each plane
  const long long* k1;
  const float* fz;           // (S,) and its lerp weight
  const long long* lk0;      // (S,) the light volume's
  const long long* lk1;
  const float* lfz;
  const float* valid;        // (S,) 1 for a plane in front of the eye
  const float* w_planes;     // (S,) base-grid scale of each plane
  const float* u;            // (U,) base-grid columns
  const float* v;            // (V,) base-grid rows
  const float* dl;           // (V, U) path length of one plane step
  const float* o_b;          // () the eye's in-plane coordinates
  const float* o_c;
  const int* nonfinite;      // (S,) non-finite texels of each plane's slab
  const int* lnonfinite;     // (S, 3) and of the light's, per channel
  float* out;                // (V, U, 4) forward: the intermediate image
  const float* grad_out;     // (V, U, 4) backward: the image's cotangent
  float* g_vol;              // (na, nc, nb), zeroed, or null
  float* g_light;            // (na2, nc2, nb2, 3), zeroed, or null
  float* g_pos;              // (tf_n,), zeroed, or null
  float* g_col;              // (tf_n, 4), zeroed, or null
  int na, nc, nb, na2, nc2, nb2, tf_n, n_planes, n_u, n_v;
  float sbi, ambient;
};

namespace {

// The two taps of _hat_matrix's row for texture coordinate x on an n-texel
// axis (CLAMP_TO_EDGE): v = clamp(x * n - 0.5, 0, n - 1), taps floor(v)
// and floor(v) + 1, each weighted clamp(1 - |v - k|, 0). At the last texel
// the second tap does not exist: i1 is i0 with weight 0, and tap_sum reads
// that texel once.
struct Hat {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Hat hat(float x, int n) {
  const float top = (float)(n - 1);
  const float v = fminf(fmaxf(x * (float)n - 0.5f, 0.0f), top);
  const float f0 = floorf(v);
  Hat h;
  h.i0 = (int)f0;
  h.w0 = fmaxf(1.0f - fabsf(v - f0), 0.0f);
  if (h.i0 + 1 <= n - 1) {
    h.i1 = h.i0 + 1;
    h.w1 = fmaxf(1.0f - fabsf(v - (f0 + 1.0f)), 0.0f);
  } else {
    h.i1 = h.i0;
    h.w1 = 0.0f;
  }
  return h;
}

// One ray's sample of plane k: the positions, taps and values that the
// forward composites and the backward differentiates.
struct Sample {
  Hat hb, hc, hb2, hc2;
  float fz, lfz;
  long long s0, s1, l0, l1;  // element offsets of the four slabs
  float field, mask;
  float light[3];
};

__device__ __forceinline__ float slab_at(const float* vol, long long s0,
                                         long long s1, float omf, float f,
                                         int idx) {
  return omf * __ldg(vol + s0 + idx) + f * __ldg(vol + s1 + idx);
}

// The trilinear value of one channel of a slab pair at the taps (hc, hb):
// the two slabs lerped at each tap, then summed over the rows' taps, then
// the columns'; a clamped second tap is not read. ``base`` holds (nc, nb,
// nch) texels a slab; ``bad`` is the plane's count of non-finite texels,
// and more of them than the taps read make the value NaN.
__device__ __forceinline__ float tap_sum(const float* base, long long s0,
                                         long long s1, float omf, float f,
                                         const Hat& hc, const Hat& hb,
                                         int nb, int nch, int ch, int bad) {
  const bool one_r = hc.i1 == hc.i0, one_c = hb.i1 == hb.i0;
  const int r0 = hc.i0 * nb, r1 = hc.i1 * nb;
  const float a00 = slab_at(base, s0, s1, omf, f, (r0 + hb.i0) * nch + ch);
  const float a10 =
      one_r ? 0.0f : slab_at(base, s0, s1, omf, f, (r1 + hb.i0) * nch + ch);
  const float col0 = one_r ? hc.w0 * a00 : hc.w0 * a00 + hc.w1 * a10;
  float a01 = 0.0f, a11 = 0.0f, val = hb.w0 * col0;
  if (!one_c) {
    a01 = slab_at(base, s0, s1, omf, f, (r0 + hb.i1) * nch + ch);
    a11 = one_r ? 0.0f
                : slab_at(base, s0, s1, omf, f, (r1 + hb.i1) * nch + ch);
    const float col1 = one_r ? hc.w0 * a01 : hc.w0 * a01 + hc.w1 * a11;
    val = val + hb.w1 * col1;
  }
  if (bad > 0) {
    const int read = !isfinite(a00) + !isfinite(a10) + !isfinite(a01) +
                     !isfinite(a11);
    if (bad > read) val = __int_as_float(0x7fc00000);
  }
  return val;
}

__device__ __forceinline__ Sample sample_plane(const ScanArgs& a, int k,
                                               float ob, float oc, float uu,
                                               float vv) {
  Sample s;
  const float wk = __ldg(a.w_planes + k);
  const float bk = ob + wk * (uu - ob);
  const float ck = oc + wk * (vv - oc);
  s.hb = hat(bk, a.nb);
  s.hc = hat(ck, a.nc);
  s.hb2 = hat(bk, a.nb2);
  s.hc2 = hat(ck, a.nc2);
  const float in_b = (bk >= 0.0f && bk <= 1.0f) ? 1.0f : 0.0f;
  const float in_c = (ck >= 0.0f && ck <= 1.0f) ? 1.0f : 0.0f;
  s.mask = (in_c * in_b) * __ldg(a.valid + k);

  // The volume: the slab lerp, then the rows' taps, then the columns'.
  s.fz = __ldg(a.fz + k);
  const float omf = 1.0f - s.fz;
  const long long plane = (long long)a.nc * a.nb;
  s.s0 = __ldg(a.k0 + k) * plane;
  s.s1 = __ldg(a.k1 + k) * plane;
  s.field = tap_sum(a.vol, s.s0, s.s1, omf, s.fz, s.hc, s.hb, a.nb, 1, 0,
                    __ldg(a.nonfinite + k));

  // The light volume, three channels on its own grid.
  s.lfz = __ldg(a.lfz + k);
  const float lomf = 1.0f - s.lfz;
  const long long lplane = (long long)a.nc2 * a.nb2 * 3;
  s.l0 = __ldg(a.lk0 + k) * lplane;
  s.l1 = __ldg(a.lk1 + k) * lplane;
  for (int ch = 0; ch < 3; ++ch)
    s.light[ch] = tap_sum(a.light, s.l0, s.l1, lomf, s.lfz, s.hc2, s.hb2,
                          a.nb2, 3, ch, __ldg(a.lnonfinite + 3 * k + ch));
  return s;
}

// TransferFunction.sample: segment after segment, each where x >= p[s];
// the colour below p[0] is the first point's. Returns the surviving
// segment (-1 for none) and writes its raw and clipped parameter.
__device__ __forceinline__ int tf_sample(const float* pos, const float* col,
                                         int n, float x, float rgba[4],
                                         float* t_raw, float* t_clip) {
  for (int ch = 0; ch < 4; ++ch) rgba[ch] = col[ch];
  int sel = -1;
  for (int s = 0; s + 1 < n; ++s) {
    const float w = fmaxf(pos[s + 1] - pos[s], 1e-12f);
    const float tr = (x - pos[s]) / w;
    const float t = fminf(fmaxf(tr, 0.0f), 1.0f);
    if (x >= pos[s]) {
      sel = s;
      *t_raw = tr;
      *t_clip = t;
      for (int ch = 0; ch < 4; ++ch) {
        const float c0 = col[s * 4 + ch];
        rgba[ch] = c0 + (col[(s + 1) * 4 + ch] - c0) * t;
      }
    }
  }
  return sel;
}

__global__ void __launch_bounds__(kBlock)
sweep_scan_kernel(const ScanArgs a) {
  __shared__ float pos[kMaxTf];
  __shared__ float col[kMaxTf * 4];
  for (int i = threadIdx.x; i < a.tf_n; i += blockDim.x) pos[i] = a.tf_pos[i];
  for (int i = threadIdx.x; i < a.tf_n * 4; i += blockDim.x)
    col[i] = a.tf_col[i];
  __syncthreads();

  const int iu = blockIdx.x * blockDim.x + threadIdx.x;
  const int iv = blockIdx.y;
  if (iu >= a.n_u) return;
  const float ob = *a.o_b, oc = *a.o_c;
  const float uu = a.u[iu], vv = a.v[iv];
  const long long ray = (long long)iv * a.n_u + iu;
  const float dl = a.dl[ray];

  float rgb[3] = {0.0f, 0.0f, 0.0f};
  float trans = 1.0f;
  for (int k = 0; k < a.n_planes; ++k) {
    const Sample s = sample_plane(a, k, ob, oc, uu, vv);
    float rgba[4], tr, tc;
    tf_sample(pos, col, a.tf_n, s.field, rgba, &tr, &tc);
    const float tau = ((rgba[3] * a.sbi) * dl) * s.mask;
    const float seg = expf(-tau);
    const float wgt = trans * (1.0f - seg);
    for (int ch = 0; ch < 3; ++ch)
      rgb[ch] = rgb[ch] + wgt * (rgba[ch] * (s.light[ch] + a.ambient));
    trans = trans * seg;
  }
  float* o = a.out + ray * 4;
  o[0] = rgb[0];
  o[1] = rgb[1];
  o[2] = rgb[2];
  o[3] = 1.0f - trans;
}

// Adds val[ch] into base[N idx + ch] once per run of lanes of the warp
// that share idx: the run's values are summed by a segmented reduction and
// its first lane makes the one atomic add per channel. Every lane of the
// warp must call it; a lane with nothing to add passes idx -1. A run whose
// sum is exactly 0 adds nothing.
template <int N>
__device__ __forceinline__ void warp_add(float* base, long long idx,
                                         const float (&val)[N]) {
  const int lane = threadIdx.x & 31;
  const long long prev = __shfl_up_sync(kFull, idx, 1);
  const bool head = lane == 0 || prev != idx;
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned after = heads & ~((2u << lane) - 1u);
  const int end = after ? __ffs(after) - 1 : 32;
  float sum[N];
  for (int ch = 0; ch < N; ++ch) sum[ch] = val[ch];
  for (int off = 1; off < 32; off <<= 1)
    for (int ch = 0; ch < N; ++ch) {
      const float o = __shfl_down_sync(kFull, sum[ch], off);
      if (lane + off < end) sum[ch] += o;
    }
  if (head && idx >= 0)
    for (int ch = 0; ch < N; ++ch)
      if (sum[ch] != 0.0f) atomicAdd(base + N * idx + ch, sum[ch]);
}

// The backward. Every thread of a block runs every plane, a thread past
// the last column with a cotangent of zero, so that the warp reductions
// see whole warps. Dynamic shared memory: 5 tf_n floats per thread for the
// transfer function's gradient when it is asked for.
__global__ void __launch_bounds__(kBlock)
sweep_scan_grad_kernel(const ScanArgs a) {
  __shared__ float pos[kMaxTf];
  __shared__ float col[kMaxTf * 4];
  extern __shared__ float tfg[];  // [5 tf_n][blockDim]: d pos, d colours
  const bool need_tf = a.g_pos != nullptr || a.g_col != nullptr;
  const int n = a.tf_n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) pos[i] = a.tf_pos[i];
  for (int i = threadIdx.x; i < n * 4; i += blockDim.x) col[i] = a.tf_col[i];
  if (need_tf)
    for (int i = threadIdx.x; i < 5 * n * (int)blockDim.x; i += blockDim.x)
      tfg[i] = 0.0f;
  __syncthreads();
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const int iu_raw = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = iu_raw < a.n_u;
  const int iu = live ? iu_raw : a.n_u - 1;
  const int iv = blockIdx.y;
  const float ob = *a.o_b, oc = *a.o_c;
  const float uu = a.u[iu], vv = a.v[iv];
  const long long ray = (long long)iv * a.n_u + iu;
  const float dl = a.dl[ray];

  float g[4], big_c[3];
  for (int ch = 0; ch < 4; ++ch) g[ch] = live ? a.grad_out[ray * 4 + ch] : 0.0f;
  for (int ch = 0; ch < 3; ++ch) big_c[ch] = a.out[ray * 4 + ch];
  const float g_final = g[3] * (1.0f - a.out[ray * 4 + 3]);

  float rgb[3] = {0.0f, 0.0f, 0.0f};
  float trans = 1.0f;
  for (int k = 0; k < a.n_planes; ++k) {
    const Sample s = sample_plane(a, k, ob, oc, uu, vv);
    float rgba[4], tr = 0.0f, tc = 0.0f;
    const int sel = tf_sample(pos, col, n, s.field, rgba, &tr, &tc);
    const float tau = ((rgba[3] * a.sbi) * dl) * s.mask;
    const float seg = expf(-tau);
    const float wgt = trans * (1.0f - seg);
    float emit[3], g_tau = g_final;
    for (int ch = 0; ch < 3; ++ch) {
      emit[ch] = rgba[ch] * (s.light[ch] + a.ambient);
      rgb[ch] = rgb[ch] + wgt * emit[ch];
    }
    for (int ch = 0; ch < 3; ++ch)
      g_tau += g[ch] * ((trans * seg) * emit[ch] - (big_c[ch] - rgb[ch]));
    trans = trans * seg;

    // The cotangents of the sample's RGBA and of its light.
    float g_rgba[4], g_light[3];
    for (int ch = 0; ch < 3; ++ch) {
      const float g_emit = g[ch] * wgt;
      g_rgba[ch] = g_emit * (s.light[ch] + a.ambient);
      g_light[ch] = g_emit * rgba[ch];
    }
    g_rgba[3] = ((g_tau * s.mask) * dl) * a.sbi;

    // The transfer function's adjoint (autograd's subgradients of the
    // plain form: the where chain, clip's halved ties, the width clamp).
    float g_x = 0.0f;
    if (live && sel < 0) {
      if (a.g_col != nullptr)
        for (int ch = 0; ch < 4; ++ch) tfg[(n + ch) * nt + tid] += g_rgba[ch];
    } else if (live) {
      if (a.g_col != nullptr)
        for (int ch = 0; ch < 4; ++ch) {
          const float gt = g_rgba[ch] * tc;
          tfg[(n + sel * 4 + ch) * nt + tid] += g_rgba[ch] - gt;
          tfg[(n + (sel + 1) * 4 + ch) * nt + tid] += gt;
        }
      float g_t = 0.0f;
      for (int ch = 0; ch < 4; ++ch)
        g_t += g_rgba[ch] * (col[(sel + 1) * 4 + ch] - col[sel * 4 + ch]);
      const float dclip = (tr > 0.0f && tr < 1.0f) ? 1.0f
                          : (tr == 0.0f || tr == 1.0f) ? 0.5f : 0.0f;
      const float g_raw = g_t * dclip;
      const float diff = pos[sel + 1] - pos[sel];
      const float w = fmaxf(diff, 1e-12f);
      g_x = g_raw / w;
      if (a.g_pos != nullptr) {
        const float g_w = diff >= 1e-12f
            ? -g_raw * (s.field - pos[sel]) / (w * w) : 0.0f;
        tfg[sel * nt + tid] += -g_x - g_w;
        tfg[(sel + 1) * nt + tid] += g_w;
      }
    }

    // The volume: the field's cotangent through the taps and the lerp.
    if (a.g_vol != nullptr && __any_sync(kFull, g_x != 0.0f)) {
      const float wr[2] = {s.hc.w0, s.hc.w1};
      const int ir[2] = {s.hc.i0, s.hc.i1};
      const float wc[2] = {s.hb.w0, s.hb.w1};
      const int ic[2] = {s.hb.i0, s.hb.i1};
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < 2; ++c) {
          const float gv = (g_x * wr[r]) * wc[c];
          const long long at = (long long)ir[r] * a.nb + ic[c];
          const bool on = live && gv != 0.0f;
          const float v0[1] = {(1.0f - s.fz) * gv}, v1[1] = {s.fz * gv};
          warp_add(a.g_vol, on ? s.s0 + at : -1, v0);
          warp_add(a.g_vol, on ? s.s1 + at : -1, v1);
        }
    }
    // The light volume: the same for each channel on its grid.
    if (a.g_light != nullptr &&
        __any_sync(kFull, g_light[0] != 0.0f || g_light[1] != 0.0f ||
                              g_light[2] != 0.0f)) {
      const float wr[2] = {s.hc2.w0, s.hc2.w1};
      const int ir[2] = {s.hc2.i0, s.hc2.i1};
      const float wc[2] = {s.hb2.w0, s.hb2.w1};
      const int ic[2] = {s.hb2.i0, s.hb2.i1};
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < 2; ++c) {
          const float wrc = wr[r] * wc[c];
          float v0[3], v1[3];
          bool any = false;
          for (int ch = 0; ch < 3; ++ch) {
            const float gl = g_light[ch] * wrc;
            v0[ch] = (1.0f - s.lfz) * gl;
            v1[ch] = s.lfz * gl;
            any = any || gl != 0.0f;
          }
          const long long at = (long long)ir[r] * a.nb2 + ic[c];
          const bool on = live && any;
          warp_add(a.g_light, on ? s.l0 / 3 + at : -1, v0);
          warp_add(a.g_light, on ? s.l1 / 3 + at : -1, v1);
        }
    }
  }

  if (!need_tf) return;
  __syncthreads();
  for (int e = tid; e < 5 * n; e += nt) {
    float sum = 0.0f;
    for (int t = 0; t < nt; ++t) sum += tfg[e * nt + t];
    if (e < n) {
      if (a.g_pos != nullptr && sum != 0.0f) atomicAdd(a.g_pos + e, sum);
    } else if (a.g_col != nullptr && sum != 0.0f) {
      atomicAdd(a.g_col + (e - n), sum);
    }
  }
}

}  // namespace

extern "C" int cpm_sweep_scan(const ScanArgs* args, void* stream) {
  const ScanArgs a = *args;
  if (a.n_u <= 0 || a.n_v <= 0) return 0;
  const dim3 grid((a.n_u + kBlock - 1) / kBlock, a.n_v);
  sweep_scan_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int cpm_sweep_scan_grad(const ScanArgs* args, void* stream) {
  const ScanArgs a = *args;
  if (a.n_u <= 0 || a.n_v <= 0) return 0;
  const dim3 grid((a.n_u + kBlock - 1) / kBlock, a.n_v);
  const bool need_tf = a.g_pos != nullptr || a.g_col != nullptr;
  const size_t smem = need_tf ? sizeof(float) * 5 * a.tf_n * kBlock : 0;
  sweep_scan_grad_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
