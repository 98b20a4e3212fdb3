// The shear-warp sweep's plane scan: every intermediate ray marched front
// to back over every plane, classified through the transfer function, lit
// from the light volume and composited. The forward is two kernels a chunk
// of planes: a plane pre-pass (sweep_planes_kernel) and a lean per-ray
// march (sweep_scan_kernel). The backward (sweep_scan_grad_kernel) marches
// each ray again and yields the gradients of the volume, the light volume
// and the transfer function's positions and colours.
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
// its operations, and what it loses to that bound is instructions that
// are not those operations: the first design recomputed, in every thread
// and for every sample, what depends only on the plane, the row or the
// column (64-bit slab offsets, four hat rows, the slab lerp of each tap)
// and every segment of the transfer function with a division each.
//
// The forward's design. The pre-pass does, once per plane, what the
// reference does once per plane (it lerps each plane's whole slab,
// sweep_render.py:224-239): it writes the volume's lerped plane (nc, nb),
// the light volume's as (nc2, nb2, 4) with a pad so that a tap is one
// 16-byte load, the two taps and weights of hat() for every column and
// every row of both grids (rows premultiplied by the row length), the
// column mask, the row mask times the plane's validity, and the plane's
// non-finite counts. The march, one thread per ray, then reads per plane
// its row's entry (the same address in every lane of a block: a block is
// 128 rays of one row), its column's entry, four texels of the volume's
// plane and four float4 texels of the light's, with 32-bit offsets, and
// finds the transfer function's surviving segment by compares alone
// before its one division. Planes go in chunks under a byte budget that
// the wrapper sets (kernels/sweep_scan.py, PLANE_BUDGET): the chunk's
// planes live in scratch that the wrapper allocates, and the march
// carries each ray's colour and transmittance from chunk to chunk in the
// (V, U, 4) output, which is the lax.scan carry. At the default frame one
// chunk of 128 planes takes 24.1 MB (16.8 MB of lerped planes, the rest
// tables), which stays in the 50 MB L2.
//
// The transfer function has any number P of points. Its points stay in
// global memory; a sample compares its value with P - 1 positions (the
// same address in every lane), keeps the last segment with x >= pos[s]
// (-1 for none: NaN compares false, as in the where chain), and computes
// that one segment's width, parameter, clip and lerp with the operations
// of every segment before, so the bits are the first design's.
//
// The backward adds into the volume's and light volume's gradients with
// atomics. Neighbouring rays of a warp hit the same voxels, so each
// corner's contributions are summed first over the run of lanes that share
// the voxel (a segmented warp reduction), and the run's first lane makes
// the one atomic add. The transfer function's gradient (5 P entries) is
// summed in registers over the run of planes that share a segment, and
// each run is added into one table a block (shared memory, where 5 P
// floats fit under TF_SHARED_BYTES) or into the gradient itself (global
// atomics) where they do not; a block's table goes to the gradient once.
//
// Rounding follows the plain version operation for operation where it
// can: one IEEE operation per torch operator, in the same order, built
// with --fmad=false and without fast math, expf for torch.exp. The plain
// version samples through torch.matmul, whose sums of the two taps (and of
// zeros) round in the library's own way, so the two agree to rounding and
// not bit for bit. No early ray termination, and a masked sample's
// emission is still multiplied by zero, as in the plain loop. A chunked
// forward equals a one-chunk forward bit for bit.
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
//
// What bounds the forward now (counted by scripts/sass_counts.py from
// cuobjdump -sass of the built library, registers from -Xptxas -v; static
// counts of the plane loop's body, both sides of each branch): the
// march's plane loop holds 309 instructions, 20 of them a pass of the
// transfer function's compare loop (four points a pass), at 48 registers;
// the first design's held 754, 86 of them a loop over every segment with
// its division, at 48. At the default frame (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py) the march takes 0.75 ms and the pre-pass 0.02 ms at 4
// points, against the first design's 1.73 ms: instruction issue, at
// roughly the static count a sample. The compare loop is linear in the
// points: the march takes 0.95 ms at 17, 1.73 at 64 and 4.90 at 256. The
// backward holds 1,974 (first design 1,735) at 80 registers (72): the run
// sums of the transfer function's gradient.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;      // threads of a march block: rays of one row
constexpr int kPrepBlock = 256;  // threads of a pre-pass block
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// One scan's arguments; kernels/sweep_scan.py mirrors this layout with
// ctypes (pointers, then 32-bit integers, then floats).
struct ScanArgs {
  const float* vol;          // (na, nc, nb) slabs along the marching axis
  const float* light;        // (na2, nc2, nb2, 3)
  const float* tf_pos;       // (tf_n,)
  const float* tf_col;       // (tf_n, 4), 16-byte aligned
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
  // The forward's prepared planes of one chunk (cs = k_hi - k_lo planes):
  // the pre-pass writes them, the march reads them.
  float* p_vol;              // (cs, nc, nb) lerped slabs
  float* p_light;            // (cs, nc2, nb2, 4) lerped, channel 3 zero
  int* col_i;                // (cs, U, 4) column taps: volume i0 i1, light
  float* col_w;              // (cs, U, 4) and their weights
  float* col_m;              // (cs, U) 1 where the column is in the box
  int* row_i;                // (cs, V, 4) row taps times the row length
  float* row_w;              // (cs, V, 4)
  float* row_m;              // (cs, V) in the box, times the plane's valid
  int* counts;               // (cs, 4) non-finite texels: volume, r, g, b
  int na, nc, nb, na2, nc2, nb2, tf_n, n_planes, n_u, n_v;
  int k_lo, k_hi;            // the chunk's planes
  int first, last;           // the chunk starts the carry, ends it
  int tf_shared;             // backward: the 5 tf_n table in shared memory
  float sbi, ambient;
};

namespace {

// The two taps of _hat_matrix's row for texture coordinate x on an n-texel
// axis (CLAMP_TO_EDGE): v = clamp(x * n - 0.5, 0, n - 1), taps floor(v)
// and floor(v) + 1, each weighted clamp(1 - |v - k|, 0). At the last texel
// the second tap does not exist: i1 is i0 with weight 0, and a tap sum
// reads that texel once.
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

__device__ __forceinline__ float in_box(float x) {
  return (x >= 0.0f && x <= 1.0f) ? 1.0f : 0.0f;
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// The trilinear value of one channel of lerped texels at the taps: summed
// over the rows' taps, then the columns'; a clamped second tap (i1 == i0)
// is not read (and passed as 0).
__device__ __forceinline__ float tap_value(float a00, float a10, float a01,
                                           float a11, bool one_r, bool one_c,
                                           float rw0, float rw1, float cw0,
                                           float cw1) {
  const float col0 = one_r ? rw0 * a00 : rw0 * a00 + rw1 * a10;
  float val = cw0 * col0;
  if (!one_c) {
    const float col1 = one_r ? rw0 * a01 : rw0 * a01 + rw1 * a11;
    val = val + cw1 * col1;
  }
  return val;
}

// ``bad`` is the plane's count of non-finite texels, and more of them than
// the taps read make the value NaN.
__device__ __forceinline__ float nan_rule(float val, float a00, float a10,
                                          float a01, float a11, int bad) {
  const int read = !isfinite(a00) + !isfinite(a10) + !isfinite(a01) +
                   !isfinite(a11);
  return bad > read ? nan_f() : val;
}

// TransferFunction.sample at x: the where chain keeps the last segment s
// with x >= pos[s] (NaN compares false), the first colour where none
// holds. Found by compares alone, then that one segment's width,
// parameter, clip and lerp, with the operations and order that every
// segment had in the chain: the same bits for one division.
struct TfSample {
  int sel;           // the surviving segment, -1 for none
  float rgba[4];
  float t_raw, t_clip;
  float p0, diff;    // pos[sel] and pos[sel + 1] - pos[sel]
  float dcol[4];     // col[sel + 1] - col[sel]
};

__device__ __forceinline__ TfSample tf_sample(const float* pos,
                                              const float4* col, int n,
                                              float x) {
  TfSample t;
  int sel = -1;
#pragma unroll 4
  for (int s = 0; s + 1 < n; ++s) sel = x >= __ldg(pos + s) ? s : sel;
  t.sel = sel;
  t.t_raw = t.t_clip = t.p0 = t.diff = 0.0f;
  if (sel < 0) {
    const float4 c = __ldg(col);
    t.rgba[0] = c.x;
    t.rgba[1] = c.y;
    t.rgba[2] = c.z;
    t.rgba[3] = c.w;
    for (int ch = 0; ch < 4; ++ch) t.dcol[ch] = 0.0f;
    return t;
  }
  t.p0 = __ldg(pos + sel);
  t.diff = __ldg(pos + sel + 1) - t.p0;
  const float w = fmaxf(t.diff, 1e-12f);
  t.t_raw = (x - t.p0) / w;
  t.t_clip = fminf(fmaxf(t.t_raw, 0.0f), 1.0f);
  const float4 c0 = __ldg(col + sel), c1 = __ldg(col + sel + 1);
  const float a[4] = {c0.x, c0.y, c0.z, c0.w};
  const float b[4] = {c1.x, c1.y, c1.z, c1.w};
  for (int ch = 0; ch < 4; ++ch) {
    t.dcol[ch] = b[ch] - a[ch];
    t.rgba[ch] = a[ch] + t.dcol[ch] * t.t_clip;
  }
  return t;
}

// --- the forward: pre-pass and march -----------------------------------

// One launch a chunk: blockIdx.y walks the chunk's planes, the block's
// threads the texels, columns and rows of each.
__global__ void __launch_bounds__(kPrepBlock)
sweep_planes_kernel(const ScanArgs a) {
  const int cs = a.k_hi - a.k_lo;
  const int n_vol = a.nc * a.nb, n_light = a.nc2 * a.nb2;
  const int n_items = max(max(n_vol, n_light), max(a.n_u, a.n_v));
  const float ob = *a.o_b, oc = *a.o_c;
  for (int kl = blockIdx.y; kl < cs; kl += gridDim.y) {
    const int k = a.k_lo + kl;
    const float fz = a.fz[k], omf = 1.0f - fz;
    const float* s0 = a.vol + (int)a.k0[k] * n_vol;
    const float* s1 = a.vol + (int)a.k1[k] * n_vol;
    const float lfz = a.lfz[k], lomf = 1.0f - lfz;
    const float* l0 = a.light + (int)a.lk0[k] * n_light * 3;
    const float* l1 = a.light + (int)a.lk1[k] * n_light * 3;
    const float wk = a.w_planes[k];
    float* pv = a.p_vol + kl * n_vol;
    float4* pl = reinterpret_cast<float4*>(a.p_light) + kl * n_light;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
         i += gridDim.x * blockDim.x) {
      if (i < n_vol) pv[i] = omf * s0[i] + fz * s1[i];
      if (i < n_light) {
        float4 t;
        t.x = lomf * l0[3 * i] + lfz * l1[3 * i];
        t.y = lomf * l0[3 * i + 1] + lfz * l1[3 * i + 1];
        t.z = lomf * l0[3 * i + 2] + lfz * l1[3 * i + 2];
        t.w = 0.0f;
        pl[i] = t;
      }
      if (i < a.n_u) {
        const float bk = ob + wk * (a.u[i] - ob);
        const Hat h = hat(bk, a.nb), h2 = hat(bk, a.nb2);
        const int at = kl * a.n_u + i;
        reinterpret_cast<int4*>(a.col_i)[at] = make_int4(h.i0, h.i1, h2.i0,
                                                         h2.i1);
        reinterpret_cast<float4*>(a.col_w)[at] =
            make_float4(h.w0, h.w1, h2.w0, h2.w1);
        a.col_m[at] = in_box(bk);
      }
      if (i < a.n_v) {
        const float ck = oc + wk * (a.v[i] - oc);
        const Hat h = hat(ck, a.nc), h2 = hat(ck, a.nc2);
        const int at = kl * a.n_v + i;
        reinterpret_cast<int4*>(a.row_i)[at] =
            make_int4(h.i0 * a.nb, h.i1 * a.nb, h2.i0 * a.nb2,
                      h2.i1 * a.nb2);
        reinterpret_cast<float4*>(a.row_w)[at] =
            make_float4(h.w0, h.w1, h2.w0, h2.w1);
        a.row_m[at] = in_box(ck) * a.valid[k];
      }
      if (i == 0)
        reinterpret_cast<int4*>(a.counts)[kl] =
            make_int4(a.nonfinite[k], a.lnonfinite[3 * k],
                      a.lnonfinite[3 * k + 1], a.lnonfinite[3 * k + 2]);
    }
  }
}

// One thread a ray over the chunk's planes; the colour and transmittance
// start at (0, 1) in the first chunk and come from ``out`` otherwise.
__global__ void __launch_bounds__(kBlock)
sweep_scan_kernel(const ScanArgs a) {
  const int iu = blockIdx.x * blockDim.x + threadIdx.x;
  const int iv = blockIdx.y;
  if (iu >= a.n_u) return;
  const int ray = iv * a.n_u + iu;
  const float dl = a.dl[ray];
  float4* out = reinterpret_cast<float4*>(a.out) + ray;
  const float4 carry = a.first ? make_float4(0.0f, 0.0f, 0.0f, 1.0f) : *out;
  float rgb[3] = {carry.x, carry.y, carry.z};
  float trans = carry.w;

  const int cs = a.k_hi - a.k_lo;
  const int n_vol = a.nc * a.nb, n_light = a.nc2 * a.nb2;
  const float* pv = a.p_vol;
  const float4* pl = reinterpret_cast<const float4*>(a.p_light);
  const int4* row_i = reinterpret_cast<const int4*>(a.row_i) + iv;
  const float4* row_w = reinterpret_cast<const float4*>(a.row_w) + iv;
  const float* row_m = a.row_m + iv;
  const int4* col_i = reinterpret_cast<const int4*>(a.col_i) + iu;
  const float4* col_w = reinterpret_cast<const float4*>(a.col_w) + iu;
  const float* col_m = a.col_m + iu;
  const int4* counts = reinterpret_cast<const int4*>(a.counts);
  const float4* tf_col = reinterpret_cast<const float4*>(a.tf_col);

  for (int kl = 0; kl < cs; ++kl) {
    const int4 ri = __ldg(row_i), ci = __ldg(col_i);
    const float4 rw = __ldg(row_w), cw = __ldg(col_w);
    const float mask = __ldg(row_m) * __ldg(col_m);
    const int4 bad = __ldg(counts + kl);
    row_i += a.n_v;
    row_w += a.n_v;
    row_m += a.n_v;
    col_i += a.n_u;
    col_w += a.n_u;
    col_m += a.n_u;

    // The volume: four lerped texels.
    const bool one_r = ri.y == ri.x, one_c = ci.y == ci.x;
    const float a00 = __ldg(pv + (ri.x + ci.x));
    const float a10 = one_r ? 0.0f : __ldg(pv + (ri.y + ci.x));
    const float a01 = one_c ? 0.0f : __ldg(pv + (ri.x + ci.y));
    const float a11 = one_r || one_c ? 0.0f : __ldg(pv + (ri.y + ci.y));
    float field = tap_value(a00, a10, a01, a11, one_r, one_c, rw.x, rw.y,
                            cw.x, cw.y);
    pv += n_vol;

    // The light volume: four float4 texels, three channels.
    const bool one_r2 = ri.w == ri.z, one_c2 = ci.w == ci.z;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 b00 = __ldg(pl + (ri.z + ci.z));
    const float4 b10 = one_r2 ? zero : __ldg(pl + (ri.w + ci.z));
    const float4 b01 = one_c2 ? zero : __ldg(pl + (ri.z + ci.w));
    const float4 b11 = one_r2 || one_c2 ? zero : __ldg(pl + (ri.w + ci.w));
    float light[3] = {
        tap_value(b00.x, b10.x, b01.x, b11.x, one_r2, one_c2, rw.z, rw.w,
                  cw.z, cw.w),
        tap_value(b00.y, b10.y, b01.y, b11.y, one_r2, one_c2, rw.z, rw.w,
                  cw.z, cw.w),
        tap_value(b00.z, b10.z, b01.z, b11.z, one_r2, one_c2, rw.z, rw.w,
                  cw.z, cw.w)};
    pl += n_light;
    if ((bad.x | bad.y | bad.z | bad.w) != 0) {  // a plane with inf or NaN
      field = nan_rule(field, a00, a10, a01, a11, bad.x);
      light[0] = nan_rule(light[0], b00.x, b10.x, b01.x, b11.x, bad.y);
      light[1] = nan_rule(light[1], b00.y, b10.y, b01.y, b11.y, bad.z);
      light[2] = nan_rule(light[2], b00.z, b10.z, b01.z, b11.z, bad.w);
    }

    const TfSample t = tf_sample(a.tf_pos, tf_col, a.tf_n, field);
    const float tau = ((t.rgba[3] * a.sbi) * dl) * mask;
    const float seg = expf(-tau);
    const float wgt = trans * (1.0f - seg);
    for (int ch = 0; ch < 3; ++ch)
      rgb[ch] = rgb[ch] + wgt * (t.rgba[ch] * (light[ch] + a.ambient));
    trans = trans * seg;
  }
  *out = make_float4(rgb[0], rgb[1], rgb[2], a.last ? 1.0f - trans : trans);
}

// --- the backward -------------------------------------------------------

// One ray's sample of plane k from the volumes themselves: the positions,
// taps and values that the backward differentiates (the forward's values
// by the same operations).
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

// tap_value and nan_rule over a slab pair that is lerped at each tap. ``base`` holds
// (nc, nb, nch) texels a slab.
__device__ __forceinline__ float tap_sum(const float* base, long long s0,
                                         long long s1, float omf, float f,
                                         const Hat& hc, const Hat& hb,
                                         int nb, int nch, int ch, int bad) {
  const bool one_r = hc.i1 == hc.i0, one_c = hb.i1 == hb.i0;
  const int r0 = hc.i0 * nb, r1 = hc.i1 * nb;
  const float a00 = slab_at(base, s0, s1, omf, f, (r0 + hb.i0) * nch + ch);
  const float a10 =
      one_r ? 0.0f : slab_at(base, s0, s1, omf, f, (r1 + hb.i0) * nch + ch);
  float a01 = 0.0f, a11 = 0.0f;
  if (!one_c) {
    a01 = slab_at(base, s0, s1, omf, f, (r0 + hb.i1) * nch + ch);
    a11 = one_r ? 0.0f
                : slab_at(base, s0, s1, omf, f, (r1 + hb.i1) * nch + ch);
  }
  const float val = tap_value(a00, a10, a01, a11, one_r, one_c, hc.w0,
                              hc.w1, hb.w0, hb.w1);
  return bad > 0 ? nan_rule(val, a00, a10, a01, a11, bad) : val;
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
  s.mask = (in_box(ck) * in_box(bk)) * __ldg(a.valid + k);

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

// The transfer function's gradient of one run of planes that share the
// segment ``sel``: acc[0..3] for colour row max(sel, 0), acc[4..7] for
// row sel + 1, acc[8], acc[9] for positions sel and sel + 1. Added into
// ``table`` ([tf_n positions][tf_n x 4 colours] in shared memory) where
// ``shared``, else into the gradients; a zero adds nothing.
__device__ __forceinline__ void tf_add(const ScanArgs& a, bool shared,
                                       float* table, int e, float val) {
  if (val == 0.0f) return;
  if (shared)
    atomicAdd(table + e, val);
  else if (e < a.tf_n)
    atomicAdd(a.g_pos + e, val);
  else
    atomicAdd(a.g_col + (e - a.tf_n), val);
}

__device__ __forceinline__ void tf_flush(const ScanArgs& a, bool shared,
                                         float* table, int sel,
                                         const float (&acc)[10]) {
  if (sel < -1) return;
  const int n = a.tf_n;
  if (a.g_col != nullptr) {
    const int r0 = sel < 0 ? 0 : sel;
    for (int ch = 0; ch < 4; ++ch)
      tf_add(a, shared, table, n + 4 * r0 + ch, acc[ch]);
    if (sel >= 0)
      for (int ch = 0; ch < 4; ++ch)
        tf_add(a, shared, table, n + 4 * (sel + 1) + ch, acc[4 + ch]);
  }
  if (a.g_pos != nullptr && sel >= 0) {
    tf_add(a, shared, table, sel, acc[8]);
    tf_add(a, shared, table, sel + 1, acc[9]);
  }
}

// The backward. Every thread of a block runs every plane, a thread past
// the last column with a cotangent of zero, so that the warp reductions
// see whole warps. Dynamic shared memory: the 5 tf_n floats of the
// transfer function's gradient table when it is asked for and tf_shared.
// The ten run sums cost registers; six blocks an SM hold them at 80.
__global__ void __launch_bounds__(kBlock, 6)
sweep_scan_grad_kernel(const ScanArgs a) {
  extern __shared__ float tfg[];  // [5 tf_n]: d positions, d colours
  const bool need_tf = a.g_pos != nullptr || a.g_col != nullptr;
  const int n = a.tf_n;
  const bool shared = need_tf && a.tf_shared;
  if (shared)
    for (int i = threadIdx.x; i < 5 * n; i += blockDim.x) tfg[i] = 0.0f;
  __syncthreads();
  const float4* tf_col = reinterpret_cast<const float4*>(a.tf_col);

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

  int run = -2;  // the segment whose contributions acc holds (-2: none)
  float acc[10];
  for (int e = 0; e < 10; ++e) acc[e] = 0.0f;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  float trans = 1.0f;
  for (int k = 0; k < a.n_planes; ++k) {
    const Sample s = sample_plane(a, k, ob, oc, uu, vv);
    const TfSample t = tf_sample(a.tf_pos, tf_col, n, s.field);
    const float tau = ((t.rgba[3] * a.sbi) * dl) * s.mask;
    const float seg = expf(-tau);
    const float wgt = trans * (1.0f - seg);
    float emit[3], g_tau = g_final;
    for (int ch = 0; ch < 3; ++ch) {
      emit[ch] = t.rgba[ch] * (s.light[ch] + a.ambient);
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
      g_light[ch] = g_emit * t.rgba[ch];
    }
    g_rgba[3] = ((g_tau * s.mask) * dl) * a.sbi;

    // The transfer function's adjoint (autograd's subgradients of the
    // plain form: the where chain, clip's halved ties, the width clamp),
    // summed over the run of planes that share a segment. A thread past
    // the last column sums too, and adds nothing.
    if (t.sel != run) {
      if (live && need_tf) tf_flush(a, shared, tfg, run, acc);
      run = t.sel;
      for (int e = 0; e < 10; ++e) acc[e] = 0.0f;
    }
    float g_x = 0.0f;
    if (t.sel < 0) {
      for (int ch = 0; ch < 4; ++ch) acc[ch] += g_rgba[ch];
    } else {
      for (int ch = 0; ch < 4; ++ch) {
        const float gt = g_rgba[ch] * t.t_clip;
        acc[ch] += g_rgba[ch] - gt;
        acc[4 + ch] += gt;
      }
      float g_t = 0.0f;
      for (int ch = 0; ch < 4; ++ch) g_t += g_rgba[ch] * t.dcol[ch];
      const float tr = t.t_raw;
      const float dclip = (tr > 0.0f && tr < 1.0f) ? 1.0f
                          : (tr == 0.0f || tr == 1.0f) ? 0.5f : 0.0f;
      const float g_raw = g_t * dclip;
      const float w = fmaxf(t.diff, 1e-12f);
      g_x = g_raw / w;
      const float g_w = t.diff >= 1e-12f
          ? -g_raw * (s.field - t.p0) / (w * w) : 0.0f;
      acc[8] += -g_x - g_w;
      acc[9] += g_w;
    }
    if (!live) g_x = 0.0f;

    // The volume: the field's cotangent through the taps and the lerp.
    if (a.g_vol != nullptr && __any_sync(kFull, g_x != 0.0f)) {
      const float wr[2] = {s.hc.w0, s.hc.w1};
      const int ir[2] = {s.hc.i0, s.hc.i1};
      const float wc[2] = {s.hb.w0, s.hb.w1};
      const int ic[2] = {s.hb.i0, s.hb.i1};
      for (int r = 0; r < 2; ++r)
        for (int cc = 0; cc < 2; ++cc) {
          const float gv = (g_x * wr[r]) * wc[cc];
          const long long at = (long long)ir[r] * a.nb + ic[cc];
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
        for (int cc = 0; cc < 2; ++cc) {
          const float wrc = wr[r] * wc[cc];
          float v0[3], v1[3];
          bool any = false;
          for (int ch = 0; ch < 3; ++ch) {
            const float gl = g_light[ch] * wrc;
            v0[ch] = (1.0f - s.lfz) * gl;
            v1[ch] = s.lfz * gl;
            any = any || gl != 0.0f;
          }
          const long long at = (long long)ir[r] * a.nb2 + ic[cc];
          const bool on = live && any;
          warp_add(a.g_light, on ? s.l0 / 3 + at : -1, v0);
          warp_add(a.g_light, on ? s.l1 / 3 + at : -1, v1);
        }
    }
  }

  if (!need_tf) return;
  if (live) tf_flush(a, shared, tfg, run, acc);
  if (!shared) return;
  __syncthreads();
  for (int e = threadIdx.x; e < 5 * n; e += blockDim.x) {
    const float sum = tfg[e];
    if (sum == 0.0f) continue;
    if (e < n) {
      if (a.g_pos != nullptr) atomicAdd(a.g_pos + e, sum);
    } else if (a.g_col != nullptr) {
      atomicAdd(a.g_col + (e - n), sum);
    }
  }
}

}  // namespace

extern "C" int cpm_sweep_planes(const ScanArgs* args, void* stream) {
  const ScanArgs a = *args;
  const int cs = a.k_hi - a.k_lo;
  const int n_items =
      max(max(a.nc * a.nb, a.nc2 * a.nb2), max(a.n_u, a.n_v));
  if (cs <= 0 || n_items <= 0) return 0;
  const dim3 grid(min((n_items + kPrepBlock - 1) / kPrepBlock, 1024),
                  min(cs, kMaxGridY));
  sweep_planes_kernel<<<grid, kPrepBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

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
  const size_t smem = need_tf && a.tf_shared ? sizeof(float) * 5 * a.tf_n : 0;
  sweep_scan_grad_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
