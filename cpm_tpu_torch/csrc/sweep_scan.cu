// The shear-warp sweep's plane scan: every intermediate ray marched front
// to back over every plane, classified through the transfer function, lit
// from the light volume and composited. The forward is two kernels a chunk
// of planes: a plane pre-pass (sweep_planes_kernel) and a lean per-ray
// march (sweep_scan_kernel). The backward is three a chunk: the same
// pre-pass, a gradient march (sweep_scan_grad_kernel) that marches each ray
// again over the prepared planes into per-plane gradient planes, and a
// fold (sweep_fold_kernel) that takes those through the slab lerps into
// the gradients of the volume and the light volume; the gradient march
// also yields the transfer function's positions and colours.
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
// The backward's design. Its pre-pass is the forward's, which also zeroes
// the chunk's gradient planes, laid out as the prepared ones (the volume's
// (cs, nc, nb), the light's (cs, nc2, nb2, 4)); at the default frame the
// chunk's prepared and gradient planes take 24.1 + 17.0 MB, in the L2.
// The gradient march reads each sample through fetch_plane, the function
// the march composites, so the recurrence's C - C<=k meets the forward's
// bits by construction; each ray's colour and transmittance go from chunk
// to chunk through a (V, U, 4) carry where there is more than one chunk.
// Its scatter is one segmented warp reduction a grid and sample: a block
// is one row, so the row taps and weights are the block's and only the
// column differs from lane to lane; each lane's cotangent times its two
// column weights (2 values for the volume, 6 for the light's three
// channels) is summed over the run of lanes that share the first column
// tap (the taps rise with the lane, so runs are long), and the run's first
// lane adds the sums times the two row weights into the four texels of
// the gradient plane: scalar atomics for the volume, sm_90's float4
// atomic for the light. A clamped second tap adds nothing. The fold, one
// thread a texel of a slab, adds the planes that read that slab, (1 - fz)
// of each plane whose first slab it is and then fz of each whose second,
// in the planes' order: a gather, so no atomic adds into the gradients
// and the result is its plain version's (two index_add_ calls) bit for
// bit. The transfer function's gradient (5 P entries) is summed in
// registers over the run of planes that share a segment, and each run is
// added into one table a block (shared memory, where 5 P floats fit under
// TF_SHARED_BYTES) or into the gradient itself (global atomics) where
// they do not; a block's table goes to the gradient once.
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
// What bounds them now (counted by scripts/sass_counts.py from
// cuobjdump -sass of the built library, registers from -Xptxas -v; static
// counts of the plane loop's body, both sides of each branch): the
// march's plane loop holds 307 instructions, 20 of them a pass of the
// transfer function's compare loop (four points a pass), at 54 registers;
// the first design's held 754, 86 of them a loop over every segment with
// its division. At the default frame (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py, scripts/ab_sweep_grad.py) the march takes 0.75 ms and
// the pre-pass 0.02 ms at 4 points, against the first design's 1.73 ms:
// instruction issue, at roughly the static count a sample. The compare
// loop is linear in the points: the march takes 0.98 ms at 17, 1.76 at 64
// and 4.94 at 256. The gradient march's plane loop holds 1,061
// instructions at 64 registers under __launch_bounds__(128, 8) (32 bytes
// of spills; at 6 blocks an SM, 80 registers and none, it ran 7% slower),
// about 300 of them the rarely taken flush of the transfer function's run
// sums; the first backward, which sampled the raw volumes and made 16
// warp reductions a sample, held 1,974 at 80. The backward takes 1.52 ms
// (pre-pass 0.021, gradient march 1.47, fold 0.030) against the first
// design's 3.60 ms, 1.85 at 17 points, 2.86 at 64 and 6.14 at 256.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;      // threads of a march block: rays of one row
constexpr int kPrepBlock = 256;  // threads of a pre-pass block
constexpr int kFoldBlock = 256;  // threads of a fold block: texels of a slab
// Blocks of the gradient march an SM must hold: 65,536 registers over
// 8 x 128 threads leave it 64 a thread.
constexpr int kGradBlocksPerSm = 8;
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
  // The backward's gradient planes of one chunk, laid out as the prepared
  // ones (the pre-pass zeroes them, the gradient march adds into them,
  // the fold adds them into the slabs), null where that gradient is not
  // asked for; and each ray's colour and transmittance between chunks.
  float* g_p_vol;            // (cs, nc, nb)
  float* g_p_light;          // (cs, nc2, nb2, 4), channel 3 unused
  float* carry;              // (V, U, 4), or null for one chunk
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
    float* gv = a.g_p_vol == nullptr ? nullptr : a.g_p_vol + kl * n_vol;
    float4* gl = a.g_p_light == nullptr
        ? nullptr : reinterpret_cast<float4*>(a.g_p_light) + kl * n_light;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
         i += gridDim.x * blockDim.x) {
      if (i < n_vol) {
        pv[i] = omf * s0[i] + fz * s1[i];
        if (gv != nullptr) gv[i] = 0.0f;
      }
      if (i < n_light) {
        float4 t;
        t.x = lomf * l0[3 * i] + lfz * l1[3 * i];
        t.y = lomf * l0[3 * i + 1] + lfz * l1[3 * i + 1];
        t.z = lomf * l0[3 * i + 2] + lfz * l1[3 * i + 2];
        t.w = 0.0f;
        pl[i] = t;
        if (gl != nullptr) gl[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
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

// One ray's pointers into the chunk's prepared planes (its row's entries,
// its column's, the plane's texels and counts), at the chunk's first plane;
// next() steps them to the following plane.
struct Cursor {
  const int4* row_i;
  const float4* row_w;
  const float* row_m;
  const int4* col_i;
  const float4* col_w;
  const float* col_m;
  const float* pv;
  const float4* pl;
  const int4* counts;
  int n_u, n_v, n_vol, n_light;

  __device__ __forceinline__ Cursor(const ScanArgs& a, int iu, int iv)
      : row_i(reinterpret_cast<const int4*>(a.row_i) + iv),
        row_w(reinterpret_cast<const float4*>(a.row_w) + iv),
        row_m(a.row_m + iv),
        col_i(reinterpret_cast<const int4*>(a.col_i) + iu),
        col_w(reinterpret_cast<const float4*>(a.col_w) + iu),
        col_m(a.col_m + iu),
        pv(a.p_vol),
        pl(reinterpret_cast<const float4*>(a.p_light)),
        counts(reinterpret_cast<const int4*>(a.counts)),
        n_u(a.n_u), n_v(a.n_v), n_vol(a.nc * a.nb),
        n_light(a.nc2 * a.nb2) {}

  __device__ __forceinline__ void next() {
    row_i += n_v;
    row_w += n_v;
    row_m += n_v;
    col_i += n_u;
    col_w += n_u;
    col_m += n_u;
    pv += n_vol;
    pl += n_light;
    ++counts;
  }
};

// One ray's fetch of the cursor's plane: its row's and column's taps and
// weights, its mask, the volume's value and the light's three channels.
// The march composites it and the gradient march differentiates it, so
// both see the same bits by construction.
struct Fetch {
  int4 ri, ci;    // row taps (times the row length) and column taps
  float4 rw, cw;  // their weights: volume 0, 1, then light 0, 1
  float mask, field;
  float light[3];
};

__device__ __forceinline__ Fetch fetch_plane(const Cursor& c) {
  Fetch s;
  s.ri = __ldg(c.row_i);
  s.ci = __ldg(c.col_i);
  s.rw = __ldg(c.row_w);
  s.cw = __ldg(c.col_w);
  s.mask = __ldg(c.row_m) * __ldg(c.col_m);
  const int4 bad = __ldg(c.counts);
  const int4 ri = s.ri, ci = s.ci;
  const float4 rw = s.rw, cw = s.cw;

  // The volume: four lerped texels.
  const float* pv = c.pv;
  const bool one_r = ri.y == ri.x, one_c = ci.y == ci.x;
  const float a00 = __ldg(pv + (ri.x + ci.x));
  const float a10 = one_r ? 0.0f : __ldg(pv + (ri.y + ci.x));
  const float a01 = one_c ? 0.0f : __ldg(pv + (ri.x + ci.y));
  const float a11 = one_r || one_c ? 0.0f : __ldg(pv + (ri.y + ci.y));
  s.field = tap_value(a00, a10, a01, a11, one_r, one_c, rw.x, rw.y, cw.x,
                      cw.y);

  // The light volume: four float4 texels, three channels.
  const float4* pl = c.pl;
  const bool one_r2 = ri.w == ri.z, one_c2 = ci.w == ci.z;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 b00 = __ldg(pl + (ri.z + ci.z));
  const float4 b10 = one_r2 ? zero : __ldg(pl + (ri.w + ci.z));
  const float4 b01 = one_c2 ? zero : __ldg(pl + (ri.z + ci.w));
  const float4 b11 = one_r2 || one_c2 ? zero : __ldg(pl + (ri.w + ci.w));
  s.light[0] = tap_value(b00.x, b10.x, b01.x, b11.x, one_r2, one_c2, rw.z,
                         rw.w, cw.z, cw.w);
  s.light[1] = tap_value(b00.y, b10.y, b01.y, b11.y, one_r2, one_c2, rw.z,
                         rw.w, cw.z, cw.w);
  s.light[2] = tap_value(b00.z, b10.z, b01.z, b11.z, one_r2, one_c2, rw.z,
                         rw.w, cw.z, cw.w);
  if ((bad.x | bad.y | bad.z | bad.w) != 0) {  // a plane with inf or NaN
    s.field = nan_rule(s.field, a00, a10, a01, a11, bad.x);
    s.light[0] = nan_rule(s.light[0], b00.x, b10.x, b01.x, b11.x, bad.y);
    s.light[1] = nan_rule(s.light[1], b00.y, b10.y, b01.y, b11.y, bad.z);
    s.light[2] = nan_rule(s.light[2], b00.z, b10.z, b01.z, b11.z, bad.w);
  }
  return s;
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
  const float4* tf_col = reinterpret_cast<const float4*>(a.tf_col);

  Cursor cur(a, iu, iv);
  for (int kl = 0; kl < a.k_hi - a.k_lo; ++kl, cur.next()) {
    const Fetch s = fetch_plane(cur);
    const TfSample t = tf_sample(a.tf_pos, tf_col, a.tf_n, s.field);
    const float tau = ((t.rgba[3] * a.sbi) * dl) * s.mask;
    const float seg = expf(-tau);
    const float wgt = trans * (1.0f - seg);
    for (int ch = 0; ch < 3; ++ch)
      rgb[ch] = rgb[ch] + wgt * (t.rgba[ch] * (s.light[ch] + a.ambient));
    trans = trans * seg;
  }
  *out = make_float4(rgb[0], rgb[1], rgb[2], a.last ? 1.0f - trans : trans);
}

// --- the backward: gradient march and fold ------------------------------

// Sums val over each run of neighbouring lanes of the warp that share
// ``tap`` (a segmented reduction); true in the run's first lane, which
// holds the run's sums. Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ bool run_sums(int tap, float (&val)[N]) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, tap, 1);
  const bool head = lane == 0 || prev != tap;
  const unsigned heads = __ballot_sync(kFull, head);
  const unsigned after = heads & ~((2u << lane) - 1u);
  const int end = after ? __ffs(after) - 1 : 32;
  for (int off = 1; off < 32; off <<= 1)
    for (int j = 0; j < N; ++j) {
      const float o = __shfl_down_sync(kFull, val[j], off);
      if (lane + off < end) val[j] += o;
    }
  return head;
}

__device__ __forceinline__ void add_to(float* p, float val) {
  if (val != 0.0f) atomicAdd(p, val);
}

// sm_90's vector atomic for global memory (red.global.add.v4.f32); the
// pad channel adds 0.
__device__ __forceinline__ void add_to(float4* p, float x, float y,
                                       float z) {
  if (x != 0.0f || y != 0.0f || z != 0.0f)
    atomicAdd(p, make_float4(x, y, z, 0.0f));
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

// The gradient march: one thread a ray over the chunk's prepared planes,
// the fetches of fetch_plane, the closed-form recurrence with the
// colour and transmittance carried from chunk to chunk in ``carry``.
// Every thread of a block runs every plane, a thread past the last column
// with a cotangent of zero, so that the warp reductions see whole warps.
// A block is 128 rays of one row, so the row taps and weights are the
// block's; per grid, each lane's cotangent times its two column weights
// is summed over the run of lanes that share the first column tap, and
// the run's first lane adds those sums times the two row weights into the
// four texels of the chunk's gradient plane. Dynamic shared memory: the
// 5 tf_n floats of the transfer function's gradient table when it is asked
// for and tf_shared.
__global__ void __launch_bounds__(kBlock, kGradBlocksPerSm)
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
  const int ray = iv * a.n_u + iu;
  const float dl = a.dl[ray];

  const float4 go = live ? reinterpret_cast<const float4*>(a.grad_out)[ray]
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 fin = reinterpret_cast<const float4*>(a.out)[ray];
  const float g[3] = {go.x, go.y, go.z};
  const float big_c[3] = {fin.x, fin.y, fin.z};
  const float g_final = go.w * (1.0f - fin.w);
  const float4 carry = a.first || !live
      ? make_float4(0.0f, 0.0f, 0.0f, 1.0f)
      : reinterpret_cast<const float4*>(a.carry)[ray];
  float rgb[3] = {carry.x, carry.y, carry.z};
  float trans = carry.w;

  int run = -2;  // the segment whose contributions acc holds (-2: none)
  float acc[10];
  for (int e = 0; e < 10; ++e) acc[e] = 0.0f;
  const int n_vol = a.nc * a.nb, n_light = a.nc2 * a.nb2;
  const bool want_vol = a.g_p_vol != nullptr;
  const bool want_light = a.g_p_light != nullptr;
  Cursor cur(a, iu, iv);
  int at_vol = 0, at_light = 0;  // the plane's gradient planes
  for (int kl = 0; kl < a.k_hi - a.k_lo;
       ++kl, cur.next(), at_vol += n_vol, at_light += n_light) {
    const Fetch s = fetch_plane(cur);
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
      g_light[ch] = live ? g_emit * t.rgba[ch] : 0.0f;
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
      const float inv_w = 1.0f / w;
      g_x = g_raw * inv_w;
      const float g_w = t.diff >= 1e-12f
          ? (-g_x * (s.field - t.p0)) * inv_w : 0.0f;
      acc[8] += -g_x - g_w;
      acc[9] += g_w;
    }
    if (!live) g_x = 0.0f;

    // The volume: the field's cotangent through the taps, into the
    // chunk's gradient plane (the fold takes it through the slab lerp).
    if (want_vol && __any_sync(kFull, g_x != 0.0f)) {
      float sum[2] = {g_x * s.cw.x, g_x * s.cw.y};
      if (run_sums(s.ci.x, sum)) {
        float* gp = a.g_p_vol + at_vol;
        const bool one_r = s.ri.y == s.ri.x, one_c = s.ci.y == s.ci.x;
        add_to(gp + (s.ri.x + s.ci.x), s.rw.x * sum[0]);
        if (!one_r) add_to(gp + (s.ri.y + s.ci.x), s.rw.y * sum[0]);
        if (!one_c) {
          add_to(gp + (s.ri.x + s.ci.y), s.rw.x * sum[1]);
          if (!one_r) add_to(gp + (s.ri.y + s.ci.y), s.rw.y * sum[1]);
        }
      }
    }
    // The light volume: the same for its three channels on its grid.
    if (want_light &&
        __any_sync(kFull, g_light[0] != 0.0f || g_light[1] != 0.0f ||
                              g_light[2] != 0.0f)) {
      float sum[6];
      for (int ch = 0; ch < 3; ++ch) {
        sum[ch] = g_light[ch] * s.cw.z;
        sum[3 + ch] = g_light[ch] * s.cw.w;
      }
      if (run_sums(s.ci.z, sum)) {
        float4* gp = reinterpret_cast<float4*>(a.g_p_light) + at_light;
        const bool one_r = s.ri.w == s.ri.z, one_c = s.ci.w == s.ci.z;
        const float r0 = s.rw.z, r1 = s.rw.w;
        add_to(gp + (s.ri.z + s.ci.z), r0 * sum[0], r0 * sum[1], r0 * sum[2]);
        if (!one_r)
          add_to(gp + (s.ri.w + s.ci.z), r1 * sum[0], r1 * sum[1],
                 r1 * sum[2]);
        if (!one_c) {
          add_to(gp + (s.ri.z + s.ci.w), r0 * sum[3], r0 * sum[4],
                 r0 * sum[5]);
          if (!one_r)
            add_to(gp + (s.ri.w + s.ci.w), r1 * sum[3], r1 * sum[4],
                   r1 * sum[5]);
        }
      }
    }
  }
  if (!a.last && live)
    reinterpret_cast<float4*>(a.carry)[ray] =
        make_float4(rgb[0], rgb[1], rgb[2], trans);

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

// The fold, one launch a chunk after its gradient march: the chunk's
// gradient planes through the slab lerps, g[k0[k]] += (1 - fz[k]) g_p[k]
// and g[k1[k]] += fz[k] g_p[k], as a gather. blockIdx.y walks the slabs
// of the volume (the first na) and of the light volume, the block's
// threads the texels of its slab; a block finds the chunk's first and
// last planes that read its slab as k0 and as k1, and each thread adds,
// in order, the planes between that do (every k0 plane, then every k1
// plane: index_add_'s order). So every texel is written by one thread and
// no atomic adds into the gradients.
__global__ void __launch_bounds__(kFoldBlock)
sweep_fold_kernel(const ScanArgs a) {
  __shared__ int span[4];  // first and last plane reading the slab as k0, k1
  const bool light = blockIdx.y >= a.na;
  if ((light ? a.g_p_light : a.g_p_vol) == nullptr) return;
  const int slab = light ? blockIdx.y - a.na : blockIdx.y;
  const int cs = a.k_hi - a.k_lo;
  const long long* k0 = (light ? a.lk0 : a.k0) + a.k_lo;
  const long long* k1 = (light ? a.lk1 : a.k1) + a.k_lo;
  const float* fz = (light ? a.lfz : a.fz) + a.k_lo;
  if (threadIdx.x < 4) span[threadIdx.x] = threadIdx.x & 1 ? -1 : cs;
  __syncthreads();
  for (int kl = threadIdx.x; kl < cs; kl += blockDim.x) {
    if (k0[kl] == slab) {
      atomicMin(span, kl);
      atomicMax(span + 1, kl);
    }
    if (k1[kl] == slab) {
      atomicMin(span + 2, kl);
      atomicMax(span + 3, kl);
    }
  }
  __syncthreads();
  const int lo0 = span[0], hi0 = span[1], lo1 = span[2], hi1 = span[3];
  if (hi0 < 0 && hi1 < 0) return;
  const int texels = light ? a.nc2 * a.nb2 : a.nc * a.nb;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < texels;
       i += gridDim.x * blockDim.x) {
    if (!light) {
      float* g = a.g_vol + (long long)slab * texels + i;
      float sum = *g;
      for (int kl = lo0; kl <= hi0; ++kl)
        if (k0[kl] == slab)
          sum = sum + (1.0f - fz[kl]) * a.g_p_vol[kl * texels + i];
      for (int kl = lo1; kl <= hi1; ++kl)
        if (k1[kl] == slab) sum = sum + fz[kl] * a.g_p_vol[kl * texels + i];
      *g = sum;
    } else {
      const float4* gp = reinterpret_cast<const float4*>(a.g_p_light) + i;
      float* g = a.g_light + ((long long)slab * texels + i) * 3;
      float sum[3] = {g[0], g[1], g[2]};
      for (int kl = lo0; kl <= hi0; ++kl)
        if (k0[kl] == slab) {
          const float w = 1.0f - fz[kl];
          const float4 t = gp[kl * texels];
          sum[0] = sum[0] + w * t.x;
          sum[1] = sum[1] + w * t.y;
          sum[2] = sum[2] + w * t.z;
        }
      for (int kl = lo1; kl <= hi1; ++kl)
        if (k1[kl] == slab) {
          const float w = fz[kl];
          const float4 t = gp[kl * texels];
          sum[0] = sum[0] + w * t.x;
          sum[1] = sum[1] + w * t.y;
          sum[2] = sum[2] + w * t.z;
        }
      for (int ch = 0; ch < 3; ++ch) g[ch] = sum[ch];
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

extern "C" int cpm_sweep_fold(const ScanArgs* args, void* stream) {
  const ScanArgs a = *args;
  const int texels = max(a.nc * a.nb, a.nc2 * a.nb2);
  if (a.k_hi <= a.k_lo || texels <= 0) return 0;
  if (a.na + a.na2 > kMaxGridY) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(min((texels + kFoldBlock - 1) / kFoldBlock, 1024),
                  a.na + a.na2);
  sweep_fold_kernel<<<grid, kFoldBlock, 0, (cudaStream_t)stream>>>(a);
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
