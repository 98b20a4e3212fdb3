// Product-Epanechnikov photon splat for NVIDIA Hopper (sm_90a).
//
// Replaces cpm_tpu/pallas/splat_mxu.py:_splat_kernel (launched by
// splat_product_pallas). Both compute
//
//   light[z, y, x, c] = sum_p Kz[p, z] * Ky[p, y] * Kx[p, x] * P[p, c],
//   K(d) = max(0.75 * (1 - d^2), 0),  d = (centre - p) / r,
//
// with voxel centres at (i + 0.5) / n and powers P that already carry the
// irradiance scale and the validity mask.
//
// Why it scatters instead of contracting: the TPU kernel runs the sum as a
// dense matrix product on the MXU because a TPU has no float atomics and
// its scatter is serial. The dense product multiplies every deposit with
// every voxel, but with r * n ~ 1 each deposit touches at most
// (ceil(2 r n) + 1)^3 voxels: at the default frame (262,144 deposits into
// 65^3) about 4^3 of 274,625, so only ~2e-4 of the dense terms are nonzero.
// A GPU has fast fp32 atomics in L2, so here one thread takes one deposit,
// walks its axis windows and adds its nonzero terms.
//
// What bounds it: fp32 atomicAdd traffic into the (D, H, W, 3) grid, which
// at 65^3 x 3 x 4 B = 3.3 MB lives in the 50 MB L2; the deposit reads are
// 24 B per thread. Summation order varies between runs (atomics), so the
// result matches the plain version to rounding, not bit for bit.
//
// Each weight is rounded step by step as the plain version rounds it (the
// _rn intrinsics keep nvcc from fusing 1 - d * d into one multiply-add):
// near the edge of the support 1 - d^2 cancels most of its digits, and a
// different rounding there moves a weight by ~1e-5 of its peak.

#include <cuda_runtime.h>

namespace {

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
// clamped to [0, n - 1]; false when it is empty.
__device__ __forceinline__ bool axis_window(float p, float r, int n,
                                            int* lo, int* hi) {
  float a = fmaxf(floorf((p - r) * n - 0.5f), 0.0f);
  float b = fminf(ceilf((p + r) * n - 0.5f), (float)(n - 1));
  if (!(a <= b)) return false;
  *lo = (int)a;
  *hi = (int)b;
  return true;
}

__global__ void splat_product_kernel(const float* __restrict__ pos,
                                     const float* __restrict__ pw, int m,
                                     float r, float inv_r, int d, int h,
                                     int w, float* __restrict__ out) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)m) return;
  float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
  if (!(px < 1e30f)) return;  // unused slot (FLT_MAX sentinel)
  float p0 = pw[3 * i], p1 = pw[3 * i + 1], p2 = pw[3 * i + 2];
  int x0, x1, y0, y1, z0, z1;
  if (!axis_window(px, r, w, &x0, &x1) || !axis_window(py, r, h, &y0, &y1) ||
      !axis_window(pz, r, d, &z0, &z1))
    return;
  for (int z = z0; z <= z1; ++z) {
    float kz = axis_weight(z, d, pz, inv_r);
    if (kz == 0.0f) continue;
    for (int y = y0; y <= y1; ++y) {
      float a = kz * axis_weight(y, h, py, inv_r);
      if (a == 0.0f) continue;
      float* row = out + ((size_t)z * h + y) * w * 3;
      for (int x = x0; x <= x1; ++x) {
        float kx = axis_weight(x, w, px, inv_r);
        if (kx == 0.0f) continue;
        float* cell = row + (size_t)x * 3;
        atomicAdd(cell + 0, a * (kx * p0));
        atomicAdd(cell + 1, a * (kx * p1));
        atomicAdd(cell + 2, a * (kx * p2));
      }
    }
  }
}

}  // namespace

// Adds the splat of m deposits into out (zeroed by the caller) on the
// given stream. Returns cudaGetLastError() after the launch.
extern "C" int cpm_splat_product(const float* pos, const float* pw, int m,
                                 float r, float inv_r, int d, int h, int w,
                                 float* out, void* stream) {
  const int threads = 256;
  int blocks = (int)(((long long)m + threads - 1) / threads);
  splat_product_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pos, pw, m, r, inv_r, d, h, w, out);
  return (int)cudaGetLastError();
}
