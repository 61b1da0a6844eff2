// Per-pair helpers shared by the fe ANNP kernels (annp_harm.cu, annp_gcos.cu,
// annp_cos.cu).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace annp {

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dev_cos(float v) { return cosf(v); }
__device__ __forceinline__ double dev_cos(double v) { return cos(v); }
__device__ __forceinline__ float dev_sin(float v) { return sinf(v); }
__device__ __forceinline__ double dev_sin(double v) { return sin(v); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-pair geometry, as _pair_geometry: masked lanes get r = 1 before 1/r,
// so every masked quantity is exactly 0.
template <typename T>
struct Pair {
  T r, fc, dfc, inv_r, m, ux, uy, uz;
};

template <typename T>
__device__ __forceinline__ Pair<T> pair_geometry(T x, T y, T z, double rc) {
  Pair<T> p;
  const T rsq = x * x + y * y + z * z;
  const bool mask = (rsq < T(rc * rc)) && (rsq > T(1.0e-12));
  p.r = dev_sqrt(mask ? rsq : T(1));
  const T arg = T(CUDART_PI / rc) * p.r;
  p.fc = mask ? T(0.5) * (dev_cos(arg) + T(1)) : T(0);
  p.dfc = mask ? T(-0.5 * CUDART_PI / rc) * dev_sin(arg) : T(0);
  p.inv_r = T(1) / p.r;
  p.m = mask ? T(1) : T(0);
  p.ux = x * p.inv_r * p.m;
  p.uy = y * p.inv_r * p.m;
  p.uz = z * p.inv_r * p.m;
  return p;
}

// Radial force coefficient sum_n w_n (T'_n (2/rc) fc + T_n dfc) of
// _row_force / _force_kernel_harm, T_n = T_n(2r/rc - 1); w in shared memory.
template <typename T>
__device__ __forceinline__ T radial_coeff(const Pair<T>& p, const T* wn,
                                          int npsf, double rc) {
  const T two_rc = T(2.0 / rc);
  const T xch = T(2) * p.r / T(rc) - T(1);
  T tp = p.m, tc = xch * p.m, dp = T(0), dc = p.m;
  T coeff = wn[0] * (tp * p.dfc);
  coeff = coeff + wn[1] * (dc * two_rc * p.fc + tc * p.dfc);
  for (int n = 2; n < npsf; ++n) {
    const T tn = T(2) * xch * tc - tp;
    const T dn = T(2) * tc + T(2) * xch * dc - dp;
    tp = tc;
    tc = tn;
    dp = dc;
    dc = dn;
    coeff = coeff + wn[n] * (dc * two_rc * p.fc + tc * p.dfc);
  }
  return coeff;
}

inline int block_threads(int k) { return ((k + 31) / 32) * 32; }

}  // namespace annp
