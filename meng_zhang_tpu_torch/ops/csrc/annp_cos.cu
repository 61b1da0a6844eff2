// Cos-matrix ANNP kernels for Hopper (sm_90a), plain C interface.
//
// g_cos replaces the TPU kernel `_g_kernel` (meng_zhang_tpu/ops/
// pallas_annp.py, row body `_row_g`); force_cos replaces `_force_kernel`
// (row body `_row_force`) in the same file. Both read [P, K] displacement
// planes dx = x_i - x_j (K <= 256; filler lanes carry dx = 2 box + 10 and
// give exactly 0) and work on one atom row per thread block, one lane per
// thread:
//   g_cos      g [P, 128]: radial G_m = sum_j T_m(2r/rc - 1) fc_j in cols
//              [0, npsf), angular G_n = 1/2 sum_{j != k} T_n((cos_jk + 1)/2)
//              fc_j fc_k in cols npsf + n, rest 0;
//   force_cos  per-pair Fj = -dE_i/dx_j [P, K] x3 from dedg [P, 128] = dE/dG
//              already multiplied by sf_scale * e_scale.
//
// What bounds them on this card: the TPU kernels build the row's [K, K] cos
// matrix and run the ntsf-term Chebyshev recurrence over every entry. Here
// only pairs of lanes inside the cutoff are visited (~112 of 128 on the fe
// scene): g_cos visits each unordered pair once (~6.2e3 a row, ~90 FLOPs
// each), force_cos each ordered pair (~1.2e4 a row, ~200 FLOPs each, for
// the T_n and T'_n recurrences), against 12 bytes of dx read per lane, so
// both are compute bound. The design keeps everything in registers and
// shared memory: each thread computes its lane's geometry once, the lanes
// inside the cutoff are compacted into shared memory (a warp ballot and a
// prefix count across warps), and the per-function accumulators (g_cos) and
// dE/dG weights (force_cos) sit in registers, indexed by a loop unrolled
// over the compile-time bound kMaxT with a runtime guard. g_cos splits the
// triangular j < k loop evenly: thread j takes k = j + 1 .. j + n/2
// (mod n), so every unordered pair is visited once and every thread sums
// <= n/2 terms before the warp-shuffle and cross-warp reduction. force_cos
// keeps the TPU kernel's no-reduction design: thread j loops over every
// active k != j, accumulates the column sums of the A and B matrices
// (sac, sau, sb) and writes its own lane; the delivery stays outside.
#include "pair_geometry.cuh"

namespace {

using annp::block_threads;
using annp::Pair;
using annp::pair_geometry;
using annp::radial_coeff;
using annp::warp_sum;

constexpr int kNsfPad = 128;        // g / dedg row width
constexpr int kMaxK = 256;          // lanes: one thread each, <= 8 warps
constexpr int kMaxWarps = kMaxK / 32;
constexpr int kMaxT = 32;           // angular functions (ntsf)
constexpr unsigned kFull = 0xffffffffu;

// Lanes inside the cutoff, compacted to the front of shared memory in lane
// order. Every thread of the block calls it; returns the number of active
// lanes and sets *slot to this thread's compacted index (-1 if inactive).
template <typename T>
__device__ __forceinline__ int compact_active(const Pair<T>& p, T* sx, T* sy,
                                              T* sz, T* sfc, int* wcount,
                                              int* slot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool act = p.m != T(0);
  const unsigned bal = __ballot_sync(kFull, act);
  if (lane == 0) wcount[warp] = __popc(bal);
  __syncthreads();
  int base = 0, n_act = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < warp) base += wcount[w];
    n_act += wcount[w];
  }
  *slot = -1;
  if (act) {
    const int s = base + __popc(bal & ((1u << lane) - 1u));
    sx[s] = p.ux;
    sy[s] = p.uy;
    sz[s] = p.uz;
    sfc[s] = p.fc;
    *slot = s;
  }
  __syncthreads();
  return n_act;
}

template <typename T>
__global__ void __launch_bounds__(kMaxK)
g_cos_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
             const T* __restrict__ dxz, T* __restrict__ g_out, int k,
             int npsf, int ntsf, double rc) {
  __shared__ T sx[kMaxK], sy[kMaxK], sz[kMaxK], sfc[kMaxK];
  __shared__ T part[kMaxWarps][kNsfPad];   // per-warp column sums
  __shared__ int wcount[kMaxWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = blockIdx.x;

  T x = T(0), y = T(0), z = T(0);         // lanes >= k: rsq 0, masked
  if (tid < k) {
    const long long o = row * k + tid;
    x = dxx[o];
    y = dxy[o];
    z = dxz[o];
  }
  const Pair<T> p = pair_geometry(x, y, z, rc);

  // radial G_m = sum_j T_m(2r/rc - 1) fc_j
  const T xch = T(2) * p.r / T(rc) - T(1);
  T tp = p.m, tc = xch * p.m;
  T v = warp_sum(tp * p.fc);
  if (lane == 0) part[warp][0] = v;
  v = warp_sum(tc * p.fc);
  if (lane == 0) part[warp][1] = v;
  for (int n = 2; n < npsf; ++n) {
    const T tn = T(2) * xch * tc - tp;
    tp = tc;
    tc = tn;
    v = warp_sum(tc * p.fc);
    if (lane == 0) part[warp][n] = v;
  }

  int slot;
  const int n_act = compact_active(p, sx, sy, sz, sfc, wcount, &slot);

  // angular: sum_{j<k} T_n(x_jk) fc_j fc_k, thread j taking k = j + d
  // (mod n_act), d = 1 .. n_act/2 (d = n_act/2 only for j < n_act/2 when
  // n_act is even, so that each unordered pair is visited once)
  T acc[kMaxT];
#pragma unroll
  for (int n = 0; n < kMaxT; ++n) acc[n] = T(0);
  if (tid < n_act) {
    const T ujx = sx[tid], ujy = sy[tid], ujz = sz[tid], fcj = sfc[tid];
    const int nd = (n_act - 1) / 2 + ((n_act % 2 == 0 && tid < n_act / 2));
    int kk = tid;
    for (int d = 0; d < nd; ++d) {
      kk = (kk + 1 == n_act) ? 0 : kk + 1;
      const T cs = ujx * sx[kk] + ujy * sy[kk] + ujz * sz[kk];
      const T xa = T(0.5) * (cs + T(1));
      const T x2 = xa + xa;
      const T w = fcj * sfc[kk];
      T t0 = T(1), t1 = xa;
      acc[0] += w;
#pragma unroll
      for (int n = 1; n < kMaxT; ++n) {
        if (n < ntsf) {
          if (n >= 2) {
            const T t2 = x2 * t1 - t0;
            t0 = t1;
            t1 = t2;
          }
          acc[n] += w * t1;
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kMaxT; ++n) {
    if (n < ntsf) {
      v = warp_sum(acc[n]);
      if (lane == 0) part[warp][npsf + n] = v;
    }
  }
  __syncthreads();

  T* g_row = g_out + row * kNsfPad;
  const int nwarps = blockDim.x >> 5;
  for (int c = tid; c < kNsfPad; c += blockDim.x) {
    T s = T(0);
    if (c < npsf + ntsf)
      for (int w = 0; w < nwarps; ++w) s += part[w][c];
    g_row[c] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxK)
force_cos_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
                 const T* __restrict__ dxz, const T* __restrict__ dedg,
                 T* __restrict__ fjx, T* __restrict__ fjy,
                 T* __restrict__ fjz, int k, int npsf, int ntsf,
                 double rc) {
  __shared__ T sx[kMaxK], sy[kMaxK], sz[kMaxK], sfc[kMaxK];
  __shared__ T wsh[kNsfPad];
  __shared__ int wcount[kMaxWarps];
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  for (int c = tid; c < npsf + ntsf; c += blockDim.x)
    wsh[c] = dedg[row * kNsfPad + c];

  const long long o = row * k + tid;
  T x = T(0), y = T(0), z = T(0);
  if (tid < k) {
    x = dxx[o];
    y = dxy[o];
    z = dxz[o];
  }
  const Pair<T> p = pair_geometry(x, y, z, rc);
  int slot;
  const int n_act = compact_active(p, sx, sy, sz, sfc, wcount, &slot);
  if (tid >= k) return;

  // radial: coeff = sum_n w_n (T'_n (2/rc) fc + T_n dfc); Fj += coeff u
  const T coeff = radial_coeff(p, wsh, npsf, rc);

  // angular dE/dG weights in registers
  T wa[kMaxT];
#pragma unroll
  for (int n = 0; n < kMaxT; ++n) wa[n] = n < ntsf ? wsh[npsf + n] : T(0);

  // column sums over k of A[k,j] = 1/4 fc_k fc_j P'(x_kj) (times cos and
  // u_k) and B[k,j] = fc_k dfc_j P(x_kj), P = sum_n w_n T_n, with the
  // factors of lane j taken out of the sums
  T sac = T(0), sax = T(0), say = T(0), saz = T(0), sbp = T(0);
  if (slot >= 0) {
    for (int kk = 0; kk < n_act; ++kk) {
      if (kk == slot) continue;             // the diagonal, by index
      const T ukx = sx[kk], uky = sy[kk], ukz = sz[kk], fck = sfc[kk];
      const T cs = p.ux * ukx + p.uy * uky + p.uz * ukz;
      const T xa = T(0.5) * (cs + T(1));
      const T x2 = xa + xa;
      // T_0 = 1, T_1 = x; T'_0 = 0, T'_1 = 1
      T t0 = T(1), t1 = xa, d0 = T(0), d1 = T(1);
      T ps = wa[0], dps = T(0);
#pragma unroll
      for (int n = 1; n < kMaxT; ++n) {
        if (n < ntsf) {
          if (n >= 2) {
            const T t2 = x2 * t1 - t0;
            const T d2 = T(2) * t1 + x2 * d1 - d0;
            t0 = t1;
            t1 = t2;
            d0 = d1;
            d1 = d2;
          }
          ps += wa[n] * t1;
          dps += wa[n] * d1;
        }
      }
      const T a = fck * dps;
      sac += a * cs;
      sax += a * ukx;
      say += a * uky;
      saz += a * ukz;
      sbp += fck * ps;
    }
  }
  const T aj = T(0.25) * p.fc;
  sac *= aj;
  sax *= aj;
  say *= aj;
  saz *= aj;
  const T sb = p.dfc * sbp;
  // dG_ang/dx_j = 2A (cos u_j - u_k)/r_j - B u_j; Fj -= dG/dx_j
  const T two_ir = T(2) * p.inv_r;
  fjx[o] = (coeff * p.ux - ((sac * p.ux - sax) * two_ir - sb * p.ux)) * p.m;
  fjy[o] = (coeff * p.uy - ((sac * p.uy - say) * two_ir - sb * p.uy)) * p.m;
  fjz[o] = (coeff * p.uz - ((sac * p.uz - saz) * two_ir - sb * p.uz)) * p.m;
}

template <typename T>
int launch_g(const void* dxx, const void* dxy, const void* dxz, void* g,
             long long p, int k, int npsf, int ntsf, double rc,
             void* stream) {
  if (p > 0)
    g_cos_kernel<T><<<(unsigned)p, block_threads(k), 0,
                      (cudaStream_t)stream>>>(
        (const T*)dxx, (const T*)dxy, (const T*)dxz, (T*)g, k, npsf, ntsf,
        rc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_force(const void* dxx, const void* dxy, const void* dxz,
                 const void* dedg, void* fjx, void* fjy, void* fjz,
                 long long p, int k, int npsf, int ntsf, double rc,
                 void* stream) {
  if (p > 0)
    force_cos_kernel<T><<<(unsigned)p, block_threads(k), 0,
                          (cudaStream_t)stream>>>(
        (const T*)dxx, (const T*)dxy, (const T*)dxz, (const T*)dedg,
        (T*)fjx, (T*)fjy, (T*)fjz, k, npsf, ntsf, rc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int annp_g_cos_f32(const void* dxx, const void* dxy, const void* dxz, void* g,
                   long long p, int k, int npsf, int ntsf, double rc,
                   void* stream) {
  return launch_g<float>(dxx, dxy, dxz, g, p, k, npsf, ntsf, rc, stream);
}

int annp_g_cos_f64(const void* dxx, const void* dxy, const void* dxz, void* g,
                   long long p, int k, int npsf, int ntsf, double rc,
                   void* stream) {
  return launch_g<double>(dxx, dxy, dxz, g, p, k, npsf, ntsf, rc, stream);
}

int annp_force_cos_f32(const void* dxx, const void* dxy, const void* dxz,
                       const void* dedg, void* fjx, void* fjy, void* fjz,
                       long long p, int k, int npsf, int ntsf, double rc,
                       void* stream) {
  return launch_force<float>(dxx, dxy, dxz, dedg, fjx, fjy, fjz, p, k, npsf,
                             ntsf, rc, stream);
}

int annp_force_cos_f64(const void* dxx, const void* dxy, const void* dxz,
                       const void* dedg, void* fjx, void* fjy, void* fjz,
                       long long p, int k, int npsf, int ntsf, double rc,
                       void* stream) {
  return launch_force<double>(dxx, dxy, dxz, dedg, fjx, fjy, fjz, p, k, npsf,
                              ntsf, rc, stream);
}

}  // extern "C"
