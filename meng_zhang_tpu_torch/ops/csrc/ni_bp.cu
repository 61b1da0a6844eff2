// Behler-Parrinello (ni) ANNP kernels for Hopper (sm_90a), plain C interface.
//
// ni_g replaces the TPU kernel `_ni_g_kernel` (meng_zhang_tpu/ops/
// pallas_ni.py); ni_force replaces `_ni_force_kernel` in the same file. Both
// read [P, K] displacement planes dx = x_i - x_j (K <= 32; filler lanes
// carry dx = 2 box + 10 and give exactly 0) and work on one atom row per
// warp, one neighbor slot p per lane:
//   ni_g      g [P, 32]: radial G2 = sum_j exp(-eta r^2) fc in cols
//             [0, npsf), angular G4 = 1/2 sum_{p != q} 2^(1-zeta)
//             (1 + lambda cos)^zeta exp(-eta r2sum) fc_p fc_q fc_pq in cols
//             npsf + n, rest 0 (lengths in Bohr, r_Bohr = CFLENGTH r_A);
//   ni_force  per-pair Fj = -dE_i/dx_j [P, K] x3 from dedg [P, 32] = dE/dG
//             already multiplied by sf_scale * e_scale.
//
// What bounds them on this card: on the ni scene a row holds ~18 real
// partners, so each kernel visits ~300 (p, q) leg pairs per atom, ~8e7 per
// step at 256,000 atoms, each with a sqrt, a cos (and a sin in ni_force),
// 3 exp (one per eta group) and ~150 FLOPs for the 24 functions, against
// 12 bytes of dx read per lane: both kernels are compute bound on precise
// expf/cosf and the zeta powers. The design keeps everything in registers
// and the warp: each lane computes its own geometry once (u, r, the Bohr
// radius a, fc, dfc), the q loop broadcasts slot q's values with
// __shfl_sync and visits only the slots inside the angular cutoff (a
// ballot of in_a), a lane computes a pair's terms only where its three legs
// are inside Rc (other pairs add exact zeros in the TPU kernel), and
// exp(-eta r2sum) is computed once per eta group, not once per function.
// The per-function loop is unrolled over the compile-time bound kMaxAng,
// so the 24 accumulators of ni_g stay in registers and the table sits in
// kernel parameters (constant bank). ni_force keeps the TPU kernel's
// no-reduction design: each lane accumulates its own u_p coefficient and
// u_q-projected vector and writes its slot's Fj directly. Zeta powers go
// by repeated squaring when zeta is a power of two (all of the shipped
// table), by pow otherwise.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kNsfSub = 32;      // g / dedg row width
constexpr int kMaxRad = 8;       // radial functions
constexpr int kMaxAng = 32;      // angular functions
constexpr int kWarps = 4;        // atom rows per block
constexpr unsigned kFull = 0xffffffffu;
constexpr double kCfLength = 1.889726;    // Angstrom -> Bohr (units.py)

// The kernels' table (ops/kernels.py builds it from fused_ni.ni_table).
// Angular functions come group-major: first[f] marks the first function of
// an eta group; col[f] is the descriptor column; zlog2[f] = log2(zeta)
// when zeta is a power of two, else -1; coef[f] = 2^(1 - zeta).
template <typename T>
struct NiCfg {
  int nrad;
  int nang;
  double rc_a;
  double rad_eta[kMaxRad];
  double rad_rc[kMaxRad];
  T eta[kMaxAng];
  T lam[kMaxAng];
  T zeta[kMaxAng];
  T coef[kMaxAng];
  int col[kMaxAng];
  int zlog2[kMaxAng];
  int first[kMaxAng];
};

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dev_cos(float v) { return cosf(v); }
__device__ __forceinline__ double dev_cos(double v) { return cos(v); }
__device__ __forceinline__ float dev_sin(float v) { return sinf(v); }
__device__ __forceinline__ double dev_sin(double v) { return sin(v); }
__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_pow(float b, float e) {
  return powf(b, e);
}
__device__ __forceinline__ double dev_pow(double b, double e) {
  return pow(b, e);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// f1^zeta, and with dfz also zeta * f1^(zeta - 1), in the TPU kernel's
// product order (_pow_zeta): f^(zeta-1) = f^1 f^2 ... f^(zeta/2).
template <typename T>
__device__ __forceinline__ T pow_zeta(T f1, T zeta, int zl, T* dfz) {
  if (zl < 0) {
    if (dfz) *dfz = zeta * dev_pow(f1, zeta - T(1));
    return dev_pow(f1, zeta);
  }
  T p = f1, fzm = T(1);
  for (int s = 0; s < zl; ++s) {
    fzm = (s == 0) ? p : fzm * p;
    p = p * p;
  }
  if (dfz) *dfz = zeta * fzm;
  return p;
}

// Per-lane geometry, as _ni_geometry. Lanes at or beyond K are inactive:
// they take part in the shuffles but are masked everywhere.
template <typename T>
struct Geo {
  bool active, in_a;
  T r, inv_r, ux, uy, uz, rm, a, fc_a, dfc_a;
};

template <typename T>
__device__ __forceinline__ Geo<T> ni_geometry(const T* dxx, const T* dxy,
                                              const T* dxz, long long o,
                                              bool active, double rc_a) {
  Geo<T> g;
  g.active = active;
  T x = T(0), y = T(0), z = T(0);
  if (active) {
    x = dxx[o];
    y = dxy[o];
    z = dxz[o];
  }
  const T rsq = x * x + y * y + z * z;
  const bool valid = active && rsq > T(1.0e-12);
  g.r = dev_sqrt(valid ? rsq : T(1));
  g.inv_r = T(1) / g.r;
  const T m = valid ? T(1) : T(0);
  g.ux = x * g.inv_r * m;
  g.uy = y * g.inv_r * m;
  g.uz = z * g.inv_r * m;
  g.rm = g.r * T(kCfLength);
  g.in_a = valid && g.rm < T(rc_a);
  // masked lanes: a finite Bohr radius beyond the cutoff
  g.a = g.in_a ? g.rm : T(rc_a + 1.0);
  const T arg = T(CUDART_PI / rc_a) * g.a;
  g.fc_a = g.in_a ? T(0.5) * (dev_cos(arg) + T(1)) : T(0);
  g.dfc_a = g.in_a ? T(-0.5 * CUDART_PI / rc_a) * dev_sin(arg) : T(0);
  return g;
}

// in_r and the clamped radius of radial function mi
template <typename T>
__device__ __forceinline__ bool radial_in(const Geo<T>& g, double rc_r,
                                          T* rr) {
  const bool in_r = g.active && g.rm < T(rc_r) && g.r > T(1.0e-6);
  *rr = in_r ? g.rm : T(rc_r);
  return in_r;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ni_g_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
            const T* __restrict__ dxz, T* __restrict__ g_out, long long p,
            int k, const NiCfg<T> cfg) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p) return;            // uniform across the warp
  const Geo<T> g = ni_geometry(dxx, dxy, dxz, row * k + lane, lane < k,
                               cfg.rc_a);
  T* g_row = g_out + row * kNsfSub;
  if (lane >= cfg.nrad + cfg.nang) g_row[lane] = T(0);

  // radial G2
#pragma unroll
  for (int mi = 0; mi < kMaxRad; ++mi) {
    if (mi < cfg.nrad) {
      const double rc_r = cfg.rad_rc[mi];
      T rr;
      const bool in_r = radial_in(g, rc_r, &rr);
      const T fc_r =
          in_r ? T(0.5) * (dev_cos(T(CUDART_PI / rc_r) * rr) + T(1)) : T(0);
      const T v = warp_sum(dev_exp(T(-cfg.rad_eta[mi]) * rr * rr) * fc_r);
      if (lane == 0) g_row[mi] = v;
    }
  }

  // angular G4: q runs over the slots inside the angular cutoff
  T acc[kMaxAng];
#pragma unroll
  for (int f = 0; f < kMaxAng; ++f) acc[f] = T(0);
  const T rc_a2 = T(cfg.rc_a * cfg.rc_a);
  unsigned qmask = __ballot_sync(kFull, g.in_a);
  while (qmask) {
    const int q = __ffs(qmask) - 1;
    qmask &= qmask - 1;
    const T uqx = __shfl_sync(kFull, g.ux, q);
    const T uqy = __shfl_sync(kFull, g.uy, q);
    const T uqz = __shfl_sync(kFull, g.uz, q);
    const T aq = __shfl_sync(kFull, g.a, q);
    const T fcq = __shfl_sync(kFull, g.fc_a, q);
    if (!g.in_a || lane == q) continue;
    const T cs = g.ux * uqx + g.uy * uqy + g.uz * uqz;
    const T rjk2 = g.a * g.a + aq * aq - T(2) * g.a * aq * cs;
    if (!(rjk2 < rc_a2)) continue;
    const T rjk = dev_sqrt(rjk2 > T(1.0e-12) ? rjk2 : T(1.0e-12));
    const T fc_jk =
        T(0.5) * (dev_cos(T(CUDART_PI / cfg.rc_a) * rjk) + T(1));
    const T fc3 = g.fc_a * fcq * fc_jk;
    const T r2sum = g.a * g.a + aq * aq + rjk2;
    T t_eta = T(0);
#pragma unroll
    for (int f = 0; f < kMaxAng; ++f) {
      if (f < cfg.nang) {
        if (cfg.first[f]) t_eta = dev_exp(-cfg.eta[f] * r2sum) * fc3;
        const T fz = pow_zeta(T(1) + cfg.lam[f] * cs, cfg.zeta[f],
                              cfg.zlog2[f], (T*)nullptr);
        acc[f] = acc[f] + cfg.coef[f] * fz * t_eta;
      }
    }
  }
#pragma unroll
  for (int f = 0; f < kMaxAng; ++f) {
    if (f < cfg.nang) {
      const T v = warp_sum(acc[f]);
      if (lane == 0) g_row[cfg.col[f]] = T(0.5) * v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ni_force_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
                const T* __restrict__ dxz, const T* __restrict__ dedg,
                T* __restrict__ fjx, T* __restrict__ fjy,
                T* __restrict__ fjz, long long p, int k,
                const NiCfg<T> cfg) {
  __shared__ T wv_s[kWarps][kMaxAng];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= p) return;            // uniform across the warp
  const long long o = row * k + lane;
  const Geo<T> g = ni_geometry(dxx, dxy, dxz, o, lane < k, cfg.rc_a);
  const T* w_row = dedg + row * kNsfSub;

  // per-function weights dE/dG_col * 2^(1 - zeta), staged per warp
  T* wv = wv_s[warp];
#pragma unroll
  for (int f = 0; f < kMaxAng; ++f)
    if (f < cfg.nang && lane == f) wv[f] = w_row[cfg.col[f]] * cfg.coef[f];
  __syncwarp();

  // radial: d(sum_m w_m G2_m)/d rm
  T coeff = T(0);
#pragma unroll
  for (int mi = 0; mi < kMaxRad; ++mi) {
    if (mi < cfg.nrad) {
      const double rc_r = cfg.rad_rc[mi];
      const double eta = cfg.rad_eta[mi];
      T rr;
      const bool in_r = radial_in(g, rc_r, &rr);
      const T arg = T(CUDART_PI / rc_r) * rr;
      const T fc_r = T(0.5) * (dev_cos(arg) + T(1));
      const T dfc_r = T(-0.5 * CUDART_PI / rc_r) * dev_sin(arg);
      const T e_r = dev_exp(T(-eta) * rr * rr);
      const T dg = in_r ? e_r * (dfc_r - T(2.0 * eta) * rr * fc_r) : T(0);
      coeff = coeff + w_row[mi] * dg;
    }
  }
  // dG2/dx_j = dg * CFL * (-u_j);  Fj = -w dG => + CFL w dg u
  coeff = coeff * T(kCfLength);

  // angular: the u_p coefficient acc1 and the u_q-projected vector acc2
  T acc1 = T(0), acc2x = T(0), acc2y = T(0), acc2z = T(0);
  const T rc_a2 = T(cfg.rc_a * cfg.rc_a);
  unsigned qmask = __ballot_sync(kFull, g.in_a);
  while (qmask) {
    const int q = __ffs(qmask) - 1;
    qmask &= qmask - 1;
    const T uqx = __shfl_sync(kFull, g.ux, q);
    const T uqy = __shfl_sync(kFull, g.uy, q);
    const T uqz = __shfl_sync(kFull, g.uz, q);
    const T aq = __shfl_sync(kFull, g.a, q);
    const T fcq = __shfl_sync(kFull, g.fc_a, q);
    if (!g.in_a || lane == q) continue;
    const T cs = g.ux * uqx + g.uy * uqy + g.uz * uqz;
    const T rjk2 = g.a * g.a + aq * aq - T(2) * g.a * aq * cs;
    if (!(rjk2 < rc_a2)) continue;
    const T rjk = dev_sqrt(rjk2 > T(1.0e-12) ? rjk2 : T(1.0e-12));
    const T ang_jk = T(CUDART_PI / cfg.rc_a) * rjk;
    const T fc_jk = T(0.5) * (dev_cos(ang_jk) + T(1));
    const T dfc_jk = T(-0.5 * CUDART_PI / cfg.rc_a) * dev_sin(ang_jk);
    const T fc3 = g.fc_a * fcq * fc_jk;
    const T r2sum = g.a * g.a + aq * aq + rjk2;
    // sum_eta e S_A, sum_eta eta e S_A, sum_eta e S_C; per group e, S_A, S_C
    T p_a = T(0), p_e = T(0), p_cs = T(0);
    T e_eta = T(0), eta_g = T(0), s_a = T(0), s_c = T(0);
#pragma unroll
    for (int f = 0; f < kMaxAng; ++f) {
      if (f < cfg.nang) {
        if (cfg.first[f]) {
          if (f > 0) {
            const T t_a = e_eta * s_a;
            p_a = p_a + t_a;
            p_e = p_e + eta_g * t_a;
            p_cs = p_cs + e_eta * s_c;
          }
          eta_g = cfg.eta[f];
          e_eta = dev_exp(-eta_g * r2sum);
          s_a = T(0);
          s_c = T(0);
        }
        T dfz;
        const T fz = pow_zeta(T(1) + cfg.lam[f] * cs, cfg.zeta[f],
                              cfg.zlog2[f], &dfz);
        const T w = wv[f];
        s_a = s_a + w * fz;
        s_c = s_c + (w * cfg.lam[f]) * dfz;
      }
    }
    if (cfg.nang > 0) {
      const T t_a = e_eta * s_a;
      p_a = p_a + t_a;
      p_e = p_e + eta_g * t_a;
      p_cs = p_cs + e_eta * s_c;
    }
    // partials of h in the independent variables c, a_p, rjk
    const T p_c = fc3 * p_cs;
    const T p_ap = T(-2) * g.a * p_e * fc3 + g.dfc_a * fcq * fc_jk * p_a;
    const T p_jk = T(-2) * rjk * p_e * fc3 + g.fc_a * fcq * dfc_jk * p_a;
    const T inv_rjk = T(1) / rjk;
    const T cfl = T(kCfLength);
    const T c1 = p_c * cs * g.inv_r - cfl * p_ap - cfl * p_jk * g.a * inv_rjk;
    const T c2 = -p_c * g.inv_r + cfl * p_jk * aq * inv_rjk;
    acc1 = acc1 + c1;
    acc2x = acc2x + c2 * uqx;
    acc2y = acc2y + c2 * uqy;
    acc2z = acc2z + c2 * uqz;
  }
  if (!g.active) return;
  // Fj = -(d sum w G / dx_j): radial +coeff u, angular -(acc1 u + acc2)
  fjx[o] = (coeff - acc1) * g.ux - acc2x;
  fjy[o] = (coeff - acc1) * g.uy - acc2y;
  fjz[o] = (coeff - acc1) * g.uz - acc2z;
}

inline unsigned n_blocks(long long p) {
  return (unsigned)((p + kWarps - 1) / kWarps);
}

template <typename T>
int launch_g(const void* dxx, const void* dxy, const void* dxz, void* g,
             long long p, int k, const void* cfg, void* stream) {
  if (p > 0)
    ni_g_kernel<T><<<n_blocks(p), kWarps * 32, 0, (cudaStream_t)stream>>>(
        (const T*)dxx, (const T*)dxy, (const T*)dxz, (T*)g, p, k,
        *(const NiCfg<T>*)cfg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_force(const void* dxx, const void* dxy, const void* dxz,
                 const void* dedg, void* fjx, void* fjy, void* fjz,
                 long long p, int k, const void* cfg, void* stream) {
  if (p > 0)
    ni_force_kernel<T><<<n_blocks(p), kWarps * 32, 0,
                         (cudaStream_t)stream>>>(
        (const T*)dxx, (const T*)dxy, (const T*)dxz, (const T*)dedg,
        (T*)fjx, (T*)fjy, (T*)fjz, p, k, *(const NiCfg<T>*)cfg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(NiCfg<T>), checked by the ctypes wrapper against its own layout
int ni_cfg_size_f32() { return (int)sizeof(NiCfg<float>); }
int ni_cfg_size_f64() { return (int)sizeof(NiCfg<double>); }

int ni_g_f32(const void* dxx, const void* dxy, const void* dxz, void* g,
             long long p, int k, const void* cfg, void* stream) {
  return launch_g<float>(dxx, dxy, dxz, g, p, k, cfg, stream);
}

int ni_g_f64(const void* dxx, const void* dxy, const void* dxz, void* g,
             long long p, int k, const void* cfg, void* stream) {
  return launch_g<double>(dxx, dxy, dxz, g, p, k, cfg, stream);
}

int ni_force_f32(const void* dxx, const void* dxy, const void* dxz,
                 const void* dedg, void* fjx, void* fjy, void* fjz,
                 long long p, int k, const void* cfg, void* stream) {
  return launch_force<float>(dxx, dxy, dxz, dedg, fjx, fjy, fjz, p, k, cfg,
                             stream);
}

int ni_force_f64(const void* dxx, const void* dxy, const void* dxz,
                 const void* dedg, void* fjx, void* fjy, void* fjz,
                 long long p, int k, const void* cfg, void* stream) {
  return launch_force<double>(dxx, dxy, dxz, dedg, fjx, fjy, fjz, p, k, cfg,
                              stream);
}

}  // extern "C"
