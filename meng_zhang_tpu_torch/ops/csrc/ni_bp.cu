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
// partners, ~300 ordered (p, q) leg pairs of which ~120 have their third leg
// inside Rc too, each with a sqrt, a cos (and a sin in ni_force), 3 exp (one
// per eta group) and ~150 FLOPs for the 24 functions, against 12 bytes of
// dx read per lane: both kernels are compute bound on precise expf / cospif
// and the zeta powers. Each lane computes its own geometry once (u, r, the
// Bohr radius a, fc, dfc), and exp(-eta r2sum) is computed once per eta
// group, not once per function. The table sits in kernel parameters
// (constant bank). Zeta powers go by repeated squaring when zeta is a power
// of two (all of the shipped table), by pow otherwise.
//   Both work from a list of the row's unordered leg pairs in the warp's
// shared memory. A q loop over the slots would run its whole body once per
// slot q (~18 a row) while most lanes fail the leg tests, and it would
// compute every pair term twice although a G4 term is symmetric in (p, q),
// as is all of a force term but its last ~15 operations. Instead the lanes
// inside the cutoff are compacted (ballot + popc), the unordered pairs of
// compacted lanes are enumerated 32 at a time and those with r_jk < Rc
// appended to the list (stage 1, list_pairs: ~5 short rounds a row, one
// piece of code for both kernels), and the list is then walked with one
// pair a lane (stage 2, ~2 rounds a row with nearly all lanes busy). The
// cutoffs go through cospi / sincospi of r / Rc: one call, no rounding of
// pi r / Rc.
//   ni_g's stage 2 adds a pair's term once, undoubled: G4's 1/2 and the
// pair's two orders cancel. Each lane keeps its own 24 sums in registers
// (the per-function loop is unrolled over the compile-time bound kMaxAng,
// so the sums have compile-time indices), one exp per eta group and the
// zeta powers by repeated squaring per function; a row ends in one warp
// reduction per function. No atomics: a lane's sums run in list order and
// the shuffles in a fixed order, so ni_g is deterministic (bitwise equal
// from run to run), though its order is not the plain version's.
//   ni_force's stage 2 computes the symmetric part once, then each side's
// own partial, added to both lanes' sums with shared-memory atomicAdd (a
// few lanes of a round may share a slot). So the order of a lane's sum may
// change from run to run and f32 results are not bitwise reproducible, as
// the delivery's index_add_ already is not. The table is read by its
// structure: each distinct (lambda, zeta) shape's f^zeta and
// zeta f^(zeta - 1) once a pair, power-of-two zetas of one lambda along one
// squaring chain, then per eta group one exp and a dot product with the
// row's dE/dG weights summed per (group, shape).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kNsfSub = 32;      // g / dedg row width
constexpr int kMaxRad = 8;       // radial functions
constexpr int kMaxAng = 32;      // angular functions
constexpr int kMaxShape = 16;    // distinct (lambda, zeta) of the table
constexpr int kMaxGroup = 16;    // eta groups
constexpr int kMaxSlot = 128;    // eta groups x shapes
constexpr int kMaxPair = 32 * 31 / 2;   // unordered pairs of one row's lanes
constexpr int kWarps = 4;        // atom rows per block
constexpr unsigned kFull = 0xffffffffu;
constexpr double kCfLength = 1.889726;    // Angstrom -> Bohr (units.py)

// The kernels' table (ops/kernels.py builds it from fused_ni.ni_table).
// Angular functions come group-major: first[f] marks the first function of
// an eta group; col[f] is the descriptor column; zlog2[f] = log2(zeta)
// when zeta is a power of two, else -1; coef[f] = 2^(1 - zeta).
// ni_force reads the table by its structure: ngroup eta groups (grp_eta),
// nshape distinct (lambda, zeta) shapes sorted by lambda, then zeta
// (sh_lam, sh_zeta), and per function its group grp[f] and shape shp[f].
// Power-of-two zetas of one lambda lie along one squaring chain: sh_new[s]
// starts a chain at f = 1 + lambda cos, sh_adv[s] is the number of
// squarings from the chain's state at the shape before; sh_adv[s] = -1
// sends the shape through pow.
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
  int ngroup;
  int nshape;
  T grp_eta[kMaxGroup];
  T sh_lam[kMaxShape];
  T sh_zeta[kMaxShape];
  int sh_adv[kMaxShape];
  int sh_new[kMaxShape];
  int grp[kMaxAng];
  int shp[kMaxAng];
};

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dev_cos(float v) { return cosf(v); }
__device__ __forceinline__ double dev_cos(double v) { return cos(v); }
__device__ __forceinline__ float dev_sin(float v) { return sinf(v); }
__device__ __forceinline__ double dev_sin(double v) { return sin(v); }
__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_cospi(float v) { return cospif(v); }
__device__ __forceinline__ double dev_cospi(double v) { return cospi(v); }
__device__ __forceinline__ void dev_sincospi(float v, float* s, float* c) {
  sincospif(v, s, c);
}
__device__ __forceinline__ void dev_sincospi(double v, double* s, double* c) {
  sincospi(v, s, c);
}
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

// Per-lane geometry, as _ni_geometry without the cutoff function. Lanes at
// or beyond K are inactive: they take part in the shuffles but are masked
// everywhere.
template <typename T>
struct Geo {
  bool active, in_a;
  T r, inv_r, ux, uy, uz, rm;
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

// One row's lanes inside the angular cutoff, compacted in lane order (unit
// vector, Bohr radius a, cutoff fc), and the list of its leg pairs: one per
// warp, in shared memory.
template <typename T>
struct PairRow {
  T ux[32], uy[32], uz[32], a[32], fc[32];
  // surviving pairs, j | k << 8
  unsigned short pairs[kMaxPair + 16];
};

// Stage 1 of both kernels, called by the whole warp once the n_in compacted
// lanes are written: the unordered pairs (j, k) of compacted lanes, 32 a
// round; pair t is (j, j + d mod n_in) with d = t / n_in + 1, j = t mod
// n_in, which runs over every unordered pair once for t < n_in (n_in - 1)
// / 2. Those whose third leg r_jk lies inside the cutoff go to the list;
// returns their number.
template <typename T>
__device__ __forceinline__ int list_pairs(PairRow<T>& sh, int n_in, int lane,
                                          T rc_a2) {
  __syncwarp();
  const int n_cand = n_in * (n_in - 1) / 2;
  // t / n_in for t < 1024, n_in <= 32, without a division a round
  const unsigned inv_n = 65536u / (unsigned)(n_in > 0 ? n_in : 1) + 1u;
  const unsigned lt_mask = (1u << lane) - 1u;
  int n_pair = 0;
  for (int base = 0; base < n_cand; base += 32) {
    const bool cand = base + lane < n_cand;
    const int t = cand ? base + lane : 0;
    const int dd = (int)(((unsigned)t * inv_n) >> 16);
    const int j = t - dd * n_in;
    int kk = j + dd + 1;
    if (kk >= n_in) kk -= n_in;
    const T aj = sh.a[j], ak = sh.a[kk];
    const T cs = sh.ux[j] * sh.ux[kk] + sh.uy[j] * sh.uy[kk]
                 + sh.uz[j] * sh.uz[kk];
    const T rjk2 = aj * aj + ak * ak - T(2) * aj * ak * cs;
    const bool ok = cand && rjk2 < rc_a2;
    const unsigned okm = __ballot_sync(kFull, ok);
    if (ok)
      sh.pairs[n_pair + __popc(okm & lt_mask)] =
          (unsigned short)(j | (kk << 8));
    n_pair += __popc(okm);
  }
  __syncwarp();
  return n_pair;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ni_g_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
            const T* __restrict__ dxz, T* __restrict__ g_out, long long p,
            int k, const __grid_constant__ NiCfg<T> cfg) {
  __shared__ PairRow<T> rows[kWarps];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p) return;            // uniform across the warp
  PairRow<T>& sh = rows[threadIdx.x >> 5];
  const Geo<T> g = ni_geometry(dxx, dxy, dxz, row * k + lane, lane < k,
                               cfg.rc_a);
  T* g_row = g_out + row * kNsfSub;
  if (lane >= cfg.nrad + cfg.nang) g_row[lane] = T(0);

  // compact the lanes inside the angular cutoff
  const T inv_rc = T(1.0 / cfg.rc_a);
  const unsigned in_mask = __ballot_sync(kFull, g.in_a);
  const int n_in = __popc(in_mask);
  if (g.in_a) {
    const int c = __popc(in_mask & ((1u << lane) - 1u));
    sh.ux[c] = g.ux;
    sh.uy[c] = g.uy;
    sh.uz[c] = g.uz;
    sh.a[c] = g.rm;
    sh.fc[c] = T(0.5) * (dev_cospi(g.rm * inv_rc) + T(1));
  }

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

  // angular G4, stage 1: the row's leg pairs
  const int n_pair = list_pairs(sh, n_in, lane, T(cfg.rc_a * cfg.rc_a));

  // stage 2: one lane a pair; what does not depend on the function (r_jk
  // and its cutoff, fc3, r2sum) once, one exp per eta group, then each
  // function's term into this lane's sum
  T acc[kMaxAng];
#pragma unroll
  for (int f = 0; f < kMaxAng; ++f) acc[f] = T(0);
  for (int base = 0; base < n_pair; base += 32) {
    if (base + lane >= n_pair) continue;
    const int pr = sh.pairs[base + lane];
    const int j = pr & 255, kk = pr >> 8;
    const T aj = sh.a[j], ak = sh.a[kk];
    const T cs = sh.ux[j] * sh.ux[kk] + sh.uy[j] * sh.uy[kk]
                 + sh.uz[j] * sh.uz[kk];
    const T rjk2 = aj * aj + ak * ak - T(2) * aj * ak * cs;
    const T rjk = dev_sqrt(rjk2 > T(1.0e-12) ? rjk2 : T(1.0e-12));
    const T fc_jk = T(0.5) * (dev_cospi(rjk * inv_rc) + T(1));
    const T fc3 = sh.fc[j] * sh.fc[kk] * fc_jk;
    const T r2sum = aj * aj + ak * ak + rjk2;
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
      if (lane == 0) g_row[cfg.col[f]] = v;
    }
  }
}

// One row's working set of ni_force in shared memory, one per warp.
template <typename T>
struct ForceRow {
  PairRow<T> pr;
  // per compacted lane: the cutoff's derivative and 1 / r (Angstrom)
  T dfc[32], inv_r[32];
  // per compacted lane: the u_p coefficient and the u_q-projected vector
  T acc1[32], acc2x[32], acc2y[32], acc2z[32];
  // per (eta group, shape): sum of dE/dG 2^(1 - zeta) over its functions,
  // and the same times lambda
  T wa[kMaxSlot], wc[kMaxSlot];
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ni_force_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
                const T* __restrict__ dxz, const T* __restrict__ dedg,
                T* __restrict__ fjx, T* __restrict__ fjy,
                T* __restrict__ fjz, long long p, int k,
                const __grid_constant__ NiCfg<T> cfg) {
  __shared__ ForceRow<T> rows[kWarps];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p) return;            // uniform across the warp
  ForceRow<T>& fr = rows[threadIdx.x >> 5];
  PairRow<T>& sh = fr.pr;
  const long long o = row * k + lane;
  const T* w_row = dedg + row * kNsfSub;
  const Geo<T> g = ni_geometry(dxx, dxy, dxz, o, lane < k, cfg.rc_a);
  const T inv_rc = T(1.0 / cfg.rc_a);
  const T dfc_scale = T(-0.5 * CUDART_PI / cfg.rc_a);

  // compact the lanes inside the angular cutoff; zero the row's sums
  const unsigned in_mask = __ballot_sync(kFull, g.in_a);
  const int n_in = __popc(in_mask);
  const int c = __popc(in_mask & ((1u << lane) - 1u));
  if (g.in_a) {
    T sn, cn;
    dev_sincospi(g.rm * inv_rc, &sn, &cn);
    sh.ux[c] = g.ux;
    sh.uy[c] = g.uy;
    sh.uz[c] = g.uz;
    sh.a[c] = g.rm;
    sh.fc[c] = T(0.5) * (cn + T(1));
    fr.dfc[c] = dfc_scale * sn;
    fr.inv_r[c] = g.inv_r;
  }
  fr.acc1[lane] = T(0);
  fr.acc2x[lane] = T(0);
  fr.acc2y[lane] = T(0);
  fr.acc2z[lane] = T(0);
  const int nslot = cfg.ngroup * cfg.nshape;
  for (int i = lane; i < nslot; i += 32) {
    fr.wa[i] = T(0);
    fr.wc[i] = T(0);
  }
  __syncwarp();
  // per-function weights dE/dG_col * 2^(1 - zeta) into their (group, shape)
  if (lane < cfg.nang) {
    const T w = w_row[cfg.col[lane]] * cfg.coef[lane];
    const int slot = cfg.grp[lane] * cfg.nshape + cfg.shp[lane];
    atomicAdd(&fr.wa[slot], w);
    atomicAdd(&fr.wc[slot], w * cfg.lam[lane]);
  }

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

  // stage 1: the row's leg pairs
  const int n_pair = list_pairs(sh, n_in, lane, T(cfg.rc_a * cfg.rc_a));

  // stage 2: one lane a pair. What is symmetric in (j, k) is computed
  // once: r_jk and its cutoff, fc3, r2sum, each shape's f^zeta and
  // zeta f^(zeta - 1), each eta group's exp and sums; then each side's
  // partial in its own leg and its C1, C2, added to both lanes' sums.
  for (int base = 0; base < n_pair; base += 32) {
    if (base + lane >= n_pair) continue;
    const int pr = sh.pairs[base + lane];
    const int j = pr & 255, kk = pr >> 8;
    const T ujx = sh.ux[j], ujy = sh.uy[j], ujz = sh.uz[j];
    const T ukx = sh.ux[kk], uky = sh.uy[kk], ukz = sh.uz[kk];
    const T aj = sh.a[j], ak = sh.a[kk];
    const T fcj = sh.fc[j], fck = sh.fc[kk];
    const T cs = ujx * ukx + ujy * uky + ujz * ukz;
    const T rjk2 = aj * aj + ak * ak - T(2) * aj * ak * cs;
    const T rjk = dev_sqrt(rjk2 > T(1.0e-12) ? rjk2 : T(1.0e-12));
    T sn, cn;
    dev_sincospi(rjk * inv_rc, &sn, &cn);
    const T fc_jk = T(0.5) * (cn + T(1));
    const T dfc_jk = dfc_scale * sn;
    const T fcjk2 = fcj * fck;
    const T fc3 = fcjk2 * fc_jk;
    const T r2sum = aj * aj + ak * ak + rjk2;

    T fz[kMaxShape], dfz[kMaxShape];
    T pz = T(0), fzm = T(0);             // the running chain
#pragma unroll
    for (int s = 0; s < kMaxShape; ++s) {
      if (s >= cfg.nshape) break;
      const int adv = cfg.sh_adv[s];
      if (adv < 0) {
        const T f1 = T(1) + cfg.sh_lam[s] * cs;
        fz[s] = dev_pow(f1, cfg.sh_zeta[s]);
        dfz[s] = cfg.sh_zeta[s] * dev_pow(f1, cfg.sh_zeta[s] - T(1));
      } else {
        if (cfg.sh_new[s]) {
          pz = T(1) + cfg.sh_lam[s] * cs;
          fzm = T(1);
        }
        // f^(zeta - 1) = f^1 f^2 ... f^(zeta/2), in _pow_zeta's order
        for (int i = 0; i < adv; ++i) {
          fzm = fzm * pz;
          pz = pz * pz;
        }
        fz[s] = pz;
        dfz[s] = cfg.sh_zeta[s] * fzm;
      }
    }
    // sum_eta e S_A, sum_eta eta e S_A, sum_eta e S_C
    T p_a = T(0), p_e = T(0), p_cs = T(0);
    for (int gi = 0; gi < cfg.ngroup; ++gi) {
      const T eta_g = cfg.grp_eta[gi];
      const T e_eta = dev_exp(-eta_g * r2sum);
      const T* wa = fr.wa + gi * cfg.nshape;
      const T* wc = fr.wc + gi * cfg.nshape;
      T s_a = T(0), s_c = T(0);
#pragma unroll
      for (int s = 0; s < kMaxShape; ++s) {
        if (s >= cfg.nshape) break;
        s_a = s_a + wa[s] * fz[s];
        s_c = s_c + wc[s] * dfz[s];
      }
      const T t_a = e_eta * s_a;
      p_a = p_a + t_a;
      p_e = p_e + eta_g * t_a;
      p_cs = p_cs + e_eta * s_c;
    }
    // partials of h in the independent variables c, a_j, a_k, rjk
    const T cfl = T(kCfLength);
    const T p_c = fc3 * p_cs;
    const T pe3 = T(-2) * p_e * fc3;
    const T p_jk = rjk * pe3 + fcjk2 * dfc_jk * p_a;
    const T cjk = cfl * p_jk / rjk;
    const T p_aj = aj * pe3 + fr.dfc[j] * fck * fc_jk * p_a;
    const T p_ak = ak * pe3 + fr.dfc[kk] * fcj * fc_jk * p_a;
    const T irj = fr.inv_r[j], irk = fr.inv_r[kk];
    // d(sum w G)/dx_j = C1 u_j + C2 u_k, and the same with j and k exchanged
    const T c1j = p_c * cs * irj - cfl * p_aj - cjk * aj;
    const T c2j = cjk * ak - p_c * irj;
    const T c1k = p_c * cs * irk - cfl * p_ak - cjk * ak;
    const T c2k = cjk * aj - p_c * irk;
    atomicAdd(&fr.acc1[j], c1j);
    atomicAdd(&fr.acc2x[j], c2j * ukx);
    atomicAdd(&fr.acc2y[j], c2j * uky);
    atomicAdd(&fr.acc2z[j], c2j * ukz);
    atomicAdd(&fr.acc1[kk], c1k);
    atomicAdd(&fr.acc2x[kk], c2k * ujx);
    atomicAdd(&fr.acc2y[kk], c2k * ujy);
    atomicAdd(&fr.acc2z[kk], c2k * ujz);
  }
  __syncwarp();
  if (!g.active) return;
  // Fj = -(d sum w G / dx_j): radial +coeff u, angular -(acc1 u + acc2)
  T acc1 = T(0), acc2x = T(0), acc2y = T(0), acc2z = T(0);
  if (g.in_a) {
    acc1 = fr.acc1[c];
    acc2x = fr.acc2x[c];
    acc2y = fr.acc2y[c];
    acc2z = fr.acc2z[c];
  }
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
