// Behler-Parrinello (ni) ANNP kernels for Hopper (sm_90a), plain C interface.
//
// ni_g replaces the TPU kernel `_ni_g_kernel` (meng_zhang_tpu/ops/
// pallas_ni.py); ni_force replaces `_ni_force_kernel` in the same file. Both
// read [P, K] displacement planes dx = x_i - x_j (filler lanes carry dx =
// 2 box + 10 and give exactly 0). A row of K <= 512 slots runs on one warp,
// S = ceil(K / 32) neighbor slots a lane (slot s * 32 + lane; one compiled
// instance per S in 1, 2, 4, 8, 16, picked at launch); a wider row, of any
// K, goes in tiles of 128 slots through the cross-tile instances
// ni_g_tiles / ni_force_tiles (the section "rows of more than 512" below):
//   ni_g      g [P, 32]: radial G2 = sum_j exp(-eta r^2) fc in cols
//             [0, npsf), angular G4 = 1/2 sum_{p != q} 2^(1-zeta)
//             (1 + lambda cos)^zeta exp(-eta r2sum) fc_p fc_q fc_pq in cols
//             npsf + n, rest 0 (lengths in Bohr, r_Bohr = CFLENGTH r_A);
//   ni_force  per-pair Fj = -dE_i/dx_j [P, K] x3 from dedg [P, 32] = dE/dG
//             already multiplied by sf_scale * e_scale.
// The table is any that the TPU kernels take: nsf = nrad + nang <= 32, one
// angular cutoff.
//
// What bounds them on this card: on the ni scene (Rc 3.90 A, K 32) a row
// holds ~18 real partners, ~300 ordered (p, q) leg pairs of which ~120 have
// their third leg inside Rc too; at Rc 6.0 A (K 128) ~86 partners and
// thousands of leg pairs. Each pair costs a sqrt, a cos (and a sin in
// ni_force), one exp per eta group and ~150 FLOPs for 24 functions, against
// 12 bytes of dx read per lane: both kernels are compute bound on precise
// expf / cospif and the zeta powers. Each lane computes its slots' geometry
// once (u, r, the Bohr radius a, fc, dfc), and exp(-eta r2sum) is computed
// once per eta group, not once per function. The table sits in kernel
// parameters (constant bank). Zeta powers go by repeated squaring when zeta
// is a power of two (all of the shipped table), by pow otherwise.
//   Both work from a list of the row's unordered leg pairs in the warp's
// shared memory. A q loop over the slots would run its whole body once per
// slot q while most lanes fail the leg tests, and it would compute every
// pair term twice although a G4 term is symmetric in (p, q), as is all of a
// force term but its last ~15 operations. Instead the slots inside the
// cutoff are compacted (ballot + popc, slot order), the unordered pairs of
// compacted slots are enumerated 32 at a time and those with r_jk < Rc
// appended to the list (stage 1, list_pairs: one piece of code for both
// kernels), and the list is then walked with one pair a lane (stage 2,
// nearly all lanes busy). The list is built and walked in tiles of at most
// kTile pairs, so shared memory does not grow with the K^2 / 2 pairs of a
// wide row: stage 1 stops when a tile could not take another round, stage 2
// walks it, and stage 1 resumes at the next candidate. A K <= 32 row
// (<= 496 candidates) is always one tile. The cutoffs go through cospi /
// sincospi of r / Rc: one call, no rounding of pi r / Rc.
//   ni_g's stage 2 adds a pair's term once, undoubled: G4's 1/2 and the
// pair's two orders cancel. Each lane keeps its own per-function sums in
// registers across the tiles (the per-function loop is unrolled over the
// compile-time bound kMaxAng, so the sums have compile-time indices), one
// exp per eta group and the zeta powers by repeated squaring per function;
// a row ends in one warp reduction per function. No atomics: a lane's sums
// run in list order and the shuffles in a fixed order, so ni_g is
// deterministic (bitwise equal from run to run), though its order is not
// the plain version's.
//   ni_force's stage 2 computes the symmetric part once, then each side's
// own partial, added to both slots' sums (K of them, in shared memory,
// carried across the tiles) with shared-memory atomicAdd (a few lanes of a
// round may share a slot). So the order of a slot's sum may change from run
// to run and f32 results are not bitwise reproducible, as the delivery's
// index_add_ already is not. The table is read by its structure: each
// distinct (lambda, zeta) shape's f^zeta and zeta f^(zeta - 1) once a pair,
// power-of-two zetas of one lambda along one squaring chain, then per eta
// group one exp and a dot product with the row's dE/dG weights over the
// (group, shape) entries that occur in the table (at most nang of them,
// group-major). A lane holds the powers of kShapeChunk shapes at a time;
// a table of more shapes walks its groups once per chunk.
//   A listed pair packs its two compacted slots in 16 bits (8 each) up to
// S = 8 and in 32 bits (16 each) at S = 16. ni_force's per-warp working set
// at S = 16 is ~47 KB in f64 (the per-slot sums and geometry of 512 slots
// and the tile), so a block of 4 rows takes ~186 KB of dynamic shared
// memory and an SM holds one such block (two in f32).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

constexpr int kNsfSub = 32;      // g / dedg row width
constexpr int kMaxRad = 32;      // radial functions
constexpr int kMaxAng = 32;      // angular functions
constexpr int kMaxShape = 32;    // distinct (lambda, zeta) of the table
constexpr int kMaxGroup = 32;    // eta groups
constexpr int kShapeChunk = 16;  // shapes whose powers a lane holds at once
constexpr int kTile = 512;       // leg pairs listed at a time, per row
constexpr int kWarps = 4;        // atom rows per block
constexpr unsigned kFull = 0xffffffffu;
constexpr double kCfLength = 1.889726;    // Angstrom -> Bohr (units.py)

// The kernels' table (ops/kernels.py builds it from fused_ni.ni_table).
// Angular functions come group-major: first[f] marks the first function of
// an eta group; col[f] is the descriptor column; zlog2[f] = log2(zeta)
// when zeta is a power of two, else -1; coef[f] = 2^(1 - zeta).
// ni_force reads the table by its structure: ngroup eta groups (grp_eta),
// nshape distinct (lambda, zeta) shapes sorted by lambda, then zeta
// (sh_lam, sh_zeta), and the nent (group, shape) entries that occur,
// group-major, then by shape: group g's entries are the set bits of
// grp_mask[g] (bit s: shape s), starting at entry grp_off[g]; function f
// adds its weight to entry ent[f]. Power-of-two zetas of one lambda lie
// along one squaring chain: sh_new[s] starts a chain at f = 1 + lambda cos,
// sh_adv[s] is the number of squarings from the chain's state at the shape
// before; sh_adv[s] = -1 sends the shape through pow.
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
  int nent;
  T grp_eta[kMaxGroup];
  unsigned grp_mask[kMaxGroup];
  int grp_off[kMaxGroup];
  T sh_lam[kMaxShape];
  T sh_zeta[kMaxShape];
  int sh_adv[kMaxShape];
  int sh_new[kMaxShape];
  int ent[kMaxAng];
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

// f1^zeta and, with dfz, zeta f1^(zeta - 1) through pow, both 0 where
// f1 <= 0 (the BP definition skips those terms; rounding can leave
// 1 + lambda cos a few ulps below 0, which a fractional zeta would turn
// into NaN)
template <typename T>
__device__ __forceinline__ T pow_route(T f1, T zeta, T* dfz) {
  const bool pos = f1 > T(0);
  const T fb = pos ? f1 : T(1);
  if (dfz) *dfz = pos ? zeta * dev_pow(fb, zeta - T(1)) : T(0);
  return pos ? dev_pow(fb, zeta) : T(0);
}

// f1^zeta, and with dfz also zeta * f1^(zeta - 1), in the TPU kernel's
// product order (_pow_zeta): f^(zeta-1) = f^1 f^2 ... f^(zeta/2).
template <typename T>
__device__ __forceinline__ T pow_zeta(T f1, T zeta, int zl, T* dfz) {
  if (zl < 0) return pow_route(f1, zeta, dfz);
  T p = f1, fzm = T(1);
  for (int s = 0; s < zl; ++s) {
    fzm = (s == 0) ? p : fzm * p;
    p = p * p;
  }
  if (dfz) *dfz = zeta * fzm;
  return p;
}

// Per-slot geometry, as _ni_geometry without the cutoff function. Slots at
// or beyond K are inactive: their lanes take part in the shuffles but are
// masked everywhere.
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

// in_r and the clamped radius of a radial function of cutoff rc_r
template <typename T>
__device__ __forceinline__ bool radial_in(bool active, T rm, T r, double rc_r,
                                          T* rr) {
  const bool in_r = active && rm < T(rc_r) && r > T(1.0e-6);
  *rr = in_r ? rm : T(rc_r);
  return in_r;
}

// One row's slots inside the angular cutoff, compacted in slot order (unit
// vector, Bohr radius a, cutoff fc), and a tile of its leg pairs: one per
// warp, in shared memory.
template <typename T, int S>
struct PairRow {
  // a listed pair's code: j | k << kShift (j, k < 32 S)
  using Code =
      typename std::conditional<(S > 8), unsigned, unsigned short>::type;
  static constexpr int kShift = S > 8 ? 16 : 8;
  static constexpr int kMask = (1 << kShift) - 1;
  T ux[32 * S], uy[32 * S], uz[32 * S], a[32 * S], fc[32 * S];
  Code pairs[kTile];               // listed pairs of the current tile
};

// t / n for t < 2^23, n <= 512: the high word of t * ceil(2^32 / n)
__host__ __device__ __forceinline__ unsigned div_magic(int n) {
  return n > 1 ? 0xffffffffu / (unsigned)n + 1u : 0u;
}

// Stage 1 of both kernels, called by the whole warp once the n_in compacted
// slots are written: the unordered pairs (j, k) of compacted slots, 32 a
// round; candidate t is (j, j + d mod n_in) with d = t / n_in + 1,
// j = t mod n_in, which runs over every unordered pair once for
// t < n_in (n_in - 1) / 2. Those whose third leg r_jk lies inside the
// cutoff go to the tile. Starts at candidate *cand and stops when the
// candidates are done or the tile could not take another round; advances
// *cand and returns the tile's pairs.
template <typename T, int S>
__device__ __forceinline__ int list_pairs(PairRow<T, S>& sh, int n_in,
                                          int n_cand, unsigned magic,
                                          int* cand, int lane, T rc_a2) {
  const unsigned lt_mask = (1u << lane) - 1u;
  int n_pair = 0;
  int base = *cand;
  for (; base < n_cand && n_pair <= kTile - 32; base += 32) {
    const bool c = base + lane < n_cand;
    const int t = c ? base + lane : 0;
    const int dd = (int)__umulhi((unsigned)t, magic);
    const int j = t - dd * n_in;
    int kk = j + dd + 1;
    if (kk >= n_in) kk -= n_in;
    const T aj = sh.a[j], ak = sh.a[kk];
    const T cs = sh.ux[j] * sh.ux[kk] + sh.uy[j] * sh.uy[kk]
                 + sh.uz[j] * sh.uz[kk];
    const T rjk2 = aj * aj + ak * ak - T(2) * aj * ak * cs;
    const bool ok = c && rjk2 < rc_a2;
    const unsigned okm = __ballot_sync(kFull, ok);
    if (ok)
      sh.pairs[n_pair + __popc(okm & lt_mask)] =
          (typename PairRow<T, S>::Code)(j | (kk << PairRow<T, S>::kShift));
    n_pair += __popc(okm);
  }
  *cand = base;
  __syncwarp();
  return n_pair;
}

template <typename T, int S>
__global__ void __launch_bounds__(kWarps * 32)
ni_g_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
            const T* __restrict__ dxz, T* __restrict__ g_out, long long p,
            int k, const __grid_constant__ NiCfg<T> cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p) return;            // uniform across the warp
  PairRow<T, S>& sh =
      reinterpret_cast<PairRow<T, S>*>(smem)[threadIdx.x >> 5];
  T* g_row = g_out + row * kNsfSub;
  if (lane >= cfg.nrad + cfg.nang) g_row[lane] = T(0);

  // each slot's geometry; compact the slots inside the angular cutoff
  const T inv_rc = T(1.0 / cfg.rc_a);
  const unsigned lt_mask = (1u << lane) - 1u;
  bool act[S];
  T rm[S], r[S];
  int n_in = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = s * 32 + lane;
    const Geo<T> g = ni_geometry(dxx, dxy, dxz, row * k + slot, slot < k,
                                 cfg.rc_a);
    const unsigned in_mask = __ballot_sync(kFull, g.in_a);
    if (g.in_a) {
      const int c = n_in + __popc(in_mask & lt_mask);
      sh.ux[c] = g.ux;
      sh.uy[c] = g.uy;
      sh.uz[c] = g.uz;
      sh.a[c] = g.rm;
      sh.fc[c] = T(0.5) * (dev_cospi(g.rm * inv_rc) + T(1));
    }
    n_in += __popc(in_mask);
    act[s] = g.active;
    rm[s] = g.rm;
    r[s] = g.r;
  }

  // radial G2
  for (int mi = 0; mi < cfg.nrad; ++mi) {
    const double rc_r = cfg.rad_rc[mi];
    const T eta = T(cfg.rad_eta[mi]);
    T v = T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      T rr;
      const bool in_r = radial_in(act[s], rm[s], r[s], rc_r, &rr);
      const T fc_r =
          in_r ? T(0.5) * (dev_cos(T(CUDART_PI / rc_r) * rr) + T(1)) : T(0);
      v = v + dev_exp(-eta * rr * rr) * fc_r;
    }
    v = warp_sum(v);
    if (lane == 0) g_row[mi] = v;
  }
  __syncwarp();

  // angular G4, tile by tile: stage 1 lists the row's leg pairs, stage 2
  // takes one pair a lane: what does not depend on the function (r_jk and
  // its cutoff, fc3, r2sum) once, one exp per eta group, then each
  // function's term into this lane's sum
  T acc[kMaxAng];
#pragma unroll
  for (int f = 0; f < kMaxAng; ++f) acc[f] = T(0);
  const int n_cand = n_in * (n_in - 1) / 2;
  const unsigned magic = div_magic(n_in);
  const T rc_a2 = T(cfg.rc_a * cfg.rc_a);
  int cand = 0;
  do {
    const int n_pair = list_pairs(sh, n_in, n_cand, magic, &cand, lane,
                                  rc_a2);
    for (int base = 0; base < n_pair; base += 32) {
      if (base + lane >= n_pair) continue;
      const int pr = sh.pairs[base + lane];
      const int j = pr & PairRow<T, S>::kMask;
      const int kk = pr >> PairRow<T, S>::kShift;
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
    __syncwarp();                  // the tile is read before it is refilled
  } while (cand < n_cand);
#pragma unroll
  for (int f = 0; f < kMaxAng; ++f) {
    if (f < cfg.nang) {
      const T v = warp_sum(acc[f]);
      if (lane == 0) g_row[cfg.col[f]] = v;
    }
  }
}

// One row's working set of ni_force in shared memory, one per warp.
template <typename T, int S>
struct ForceRow {
  PairRow<T, S> pr;
  // per compacted slot: the cutoff's derivative and 1 / r (Angstrom)
  T dfc[32 * S], inv_r[32 * S];
  // per compacted slot: the u_p coefficient and the u_q-projected vector
  T acc1[32 * S], acc2x[32 * S], acc2y[32 * S], acc2z[32 * S];
  // per (group, shape) entry: sum of dE/dG 2^(1 - zeta) over its
  // functions, and the same times lambda
  T wa[kMaxAng], wc[kMaxAng];
};

// One leg pair's weighted angular sums, the table read by its structure:
// p_a = sum_eta e S_A, p_e = sum_eta eta e S_A, p_cs = sum_eta e S_C with
// e = exp(-eta r2sum), S_A = sum wa f^zeta and S_C = sum wc zeta f^(zeta - 1)
// over the group's (group, shape) entries, f = 1 + lambda cs
template <typename T>
__device__ __forceinline__ void angular_sums(const NiCfg<T>& cfg, const T* wa,
                                             const T* wc, T cs, T r2sum,
                                             T* p_a_out, T* p_e_out,
                                             T* p_cs_out) {
  T p_a = T(0), p_e = T(0), p_cs = T(0);
  T pz = T(0), fzm = T(0);             // the running chain
  for (int c0 = 0; c0 < cfg.nshape; c0 += kShapeChunk) {
    const int nsh = min(cfg.nshape - c0, kShapeChunk);
    T fz[kShapeChunk], dfz[kShapeChunk];
#pragma unroll
    for (int i = 0; i < kShapeChunk; ++i) {
      if (i >= nsh) break;
      const int s = c0 + i;
      const int adv = cfg.sh_adv[s];
      if (adv < 0) {
        T d;
        fz[i] = pow_route(T(1) + cfg.sh_lam[s] * cs, cfg.sh_zeta[s], &d);
        dfz[i] = d;
      } else {
        if (cfg.sh_new[s]) {
          pz = T(1) + cfg.sh_lam[s] * cs;
          fzm = T(1);
        }
        // f^(zeta - 1) = f^1 f^2 ... f^(zeta/2), in _pow_zeta's order
        for (int q = 0; q < adv; ++q) {
          fzm = fzm * pz;
          pz = pz * pz;
        }
        fz[i] = pz;
        dfz[i] = cfg.sh_zeta[s] * fzm;
      }
    }
    // the chunk's shapes, as bits from 0
    const unsigned all = (1u << nsh) - 1u;
    for (int gi = 0; gi < cfg.ngroup; ++gi) {
      const unsigned gm = cfg.grp_mask[gi];
      const unsigned m = (gm >> c0) & all;
      if (m == 0u) continue;
      const T eta_g = cfg.grp_eta[gi];
      const T e_eta = dev_exp(-eta_g * r2sum);
      // the group's first entry of this chunk
      const int e0 = cfg.grp_off[gi] + __popc(gm & ((1u << c0) - 1u));
      T s_a = T(0), s_c = T(0);
      int e = e0;
#pragma unroll
      for (int i = 0; i < kShapeChunk; ++i) {
        if (i >= nsh) break;
        if ((m >> i) & 1u) {
          s_a = s_a + wa[e] * fz[i];
          s_c = s_c + wc[e] * dfz[i];
          ++e;
        }
      }
      const T t_a = e_eta * s_a;
      p_a = p_a + t_a;
      p_e = p_e + eta_g * t_a;
      p_cs = p_cs + e_eta * s_c;
    }
  }
  *p_a_out = p_a;
  *p_e_out = p_e;
  *p_cs_out = p_cs;
}

// A slot's radial force coefficient: CFL sum_m w_m dG2_m/d rm, so that the
// radial part of Fj is + coeff u (dG2/dx_j = dg CFL (-u_j), Fj = -w dG)
template <typename T>
__device__ __forceinline__ T radial_coeff(const NiCfg<T>& cfg, const T* w_row,
                                          const Geo<T>& g) {
  T coeff = T(0);
  for (int mi = 0; mi < cfg.nrad; ++mi) {
    const double rc_r = cfg.rad_rc[mi];
    const double eta = cfg.rad_eta[mi];
    T rr;
    const bool in_r = radial_in(g.active, g.rm, g.r, rc_r, &rr);
    const T arg = T(CUDART_PI / rc_r) * rr;
    const T fc_r = T(0.5) * (dev_cos(arg) + T(1));
    const T dfc_r = T(-0.5 * CUDART_PI / rc_r) * dev_sin(arg);
    const T e_r = dev_exp(T(-eta) * rr * rr);
    const T dg = in_r ? e_r * (dfc_r - T(2.0 * eta) * rr * fc_r) : T(0);
    coeff = coeff + w_row[mi] * dg;
  }
  return coeff * T(kCfLength);
}

template <typename T, int S>
__global__ void __launch_bounds__(kWarps * 32)
ni_force_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
                const T* __restrict__ dxz, const T* __restrict__ dedg,
                T* __restrict__ fjx, T* __restrict__ fjy,
                T* __restrict__ fjz, long long p, int k,
                const __grid_constant__ NiCfg<T> cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= p) return;            // uniform across the warp
  ForceRow<T, S>& fr =
      reinterpret_cast<ForceRow<T, S>*>(smem)[threadIdx.x >> 5];
  PairRow<T, S>& sh = fr.pr;
  const T* w_row = dedg + row * kNsfSub;
  const T inv_rc = T(1.0 / cfg.rc_a);
  const T dfc_scale = T(-0.5 * CUDART_PI / cfg.rc_a);
  const unsigned lt_mask = (1u << lane) - 1u;

  // compact the slots inside the angular cutoff; a one-slot lane keeps
  // its geometry for the end, wider lanes recompute theirs there
  Geo<T> g0;
  int n_in = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = s * 32 + lane;
    const Geo<T> g = ni_geometry(dxx, dxy, dxz, row * k + slot, slot < k,
                                 cfg.rc_a);
    const unsigned in_mask = __ballot_sync(kFull, g.in_a);
    if (g.in_a) {
      const int c = n_in + __popc(in_mask & lt_mask);
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
    n_in += __popc(in_mask);
    if (s == 0) g0 = g;
  }
  // zero the row's sums
  for (int i = lane; i < n_in; i += 32) {
    fr.acc1[i] = T(0);
    fr.acc2x[i] = T(0);
    fr.acc2y[i] = T(0);
    fr.acc2z[i] = T(0);
  }
  if (lane < cfg.nent) {
    fr.wa[lane] = T(0);
    fr.wc[lane] = T(0);
  }
  __syncwarp();
  // per-function weights dE/dG_col * 2^(1 - zeta) into their entries
  if (lane < cfg.nang) {
    const T w = w_row[cfg.col[lane]] * cfg.coef[lane];
    atomicAdd(&fr.wa[cfg.ent[lane]], w);
    atomicAdd(&fr.wc[cfg.ent[lane]], w * cfg.lam[lane]);
  }
  __syncwarp();

  // angular, tile by tile. Stage 2: one lane a pair. What is symmetric in
  // (j, k) is computed once: r_jk and its cutoff, fc3, r2sum, each shape's
  // f^zeta and zeta f^(zeta - 1), each eta group's exp and sums; then each
  // side's partial in its own leg and its C1, C2, added to both slots' sums.
  const int n_cand = n_in * (n_in - 1) / 2;
  const unsigned magic = div_magic(n_in);
  const T rc_a2 = T(cfg.rc_a * cfg.rc_a);
  int cand = 0;
  do {
    const int n_pair = list_pairs(sh, n_in, n_cand, magic, &cand, lane,
                                  rc_a2);
    for (int base = 0; base < n_pair; base += 32) {
      if (base + lane >= n_pair) continue;
      const int pr = sh.pairs[base + lane];
      const int j = pr & PairRow<T, S>::kMask;
      const int kk = pr >> PairRow<T, S>::kShift;
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

      T p_a, p_e, p_cs;
      angular_sums(cfg, fr.wa, fr.wc, cs, r2sum, &p_a, &p_e, &p_cs);
      // partials of h in the independent variables c, a_j, a_k, rjk
      const T cfl = T(kCfLength);
      const T p_c = fc3 * p_cs;
      const T pe3 = T(-2) * p_e * fc3;
      const T p_jk = rjk * pe3 + fcjk2 * dfc_jk * p_a;
      const T cjk = cfl * p_jk / rjk;
      const T p_aj = aj * pe3 + fr.dfc[j] * fck * fc_jk * p_a;
      const T p_ak = ak * pe3 + fr.dfc[kk] * fcj * fc_jk * p_a;
      const T irj = fr.inv_r[j], irk = fr.inv_r[kk];
      // d(sum w G)/dx_j = C1 u_j + C2 u_k, and the same with j and k
      // exchanged
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
    __syncwarp();                  // the tile is read before it is refilled
  } while (cand < n_cand);

  // each slot: radial d(sum_m w_m G2_m)/d rm, then
  // Fj = -(d sum w G / dx_j): radial +coeff u, angular -(acc1 u + acc2)
  int n_c = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = s * 32 + lane;
    const long long o = row * k + slot;
    Geo<T> g;
    if constexpr (S == 1)
      g = g0;
    else
      g = ni_geometry(dxx, dxy, dxz, o, slot < k, cfg.rc_a);
    const unsigned in_mask = __ballot_sync(kFull, g.in_a);
    const int c = n_c + __popc(in_mask & lt_mask);
    n_c += __popc(in_mask);
    if (!g.active) continue;
    const T coeff = radial_coeff(cfg, w_row, g);
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
}

// ------------------------------------------------- rows of more than 512
// A wider row goes in T = ceil(K / 128) tiles of 128 slots (kCrossSlots = 4
// slots a lane). One warp owns a (row, tile a) unit and streams every tile
// b of the row, a included, through its shared memory: each tile's slots
// inside the angular cutoff compacted in slot order, as in the one-tile
// kernels. Stage 1 lists the ordered leg pairs (p in a, q in b, p != q)
// with r_pq < Rc, p-major, in tiles of kTile; stage 2 walks them one pair a
// lane. Each pair is computed from both of its sides (once by the owner of
// p, once by the owner of q), twice the pair work of the one-tile kernels'
// unordered list, and in exchange no lane ever adds to another unit's sums:
//   ni_g_tiles  g_part [P, T, 32]: unit (row, a) holds the radial G2 of a's
//               slots and 1/2 sum_{p in a} sum_{q != p} of the angular
//               terms (G4's 1/2 over ordered pairs). A lane adds its <= 16
//               pairs of each of kSumEvery = 4 pair tiles, a transposed
//               shuffle tree sums the 32 lanes' function vectors (31
//               shuffles; lane f ends with function f), and lane f adds
//               those batch sums in list order: on a row of ~600 partners
//               no chain passes ~90 roundings, where one running sum a
//               lane across the row would take ~1,350 terms (and a tree
//               after every pair tile costs ~5 % more time). The wrapper
//               sums the T partials in tile order;
//   ni_force_tiles  Fj [P, K] x3: a lane of the owner of p adds p's own
//               side of each pair; the pairs of one round that share p are
//               summed by a segmented shuffle reduction (the list is
//               p-major), whose first lane adds the total to p's sums in
//               shared memory. The per-entry weights are summed in function
//               order by one lane each.
// Both add in an order fixed by the input alone (list order, fixed
// shuffle trees): two runs agree bit for bit.

// One tile's compacted slots inside the angular cutoff
constexpr int kCrossSlots = 4;   // slots a lane of a cross tile (128 a tile)
static_assert(kMaxAng == 32, "ni_g_tiles sums one function a lane");
constexpr int kSumEvery = 4;     // pair tiles a lane adds up between tree sums

template <typename T, int S>
struct CrossTile {
  T ux[32 * S], uy[32 * S], uz[32 * S], a[32 * S], fc[32 * S];
};

template <typename T, int S>
struct CrossG {
  CrossTile<T, S> own, other;
  unsigned short pairs[kTile];     // p | q << 8 (compacted slots)
};

template <typename T, int S>
struct CrossF {
  CrossTile<T, S> own, other;
  T dfc[32 * S], inv_r[32 * S];    // own slots: cutoff derivative, 1 / r
  T acc1[32 * S], acc2x[32 * S], acc2y[32 * S], acc2z[32 * S];
  T wa[kMaxAng], wc[kMaxAng];
  unsigned short pairs[kTile];
};

// Compact the slots of tile `tile` of `row` inside the angular cutoff into
// t, in slot order; returns their count. With dfc, the cutoff goes through
// sincospi (ni_force's form) and dfc / inv_r take each slot's cutoff
// derivative and 1 / r; rm / r / act keep every slot's geometry (ni_g's
// radial sums).
template <typename T, int S>
__device__ __forceinline__ int load_tile(CrossTile<T, S>& t, T* dfc, T* inv_r,
                                         const T* dxx, const T* dxy,
                                         const T* dxz, long long row, int k,
                                         int tile, int lane, double rc_a,
                                         bool (&act)[S], T (&rm)[S],
                                         T (&r)[S]) {
  const T inv_rc = T(1.0 / rc_a);
  const unsigned lt_mask = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = tile * 32 * S + s * 32 + lane;
    const Geo<T> g = ni_geometry(dxx, dxy, dxz, row * k + slot, slot < k,
                                 rc_a);
    const unsigned in_mask = __ballot_sync(kFull, g.in_a);
    if (g.in_a) {
      const int c = n + __popc(in_mask & lt_mask);
      t.ux[c] = g.ux;
      t.uy[c] = g.uy;
      t.uz[c] = g.uz;
      t.a[c] = g.rm;
      if (dfc) {
        T sn, cn;
        dev_sincospi(g.rm * inv_rc, &sn, &cn);
        t.fc[c] = T(0.5) * (cn + T(1));
        dfc[c] = T(-0.5 * CUDART_PI / rc_a) * sn;
        inv_r[c] = g.inv_r;
      } else {
        t.fc[c] = T(0.5) * (dev_cospi(g.rm * inv_rc) + T(1));
      }
    }
    n += __popc(in_mask);
    act[s] = g.active;
    rm[s] = g.rm;
    r[s] = g.r;
  }
  __syncwarp();
  return n;
}

// Stage 1 of both cross-tile kernels: candidates t = pi n_b + qi of (p, q)
// in tiles (ta, tb), 32 a round; those with r_pq < Rc, p != q, go to the
// pair tile. Starts at candidate *cand, stops when the candidates are done
// or the tile could not take another round; advances *cand and returns the
// tile's pairs.
template <typename T, int S>
__device__ __forceinline__ int list_cross(unsigned short* pairs,
                                          const CrossTile<T, S>& ta,
                                          const CrossTile<T, S>& tb,
                                          bool same, int n_b, int n_cand,
                                          unsigned magic, int* cand,
                                          int lane, T rc_a2) {
  const unsigned lt_mask = (1u << lane) - 1u;
  int n_pair = 0;
  int base = *cand;
  for (; base < n_cand && n_pair <= kTile - 32; base += 32) {
    const bool c = base + lane < n_cand;
    const int t = c ? base + lane : 0;
    const int pi = n_b > 1 ? (int)__umulhi((unsigned)t, magic) : t;
    const int qi = t - pi * n_b;
    const T ap = ta.a[pi], aq = tb.a[qi];
    const T cs = ta.ux[pi] * tb.ux[qi] + ta.uy[pi] * tb.uy[qi]
                 + ta.uz[pi] * tb.uz[qi];
    const T r2 = ap * ap + aq * aq - T(2) * ap * aq * cs;
    const bool ok = c && r2 < rc_a2 && !(same && pi == qi);
    const unsigned okm = __ballot_sync(kFull, ok);
    if (ok)
      pairs[n_pair + __popc(okm & lt_mask)] =
          (unsigned short)(pi | (qi << 8));
    n_pair += __popc(okm);
  }
  *cand = base;
  __syncwarp();
  return n_pair;
}

// One level of warp_sum_transposed: lanes O apart swap halves of v[0, 2 O)
// and add, the upper lane keeping the upper half (O a template argument, so
// that every index is a constant and v stays in registers).
template <int O, typename T>
__device__ __forceinline__ void swap_add(T (&v)[32], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const T send = up ? v[i] : v[i + O];
    const T keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// v[f] summed over the warp for every f < 32, the sum of function `lane`
// returned on each lane (16 + 8 + 4 + 2 + 1 shuffles, a fixed tree).
template <typename T>
__device__ __forceinline__ T warp_sum_transposed(T (&v)[32], int lane) {
  swap_add<16>(v, lane);
  swap_add<8>(v, lane);
  swap_add<4>(v, lane);
  swap_add<2>(v, lane);
  swap_add<1>(v, lane);
  return v[0];
}

template <typename T, int S>
__global__ void __launch_bounds__(kWarps * 32)
ni_g_tiles_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
                  const T* __restrict__ dxz, T* __restrict__ g_part,
                  long long units, int nt, int k,
                  const __grid_constant__ NiCfg<T> cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= units) return;       // uniform across the warp
  const long long row = unit / nt;
  const int ta = (int)(unit - row * nt);
  CrossG<T, S>& sh = reinterpret_cast<CrossG<T, S>*>(smem)[threadIdx.x >> 5];
  T* g_row = g_part + unit * kNsfSub;
  if (lane >= cfg.nrad + cfg.nang) g_row[lane] = T(0);

  bool act[S];
  T rm[S], r[S];
  const int n_a = load_tile(sh.own, (T*)nullptr, (T*)nullptr, dxx, dxy, dxz,
                            row, k, ta, lane, cfg.rc_a, act, rm, r);
  // radial G2 of the own tile's slots
  for (int mi = 0; mi < cfg.nrad; ++mi) {
    const double rc_r = cfg.rad_rc[mi];
    const T eta = T(cfg.rad_eta[mi]);
    T v = T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      T rr;
      const bool in_r = radial_in(act[s], rm[s], r[s], rc_r, &rr);
      const T fc_r =
          in_r ? T(0.5) * (dev_cos(T(CUDART_PI / rc_r) * rr) + T(1)) : T(0);
      v = v + dev_exp(-eta * rr * rr) * fc_r;
    }
    v = warp_sum(v);
    if (lane == 0) g_row[mi] = v;
  }

  // angular: the own tile's p against every tile's q, one pair a lane;
  // acc: this lane's terms of the last <= kSumEvery pair tiles; tot: on
  // lane f, function f's sum of the warp's acc, batch by batch
  const T inv_rc = T(1.0 / cfg.rc_a);
  const T rc_a2 = T(cfg.rc_a * cfg.rc_a);
  T acc[kMaxAng];
#pragma unroll
  for (int f = 0; f < kMaxAng; ++f) acc[f] = T(0);
  T tot = T(0);
  int held = 0;
  for (int tb = 0; tb < nt && n_a > 0; ++tb) {
    const bool same = tb == ta;
    const CrossTile<T, S>& ot = same ? sh.own : sh.other;
    const int n_b = same ? n_a
                         : load_tile(sh.other, (T*)nullptr, (T*)nullptr, dxx,
                                     dxy, dxz, row, k, tb, lane, cfg.rc_a,
                                     act, rm, r);
    const int n_cand = n_a * n_b;
    const unsigned magic = div_magic(n_b);
    int cand = 0;
    while (cand < n_cand) {
      const int n_pair = list_cross(sh.pairs, sh.own, ot, same, n_b, n_cand,
                                    magic, &cand, lane, rc_a2);
      for (int base = 0; base < n_pair; base += 32) {
        if (base + lane >= n_pair) continue;
        const int pr = sh.pairs[base + lane];
        const int pi = pr & 0xff, qi = pr >> 8;
        const T ap = sh.own.a[pi], aq = ot.a[qi];
        const T cs = sh.own.ux[pi] * ot.ux[qi] + sh.own.uy[pi] * ot.uy[qi]
                     + sh.own.uz[pi] * ot.uz[qi];
        const T r2 = ap * ap + aq * aq - T(2) * ap * aq * cs;
        const T rpq = dev_sqrt(r2 > T(1.0e-12) ? r2 : T(1.0e-12));
        const T fc_pq = T(0.5) * (dev_cospi(rpq * inv_rc) + T(1));
        const T fc3 = sh.own.fc[pi] * ot.fc[qi] * fc_pq;
        const T r2sum = ap * ap + aq * aq + r2;
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
      if (++held == kSumEvery) {
        tot = tot + warp_sum_transposed(acc, lane);
#pragma unroll
        for (int f = 0; f < kMaxAng; ++f) acc[f] = T(0);
        held = 0;
      }
      __syncwarp();                // the pair tile is read before it is refilled
    }
    __syncwarp();                  // the other tile is read before it is refilled
  }
  tot = tot + warp_sum_transposed(acc, lane);
  if (lane < cfg.nang) g_row[cfg.col[lane]] = T(0.5) * tot;
}

template <typename T, int S>
__global__ void __launch_bounds__(kWarps * 32)
ni_force_tiles_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
                      const T* __restrict__ dxz, const T* __restrict__ dedg,
                      T* __restrict__ fjx, T* __restrict__ fjy,
                      T* __restrict__ fjz, long long units, int nt, int k,
                      const __grid_constant__ NiCfg<T> cfg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= units) return;       // uniform across the warp
  const long long row = unit / nt;
  const int ta = (int)(unit - row * nt);
  CrossF<T, S>& fr = reinterpret_cast<CrossF<T, S>*>(smem)[threadIdx.x >> 5];
  const T* w_row = dedg + row * kNsfSub;
  const T inv_rc = T(1.0 / cfg.rc_a);
  const T dfc_scale = T(-0.5 * CUDART_PI / cfg.rc_a);
  const T rc_a2 = T(cfg.rc_a * cfg.rc_a);
  const unsigned lt_mask = (1u << lane) - 1u;

  bool act[S];
  T rm[S], r[S];
  const int n_a = load_tile(fr.own, fr.dfc, fr.inv_r, dxx, dxy, dxz, row, k,
                            ta, lane, cfg.rc_a, act, rm, r);
  for (int i = lane; i < n_a; i += 32) {
    fr.acc1[i] = T(0);
    fr.acc2x[i] = T(0);
    fr.acc2y[i] = T(0);
    fr.acc2z[i] = T(0);
  }
  // per (group, shape) entry: its functions' dE/dG_col 2^(1 - zeta), in
  // function order
  if (lane < cfg.nent) {
    T s_a = T(0), s_c = T(0);
    for (int f = 0; f < cfg.nang; ++f) {
      if (cfg.ent[f] == lane) {
        const T w = w_row[cfg.col[f]] * cfg.coef[f];
        s_a = s_a + w;
        s_c = s_c + w * cfg.lam[f];
      }
    }
    fr.wa[lane] = s_a;
    fr.wc[lane] = s_c;
  }
  __syncwarp();

  for (int tb = 0; tb < nt && n_a > 0; ++tb) {
    const bool same = tb == ta;
    const CrossTile<T, S>& ot = same ? fr.own : fr.other;
    const int n_b = same ? n_a
                         : load_tile(fr.other, (T*)nullptr, (T*)nullptr, dxx,
                                     dxy, dxz, row, k, tb, lane, cfg.rc_a,
                                     act, rm, r);
    const int n_cand = n_a * n_b;
    const unsigned magic = div_magic(n_b);
    int cand = 0;
    while (cand < n_cand) {
      const int n_pair = list_cross(fr.pairs, fr.own, ot, same, n_b, n_cand,
                                    magic, &cand, lane, rc_a2);
      for (int base = 0; base < n_pair; base += 32) {
        const bool has = base + lane < n_pair;
        // p's own side of the pair: d(sum w G)/dx_p = C1 u_p + C2 u_q
        int key = 1 << 16;         // past every p: lanes without a pair
        T v1 = T(0), v2x = T(0), v2y = T(0), v2z = T(0);
        if (has) {
          const int pr = fr.pairs[base + lane];
          const int pi = pr & 0xff, qi = pr >> 8;
          key = pi;
          const T uqx = ot.ux[qi], uqy = ot.uy[qi], uqz = ot.uz[qi];
          const T ap = fr.own.a[pi], aq = ot.a[qi];
          const T fcp = fr.own.fc[pi], fcq = ot.fc[qi];
          const T cs = fr.own.ux[pi] * uqx + fr.own.uy[pi] * uqy
                       + fr.own.uz[pi] * uqz;
          const T r2 = ap * ap + aq * aq - T(2) * ap * aq * cs;
          const T rpq = dev_sqrt(r2 > T(1.0e-12) ? r2 : T(1.0e-12));
          T sn, cn;
          dev_sincospi(rpq * inv_rc, &sn, &cn);
          const T fc_pq = T(0.5) * (cn + T(1));
          const T dfc_pq = dfc_scale * sn;
          const T fcpq2 = fcp * fcq;
          const T fc3 = fcpq2 * fc_pq;
          const T r2sum = ap * ap + aq * aq + r2;
          T p_a, p_e, p_cs;
          angular_sums(cfg, fr.wa, fr.wc, cs, r2sum, &p_a, &p_e, &p_cs);
          const T cfl = T(kCfLength);
          const T p_c = fc3 * p_cs;
          const T pe3 = T(-2) * p_e * fc3;
          const T p_pq = rpq * pe3 + fcpq2 * dfc_pq * p_a;
          const T cpq = cfl * p_pq / rpq;
          const T p_ap = ap * pe3 + fr.dfc[pi] * fcq * fc_pq * p_a;
          const T irp = fr.inv_r[pi];
          v1 = p_c * cs * irp - cfl * p_ap - cpq * ap;
          const T c2 = cpq * aq - p_c * irp;
          v2x = c2 * uqx;
          v2y = c2 * uqy;
          v2z = c2 * uqz;
        }
        // segmented suffix sums over the lanes of one p (keys ascend)
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int ko = __shfl_down_sync(kFull, key, o);
          const T d1 = __shfl_down_sync(kFull, v1, o);
          const T dx = __shfl_down_sync(kFull, v2x, o);
          const T dy = __shfl_down_sync(kFull, v2y, o);
          const T dz = __shfl_down_sync(kFull, v2z, o);
          if (lane + o < 32 && ko == key) {
            v1 = v1 + d1;
            v2x = v2x + dx;
            v2y = v2y + dy;
            v2z = v2z + dz;
          }
        }
        const int kprev = __shfl_up_sync(kFull, key, 1);
        if (has && (lane == 0 || kprev != key)) {
          fr.acc1[key] = fr.acc1[key] + v1;
          fr.acc2x[key] = fr.acc2x[key] + v2x;
          fr.acc2y[key] = fr.acc2y[key] + v2y;
          fr.acc2z[key] = fr.acc2z[key] + v2z;
        }
        __syncwarp();
      }
    }
    __syncwarp();                  // the other tile is read before it is refilled
  }

  // each own slot: Fj = radial +coeff u, angular -(acc1 u + acc2)
  int n_c = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = ta * 32 * S + s * 32 + lane;
    const long long o = row * k + slot;
    const Geo<T> g = ni_geometry(dxx, dxy, dxz, o, slot < k, cfg.rc_a);
    const unsigned in_mask = __ballot_sync(kFull, g.in_a);
    const int c = n_c + __popc(in_mask & lt_mask);
    n_c += __popc(in_mask);
    if (!g.active) continue;
    const T coeff = radial_coeff(cfg, w_row, g);
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
}

inline unsigned n_blocks(long long p) {
  return (unsigned)((p + kWarps - 1) / kWarps);
}

// Launch kern with smem bytes of dynamic shared memory, first raising the
// instance's limit where it needs more than the default 48 KB.
template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int S>
int launch_g_s(const void* dxx, const void* dxy, const void* dxz, void* g,
               long long p, int k, const void* cfg, cudaStream_t stream) {
  constexpr size_t smem = kWarps * sizeof(PairRow<T, S>);
  static const int attr = set_smem(ni_g_kernel<T, S>, smem);
  if (attr != 0) return attr;
  ni_g_kernel<T, S><<<n_blocks(p), kWarps * 32, smem, stream>>>(
      (const T*)dxx, (const T*)dxy, (const T*)dxz, (T*)g, p, k,
      *(const NiCfg<T>*)cfg);
  return (int)cudaGetLastError();
}

template <typename T, int S>
int launch_force_s(const void* dxx, const void* dxy, const void* dxz,
                   const void* dedg, void* fjx, void* fjy, void* fjz,
                   long long p, int k, const void* cfg,
                   cudaStream_t stream) {
  constexpr size_t smem = kWarps * sizeof(ForceRow<T, S>);
  static const int attr = set_smem(ni_force_kernel<T, S>, smem);
  if (attr != 0) return attr;
  ni_force_kernel<T, S><<<n_blocks(p), kWarps * 32, smem, stream>>>(
      (const T*)dxx, (const T*)dxy, (const T*)dxz, (const T*)dedg,
      (T*)fjx, (T*)fjy, (T*)fjz, p, k, *(const NiCfg<T>*)cfg);
  return (int)cudaGetLastError();
}

// slots a lane: the instance for K
#define NI_BY_SLOTS(k, call)                                            \
  ((k) <= 32 ? call(1) : (k) <= 64 ? call(2) : (k) <= 128 ? call(4)     \
   : (k) <= 256 ? call(8) : (k) <= 512 ? call(16)                       \
   : (int)cudaErrorInvalidValue)

template <typename T>
int launch_g(const void* dxx, const void* dxy, const void* dxz, void* g,
             long long p, int k, const void* cfg, void* stream) {
  if (p <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define NI_G(S) launch_g_s<T, S>(dxx, dxy, dxz, g, p, k, cfg, st)
  return NI_BY_SLOTS(k, NI_G);
#undef NI_G
}

template <typename T>
int launch_force(const void* dxx, const void* dxy, const void* dxz,
                 const void* dedg, void* fjx, void* fjy, void* fjz,
                 long long p, int k, const void* cfg, void* stream) {
  if (p <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define NI_F(S) \
  launch_force_s<T, S>(dxx, dxy, dxz, dedg, fjx, fjy, fjz, p, k, cfg, st)
  return NI_BY_SLOTS(k, NI_F);
#undef NI_F
}

template <typename T, int S>
int launch_g_tiles_s(const void* dxx, const void* dxy, const void* dxz,
                     void* g_part, long long p, int k, const void* cfg,
                     cudaStream_t stream) {
  constexpr size_t smem = kWarps * sizeof(CrossG<T, S>);
  static const int attr = set_smem(ni_g_tiles_kernel<T, S>, smem);
  if (attr != 0) return attr;
  const int nt = (k + 32 * S - 1) / (32 * S);
  const long long units = p * nt;
  ni_g_tiles_kernel<T, S><<<n_blocks(units), kWarps * 32, smem, stream>>>(
      (const T*)dxx, (const T*)dxy, (const T*)dxz, (T*)g_part, units, nt, k,
      *(const NiCfg<T>*)cfg);
  return (int)cudaGetLastError();
}

template <typename T, int S>
int launch_force_tiles_s(const void* dxx, const void* dxy, const void* dxz,
                         const void* dedg, void* fjx, void* fjy, void* fjz,
                         long long p, int k, const void* cfg,
                         cudaStream_t stream) {
  constexpr size_t smem = kWarps * sizeof(CrossF<T, S>);
  static const int attr = set_smem(ni_force_tiles_kernel<T, S>, smem);
  if (attr != 0) return attr;
  const int nt = (k + 32 * S - 1) / (32 * S);
  const long long units = p * nt;
  ni_force_tiles_kernel<T, S><<<n_blocks(units), kWarps * 32, smem,
                                stream>>>(
      (const T*)dxx, (const T*)dxy, (const T*)dxz, (const T*)dedg,
      (T*)fjx, (T*)fjy, (T*)fjz, units, nt, k, *(const NiCfg<T>*)cfg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_g_tiles(const void* dxx, const void* dxy, const void* dxz,
                   void* g_part, long long p, int k, const void* cfg,
                   void* stream) {
  if (p <= 0) return 0;
  return launch_g_tiles_s<T, kCrossSlots>(dxx, dxy, dxz, g_part, p, k, cfg,
                                          (cudaStream_t)stream);
}

template <typename T>
int launch_force_tiles(const void* dxx, const void* dxy, const void* dxz,
                       const void* dedg, void* fjx, void* fjy, void* fjz,
                       long long p, int k, const void* cfg, void* stream) {
  if (p <= 0) return 0;
  return launch_force_tiles_s<T, kCrossSlots>(dxx, dxy, dxz, dedg, fjx, fjy,
                                              fjz, p, k, cfg,
                                              (cudaStream_t)stream);
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

// rows of K > 512 in tiles of 128 slots: g_part [P, T, 32],
// T = ceil(K / 128)
int ni_g_tiles_f32(const void* dxx, const void* dxy, const void* dxz,
                   void* g_part, long long p, int k, const void* cfg,
                   void* stream) {
  return launch_g_tiles<float>(dxx, dxy, dxz, g_part, p, k, cfg, stream);
}

int ni_g_tiles_f64(const void* dxx, const void* dxy, const void* dxz,
                   void* g_part, long long p, int k, const void* cfg,
                   void* stream) {
  return launch_g_tiles<double>(dxx, dxy, dxz, g_part, p, k, cfg, stream);
}

int ni_force_tiles_f32(const void* dxx, const void* dxy, const void* dxz,
                       const void* dedg, void* fjx, void* fjy, void* fjz,
                       long long p, int k, const void* cfg, void* stream) {
  return launch_force_tiles<float>(dxx, dxy, dxz, dedg, fjx, fjy, fjz, p, k,
                                   cfg, stream);
}

int ni_force_tiles_f64(const void* dxx, const void* dxy, const void* dxz,
                       const void* dedg, void* fjx, void* fjy, void* fjz,
                       long long p, int k, const void* cfg, void* stream) {
  return launch_force_tiles<double>(dxx, dxy, dxz, dedg, fjx, fjy, fjz, p, k,
                                    cfg, stream);
}

}  // extern "C"
