// Harmonic-path ANNP kernels for Hopper (sm_90a), plain C interface.
//
// g_harm replaces the TPU kernel `_g_kernel_harm`
// (meng_zhang_tpu/ops/pallas_annp.py:299); force_harm replaces
// `_force_kernel_harm` (:352). Both work on [P, K] displacement planes
// dx = x_i - x_j, 1 <= K <= 512 (filler lanes carry dx = 2 box + 10 and
// give 0).
//
// What bounds them on this card: per pair both kernels run the real
// spherical-harmonic ladder to L = ntsf - 1 (190 (l, m) steps at L = 18)
// against 12 bytes of dx read per pair, so instruction issue bounds them,
// not memory. The design spends the issue on the ladder:
//
//   g_harm: one warp per atom row, several rows per block. Lane l holds
//     the row's slots l, l + 32, ... (NS = ceil(K / 32) of them, a template
//     parameter, so the slot state stays in registers) and sums their terms
//     of a column in registers. One butterfly then reduces two columns at
//     once: its first stage (xor 16) trades halves, so the four stages
//     after it carry the first column in the lower half-warp and the second
//     in the upper one: 5 shuffles for 2 of the row's 371 columns. Totals
//     land in a per-warp shared buffer, from which the warp writes A and
//     the S_l pass as coalesced rows. No block-wide barrier. A row of up
//     to 256 slots is one tile (NS <= 8); a wider one (K <= 512) is walked
//     in two tiles of NS = ceil(K / 64) slots a lane, the second adding its
//     column totals to the first's in the buffer: the slot state of 16
//     slots a lane would not fit the registers, and the fixed order keeps
//     the kernel deterministic.
//   force_harm: one thread per lane (no reduction); B is staged in shared
//     memory once per block of rows and read as (cos, sin) vector pairs.
//     A row of more than 256 lanes is split over two blocks (blockIdx.y),
//     each staging the row's B.
//     The per-m sums are factored: with P = sum_l H_lm B_lm and
//     Q = sum_l dH_lm/du_z B_lm for the cosine and sine columns, an (l, m)
//     step costs its two recurrences (four instructions) and four FMAs,
//     and the (x + iy)^m factors multiply once per m. The ladder is
//     unrolled at compile time, one instance for each ntsf (1-19; the
//     launch picks it by ntsf, as g_harm's by slots a lane), so each
//     coefficient is read from the constant bank at a fixed offset and no
//     index arithmetic or branch remains.
//
// Both kernels run the plain versions' ladder rescaled. H_lm = s_lm K_lm,
// with s_lm = e2_lm s_(l-2)m (s_mm = s_(m+1)m = 1), turns
// H_lm = e1 u_z H_(l-1)m - e2 H_(l-2)m into K_lm = a_lm u_z K_(l-1)m -
// K_(l-2)m, a_lm = e1_lm s_(l-1)m / s_lm: one multiply less a step for H
// and one for dH/du_z. g_harm scales each column total by s_lm; force_harm
// stages s_lm B_lm. At L = 18, s_lm lies in [0.64, 1.13]. The coefficients
// (h0, d1, a, s; they depend on L alone) travel in each launch's parameter
// block (`__grid_constant__`, constant bank 0): nothing is staged per
// block, and no launch can read another width's table.
//
// Layouts (identical to the TPU kernels' outputs):
//   g    [P, 128]: cols [0, npsf) radial G_m, [npsf, npsf + ntsf) S_l,
//                  npsf + ntsf F2 = sum fc^2, rest 0
//   a    [P, 384]: A_lm in m-major / l-ascending / cosine-then-sine order
//                  (361 columns at L = 18), rest 0
//   dedg [P, 128]: radial dE/dG in cols [0, npsf)
//   b    [P, 384]: B_lm in the A layout, then 2q in column n_harm
//   tab  host float64 [h0 (L+1) | d1 (L+1) | e1 (L+1)^2 | e2 (L+1)^2],
//        e1/e2 at l * (L + 1) + m (ops/fused_annp.py:ladder_table)
#include "pair_geometry.cuh"

namespace {

using annp::Pair;
using annp::pair_geometry;
using annp::radial_coeff;
using annp::warp_sum;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNsfPad = 128;
constexpr int kAbPad = 384;
constexpr int kL = 19;                     // ntsf <= 19 (L <= 18)
constexpr int kMaxNs = 8;                  // slots a lane in one tile
constexpr int kGTiles = 2;                 // g_harm: tiles of a wide row
constexpr int kMaxK = kGTiles * 32 * kMaxNs;   // K <= 512
constexpr int kGWarps = 4;                 // g_harm: rows (warps) a block
constexpr int kGBuf = kAbPad + kNsfPad;    // g_harm: a warp's column totals
constexpr int kFThreads = 256;             // force_harm: threads a block
constexpr int kBRow = kAbPad + 2;          // force_harm: staged B row, even

template <typename T>
struct Ladder {
  T h0[kL], d1[kL];
  T alpha[kL * kL];     // a_lm at l * kL + m, l >= m + 2
  T scale[kAbPad];      // s_lm of each A/B column in its layout, 1 after
};

template <typename T>
struct GArgs {
  const T* dxx;
  const T* dxy;
  const T* dxz;
  T* g;
  T* a;
  long long p;
  int k, npsf, ntsf;
  double rc;
  Ladder<T> lad;
};

template <typename T>
struct FArgs {
  const T* dxx;
  const T* dxy;
  const T* dxz;
  const T* dedg;
  const T* b;
  T* fjx;
  T* fjy;
  T* fjz;
  long long p;
  int k, npsf;
  double rc;
  Ladder<T> lad;
};

// The rescaled ladder (see the top of this file) from the plain table.
template <typename T>
Ladder<T> make_ladder(const double* tab, int nl) {
  const double* e1 = tab + 2 * nl;
  const double* e2 = e1 + nl * nl;
  double s[kL][kL] = {};   // s[l][m]
  Ladder<T> lad = {};
  for (int m = 0; m < nl; ++m) {
    lad.h0[m] = T(tab[m]);
    lad.d1[m] = T(tab[nl + m]);
    s[m][m] = 1.0;
    if (m + 1 < nl) s[m + 1][m] = 1.0;
    for (int l = m + 2; l < nl; ++l) {
      s[l][m] = e2[l * nl + m] * s[l - 2][m];
      lad.alpha[l * kL + m] = T(e1[l * nl + m] * s[l - 1][m] / s[l][m]);
    }
  }
  int col = 0;
  for (int m = 0; m < nl; ++m)
    for (int l = m; l < nl; ++l) {
      lad.scale[col++] = T(s[l][m]);
      if (m > 0) lad.scale[col++] = T(s[l][m]);
    }
  for (; col < kAbPad; ++col) lad.scale[col] = T(1);
  return lad;
}

template <typename T>
__device__ __forceinline__ T load_dx(const T* plane, long long row, int k,
                                     int j) {
  return j < k ? __ldg(plane + row * k + j) : T(0);
}

// ------------------------------------------------------------------ g_harm
// Stores v in *dst, or adds it to what *dst holds when add is set (the
// second tile of a wide row).
template <typename T>
__device__ __forceinline__ void put_total(T* dst, T v, bool add) {
  *dst = add ? *dst + v : v;
}

// Sums a and b over the warp with 5 shuffles (lane 0 holds a's total,
// lane 16 b's) and stores them, times sa and sb, in buf[ca] and buf[cb]
// (adds them there with add).
template <typename T>
__device__ __forceinline__ void pair_sum_store(T a, int ca, T sa, T b,
                                               int cb, T sb, T* buf,
                                               int lane, bool add) {
  const bool hi = lane & 16;
  T v = hi ? b : a;
  v += __shfl_xor_sync(kFull, hi ? a : b, 16);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if ((lane & 15) == 0) put_total(buf + (hi ? cb : ca), v * (hi ? sb : sa),
                                  add);
}

// Pairs a stream of single columns (value, column, scale) for
// pair_sum_store; flush() sums a column left over alone.
template <typename T>
struct ColumnPairer {
  T* buf;
  int lane;
  bool add;
  T held = T(0), held_scale = T(1);
  int held_col = -1;

  __device__ __forceinline__ void put(T v, int col, T scale = T(1)) {
    if (held_col < 0) {
      held = v;
      held_col = col;
      held_scale = scale;
    } else {
      pair_sum_store(held, held_col, held_scale, v, col, scale, buf, lane,
                     add);
      held_col = -1;
    }
  }
  __device__ __forceinline__ void flush() {
    if (held_col >= 0) {
      const T s = warp_sum(held);
      if (lane == 0) put_total(buf + held_col, s * held_scale, add);
      held_col = -1;
    }
  }
};

// One tile of a row: the column totals of slots slot0 + lane + 32 s,
// s < NS, into buf (added to what buf holds with add). A lane writes the
// same columns in every tile, so the tiles need no barrier between them.
template <typename T, int NS>
__device__ __forceinline__ void g_tile(const GArgs<T>& args, long long row,
                                       int lane, int slot0, bool add,
                                       T* buf) {
  const Ladder<T>& lad = args.lad;
  const int npsf = args.npsf;
  const int nl = args.ntsf;
  const int lmax = nl - 1;
  ColumnPairer<T> cols{buf, lane, add};

  // slot s is neighbor lane j = slot0 + lane + 32 s; lanes past K read
  // dx = 0, which pair_geometry masks as it masks a filler lane
  T fc[NS], ux[NS], uy[NS], uz[NS], xch[NS], tp[NS], tc[NS];
  T v0 = T(0), v1 = T(0), f2 = T(0);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int j = slot0 + lane + 32 * s;
    const Pair<T> q = pair_geometry(load_dx(args.dxx, row, args.k, j),
                                    load_dx(args.dxy, row, args.k, j),
                                    load_dx(args.dxz, row, args.k, j),
                                    args.rc);
    fc[s] = q.fc;
    ux[s] = q.ux;
    uy[s] = q.uy;
    uz[s] = q.uz;
    xch[s] = T(2) * q.r / T(args.rc) - T(1);
    tp[s] = q.m;
    tc[s] = xch[s] * q.m;
    v0 += tp[s] * q.fc;
    v1 += tc[s] * q.fc;
    f2 += q.fc * q.fc;
  }

  // radial G_m = sum_j T_m(2r/rc - 1) fc_j, then F2
  cols.put(v0, kAbPad);
  cols.put(v1, kAbPad + 1);
  for (int n = 2; n < npsf; ++n) {
    T v = T(0);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const T tn = T(2) * xch[s] * tc[s] - tp[s];
      tp[s] = tc[s];
      tc[s] = tn;
      v += tn * fc[s];
    }
    cols.put(v, kAbPad + n);
  }
  cols.put(f2, kAbPad + npsf);

  // A_lm = s_lm sum_j fc_j K_lm(u_z) (x + iy)^m: m-major ladder. cw + i sw
  // carries fc (x + iy)^m, so it is 0 on masked lanes and K_mm = h0[m]
  // needs no mask there.
  T cw[NS], sw[NS], h1[NS], h2[NS];
  T v = T(0);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    cw[s] = fc[s];
    sw[s] = T(0);
    h1[s] = lad.h0[0];
    v += h1[s] * cw[s];
  }
  cols.put(v, 0);
  if (lmax >= 1) {
    v = T(0);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      h2[s] = h1[s];
      h1[s] = lad.d1[0] * uz[s] * h2[s];
      v += h1[s] * cw[s];
    }
    cols.put(v, 1);
  }
  for (int ll = 2; ll <= lmax; ++ll) {
    const T al = lad.alpha[ll * kL];
    v = T(0);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const T h = al * uz[s] * h1[s] - h2[s];
      h2[s] = h1[s];
      h1[s] = h;
      v += h * cw[s];
    }
    cols.put(v, ll, lad.scale[ll]);
  }
  cols.flush();

  int col = nl;   // first column of the m = 1 block
  for (int mm = 1; mm <= lmax; ++mm) {
    T vc = T(0), vs = T(0);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const T c2 = ux[s] * cw[s] - uy[s] * sw[s];
      const T s2 = ux[s] * sw[s] + uy[s] * cw[s];
      cw[s] = c2;
      sw[s] = s2;
      h1[s] = lad.h0[mm];
      vc += h1[s] * cw[s];
      vs += h1[s] * sw[s];
    }
    pair_sum_store(vc, col, T(1), vs, col + 1, T(1), buf, lane, add);
    col += 2;
    if (mm < lmax) {
      const T d1 = lad.d1[mm];
      vc = vs = T(0);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        h2[s] = h1[s];
        h1[s] = d1 * uz[s] * h2[s];
        vc += h1[s] * cw[s];
        vs += h1[s] * sw[s];
      }
      pair_sum_store(vc, col, T(1), vs, col + 1, T(1), buf, lane, add);
      col += 2;
    }
    for (int ll = mm + 2; ll <= lmax; ++ll) {
      const T al = lad.alpha[ll * kL + mm], sc = lad.scale[col];
      vc = vs = T(0);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const T h = al * uz[s] * h1[s] - h2[s];
        h2[s] = h1[s];
        h1[s] = h;
        vc += h * cw[s];
        vs += h * sw[s];
      }
      pair_sum_store(vc, col, sc, vs, col + 1, sc, buf, lane, add);
      col += 2;
    }
  }
}

// NS slots a lane in each of NT tiles (NT = 1 for K <= 256, 2 above)
template <typename T, int NS, int NT>
__global__ void __launch_bounds__(kGWarps * 32)
    g_harm_kernel(const __grid_constant__ GArgs<T> args) {
  __shared__ T bufs[kGWarps][kGBuf];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kGWarps + warp;
  if (row >= args.p) return;   // whole warps leave; no block-wide barrier
  T* buf = bufs[warp];
  const int npsf = args.npsf;
  const int nl = args.ntsf;
#pragma unroll 1
  for (int t = 0; t < NT; ++t)
    g_tile<T, NS>(args, row, lane, 32 * NS * t, t > 0, buf);
  __syncwarp();

  const int n_harm = nl * nl;
  T* a_row = args.a + row * kAbPad;
  for (int c = lane; c < kAbPad; c += 32)
    a_row[c] = c < n_harm ? buf[c] : T(0);
  T* g_row = args.g + row * kNsfPad;
  for (int c = lane; c < kNsfPad; c += 32) {
    T s = T(0);
    if (c < npsf) {
      s = buf[kAbPad + c];
    } else if (c < npsf + nl) {
      // S_l = sum_m A_lm^2, m ascending as in the TPU kernel
      const int l = c - npsf;
      const T a0 = buf[l];
      s = a0 * a0;
      int off = nl;                     // first column of the m = 1 block
      for (int mm = 1; mm <= l; ++mm) {
        const T ac = buf[off + 2 * (l - mm)];
        const T as = buf[off + 2 * (l - mm) + 1];
        s += ac * ac + as * as;
        off += 2 * (nl - mm);
      }
    } else if (c == npsf + nl) {
      s = buf[kAbPad + npsf];
    }
    g_row[c] = s;
  }
}

// -------------------------------------------------------------- force_harm
template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

template <typename T>
__device__ __forceinline__ typename Vec2<T>::type load2(const T* p) {
  return *reinterpret_cast<const typename Vec2<T>::type*>(p);
}

// Staged-row column of B_mm (the cosine entry of (l = m, m)): the m = 0
// block holds nl columns, block m' >= 1 holds 2 (nl - m').
__host__ __device__ constexpr int block_col(int nl, int mm) {
  return mm == 0 ? 0 : nl + (mm - 1) * (2 * nl - mm);
}

// K_lm and dK_lm/du_z for l >= m + 2 from the two rows before them (the
// rescaled recurrence of force_harm_plain); shifts the two-row history.
template <typename T>
__device__ __forceinline__ void recur(T al, T uz, T& h1, T& h2, T& hd1,
                                      T& hd2) {
  const T h = al * uz * h1 - h2;
  const T hd = al * (h1 + uz * hd1) - hd2;
  h2 = h1;
  h1 = h;
  hd2 = hd1;
  hd1 = hd;
}

// The m = 0 block (cosine columns only, at bsh[l], staged as s B):
// pc = sum_l H_l0 B_l0, qc = sum_l dH_l0 B_l0.
template <typename T, int NL>
__device__ __forceinline__ void m0_sums(const Ladder<T>& lad, const T* bsh,
                                        T msk, T uz, T& pc, T& qc) {
  T h1 = lad.h0[0] * msk, h2 = T(0), hd1 = T(0), hd2 = T(0);
  pc = h1 * bsh[0];
  qc = T(0);
  if constexpr (NL > 1) {
    const T d1 = lad.d1[0];
    h2 = h1;
    h1 = d1 * uz * h2;
    hd1 = d1 * h2;
    pc += h1 * bsh[1];
    qc += hd1 * bsh[1];
  }
#pragma unroll
  for (int ll = 2; ll < NL; ++ll) {
    recur(lad.alpha[ll * kL], uz, h1, h2, hd1, hd2);
    pc += h1 * bsh[ll];
    qc += hd1 * bsh[ll];
  }
}

// Block m >= 1, whose (cos, sin) B pairs start at bp (16-byte aligned for
// double2): the four sums P_c, P_s, Q_c, Q_s.
template <typename T, int NL, int MM>
__device__ __forceinline__ void m_sums(const Ladder<T>& lad, const T* bp,
                                       T msk, T uz, T& pc, T& ps, T& qc,
                                       T& qs) {
  auto bv = load2(bp);
  T h1 = lad.h0[MM] * msk, h2 = T(0), hd1 = T(0), hd2 = T(0);
  pc = h1 * bv.x;
  ps = h1 * bv.y;
  qc = qs = T(0);
  if constexpr (MM + 1 < NL) {
    const T d1 = lad.d1[MM];
    h2 = h1;
    h1 = d1 * uz * h2;
    hd1 = d1 * h2;
    bv = load2(bp + 2);
    pc += h1 * bv.x;
    ps += h1 * bv.y;
    qc += hd1 * bv.x;
    qs += hd1 * bv.y;
  }
#pragma unroll
  for (int ll = MM + 2; ll < NL; ++ll) {
    recur(lad.alpha[ll * kL + MM], uz, h1, h2, hd1, hd2);
    bv = load2(bp + 2 * (ll - MM));
    pc += h1 * bv.x;
    ps += h1 * bv.y;
    qc += hd1 * bv.x;
    qs += hd1 * bv.y;
  }
}

// Running sums over the m blocks: SY = sum B Y and G = sum B dY/du.
template <typename T>
struct Angular {
  T cm, sm, sy, gx, gy, gz;
};

// Blocks m = M .. NL - 1: advance (x + iy)^m, then fold the block's four
// sums in (compile-time recursion, so every index is a constant).
template <typename T, int NL, int M>
__device__ __forceinline__ void m_blocks(const Ladder<T>& lad, const T* bsh,
                                         const Pair<T>& q, Angular<T>& st) {
  if constexpr (M < NL) {
    const T cm1 = st.cm, sm1 = st.sm;
    st.cm = q.ux * cm1 - q.uy * sm1;
    st.sm = q.ux * sm1 + q.uy * cm1;
    T pc, ps, qc, qs;
    m_sums<T, NL, M>(lad, bsh + block_col(NL, M), q.m, q.uz, pc, ps, qc,
                     qs);
    st.sy += st.cm * pc + st.sm * ps;
    st.gz += st.cm * qc + st.sm * qs;
    const T fm = T(M);
    st.gx += fm * (cm1 * pc + sm1 * ps);
    st.gy += fm * (cm1 * ps - sm1 * pc);
    m_blocks<T, NL, M + 1>(lad, bsh, q, st);
  }
}

// NL: ntsf, fixed at compile time, so the whole ladder unrolls
template <typename T, int NL>
__global__ void __launch_bounds__(kFThreads)
    force_harm_kernel(const __grid_constant__ FArgs<T> args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const Ladder<T>& lad = args.lad;
  const int npsf = args.npsf;
  const int rows = blockDim.y;
  const long long row0 = (long long)blockIdx.x * rows;
  // B is staged as s B, one column to the right when NL is odd, so that
  // every (cos, sin) pair of the m >= 1 blocks starts at an even column
  constexpr int shift = NL & 1;
  constexpr int nb = NL * NL + 1;             // B_lm, then 2q
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  for (int r = 0; r < rows && row0 + r < args.p; ++r) {
    for (int c = tid; c < nb; c += nthr)
      smem[r * kBRow + shift + c] =
          __ldg(args.b + (row0 + r) * kAbPad + c) * lad.scale[c];
    for (int c = tid; c < npsf; c += nthr)
      smem[rows * kBRow + r * kNsfPad + c] =
          __ldg(args.dedg + (row0 + r) * kNsfPad + c);
  }
  __syncthreads();
  const long long row = row0 + threadIdx.y;
  // a row wider than one block's lanes is split over blockIdx.y
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  if (row >= args.p || lane >= args.k) return;
  const T* bsh = smem + threadIdx.y * kBRow + shift;
  const T* wn = smem + rows * kBRow + threadIdx.y * kNsfPad;

  const long long o = row * args.k + lane;
  const Pair<T> q = pair_geometry(__ldg(args.dxx + o), __ldg(args.dxy + o),
                                  __ldg(args.dxz + o), args.rc);

  // radial: coeff = sum_n w_n (T'_n (2/rc) fc + T_n dfc)
  const T coeff = radial_coeff(q, wn, npsf, args.rc);

  // angular: SY = sum B Y, (Gx, Gy, Gz) = sum B dY/du
  T pc, qc;
  m0_sums<T, NL>(lad, bsh, q.m, q.uz, pc, qc);
  Angular<T> st = {q.m, T(0), q.m * pc, T(0), T(0), q.m * qc};
  m_blocks<T, NL, 1>(lad, bsh, q, st);
  const T q2 = bsh[NL * NL];   // column n_harm carries 2q, not a harmonic
  const T udotg = q.ux * st.gx + q.uy * st.gy + q.uz * st.gz;
  const T pref = q.dfc * (st.sy + q2 * q.fc) + q.fc * q.inv_r * (-udotg);
  const T fcr = q.fc * q.inv_r;
  args.fjx[o] = (coeff + pref) * q.ux + fcr * st.gx;
  args.fjy[o] = (coeff + pref) * q.uy + fcr * st.gy;
  args.fjz[o] = (coeff + pref) * q.uz + fcr * st.gz;
}

// ---------------------------------------------------------------- launches
// The instance of NT tiles of ns slots a lane: NS runs from NS0 (1 for
// one tile; 5 for two, the least that a row above 256 slots needs) to
// kMaxNs
template <typename T, int NT, int NS>
void launch_g_ns(const GArgs<T>& args, int ns, cudaStream_t stream) {
  if constexpr (NS < kMaxNs) {
    if (ns > NS) {
      launch_g_ns<T, NT, NS + 1>(args, ns, stream);
      return;
    }
  }
  const unsigned blocks = (unsigned)((args.p + kGWarps - 1) / kGWarps);
  g_harm_kernel<T, NS, NT><<<blocks, kGWarps * 32, 0, stream>>>(args);
}

template <typename T>
int launch_g(const void* dxx, const void* dxy, const void* dxz,
             const void* tab, void* g, void* a, long long p, int k, int npsf,
             int ntsf, double rc, void* stream) {
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  if (p > 0) {
    GArgs<T> args = {(const T*)dxx, (const T*)dxy, (const T*)dxz, (T*)g,
                     (T*)a, p, k, npsf, ntsf, rc,
                     make_ladder<T>((const double*)tab, ntsf)};
    const int ns = (k + 31) / 32;
    if (ns <= kMaxNs)
      launch_g_ns<T, 1, 1>(args, ns, (cudaStream_t)stream);
    else
      launch_g_ns<T, kGTiles, kMaxNs / 2 + 1>(
          args, (ns + kGTiles - 1) / kGTiles, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NL = 1>
void launch_force_nl(const FArgs<T>& args, int ntsf, dim3 grid, dim3 block,
                     size_t smem, cudaStream_t stream) {
  if constexpr (NL < kL) {
    if (ntsf > NL) {
      launch_force_nl<T, NL + 1>(args, ntsf, grid, block, smem, stream);
      return;
    }
  }
  force_harm_kernel<T, NL><<<grid, block, smem, stream>>>(args);
}

template <typename T>
int launch_force(const void* dxx, const void* dxy, const void* dxz,
                 const void* dedg, const void* b, const void* tab, void* fjx,
                 void* fjy, void* fjz, long long p, int k, int npsf, int ntsf,
                 double rc, void* stream) {
  if (k > kMaxK) return (int)cudaErrorInvalidValue;
  if (p > 0) {
    FArgs<T> args = {(const T*)dxx, (const T*)dxy, (const T*)dxz,
                     (const T*)dedg, (const T*)b, (T*)fjx, (T*)fjy, (T*)fjz,
                     p, k, npsf, rc,
                     make_ladder<T>((const double*)tab, ntsf)};
    // a row's lanes over ny blocks of <= kFThreads threads, evenly
    const int ny = (k + kFThreads - 1) / kFThreads;
    const int lanes = annp::block_threads((k + ny - 1) / ny);
    const int rows = kFThreads / lanes > 1 ? kFThreads / lanes : 1;
    const dim3 grid((unsigned)((p + rows - 1) / rows), (unsigned)ny);
    launch_force_nl<T>(args, ntsf, grid, dim3(lanes, rows),
                       sizeof(T) * rows * (kBRow + kNsfPad),
                       (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int annp_g_harm_f32(const void* dxx, const void* dxy, const void* dxz,
                    const void* tab, void* g, void* a, long long p, int k,
                    int npsf, int ntsf, double rc, void* stream) {
  return launch_g<float>(dxx, dxy, dxz, tab, g, a, p, k, npsf, ntsf, rc,
                         stream);
}

int annp_g_harm_f64(const void* dxx, const void* dxy, const void* dxz,
                    const void* tab, void* g, void* a, long long p, int k,
                    int npsf, int ntsf, double rc, void* stream) {
  return launch_g<double>(dxx, dxy, dxz, tab, g, a, p, k, npsf, ntsf, rc,
                          stream);
}

int annp_force_harm_f32(const void* dxx, const void* dxy, const void* dxz,
                        const void* dedg, const void* b, const void* tab,
                        void* fjx, void* fjy, void* fjz, long long p, int k,
                        int npsf, int ntsf, double rc, void* stream) {
  return launch_force<float>(dxx, dxy, dxz, dedg, b, tab, fjx, fjy, fjz, p, k,
                             npsf, ntsf, rc, stream);
}

int annp_force_harm_f64(const void* dxx, const void* dxy, const void* dxz,
                        const void* dedg, const void* b, const void* tab,
                        void* fjx, void* fjy, void* fjz, long long p, int k,
                        int npsf, int ntsf, double rc, void* stream) {
  return launch_force<double>(dxx, dxy, dxz, dedg, b, tab, fjx, fjy, fjz, p,
                              k, npsf, ntsf, rc, stream);
}

}  // extern "C"
