// Harmonic-path ANNP kernels for Hopper (sm_90a), plain C interface.
//
// g_harm replaces the TPU kernel `_g_kernel_harm`
// (meng_zhang_tpu/ops/pallas_annp.py); force_harm replaces
// `_force_kernel_harm` in the same file. Both work on one atom row per
// thread block and one neighbor lane per thread, on [P, K] displacement
// planes dx = x_i - x_j (filler lanes carry dx = 2 box + 10 and give 0).
//
// What bounds them on this card: per pair both kernels run the real
// spherical-harmonic ladder to L = ntsf - 1 (190 (l, m) steps at L = 18),
// about 1e3 f32 FLOPs per pair, against 12 bytes of dx read per pair, so
// they are compute bound. g_harm additionally reduces 371 per-lane values
// over the row's lanes. The design keeps every per-pair value in registers
// (no [K, K] or [K, 361] table ever exists), reads the ladder coefficients
// from shared memory, keeps the ladder loops rolled over runtime bounds
// (npsf, ntsf are runtime ints) to hold register pressure down, and does
// the column sums as warp-shuffle reductions followed by one cross-warp
// pass in shared memory.
//
// Layouts (identical to the TPU kernels' outputs):
//   g    [P, 128]: cols [0, npsf) radial G_m, [npsf, npsf + ntsf) S_l,
//                  npsf + ntsf F2 = sum fc^2, rest 0
//   a    [P, 384]: A_lm in m-major / l-ascending / cosine-then-sine order
//                  (361 columns at L = 18), rest 0
//   dedg [P, 128]: radial dE/dG in cols [0, npsf)
//   b    [P, 384]: B_lm in the A layout, then 2q in column n_harm
//   tab  ladder coefficients [h0 (L+1) | d1 (L+1) | e1 (L+1)^2 | e2 (L+1)^2],
//        e1/e2 at l * (L + 1) + m (ops/fused_annp.py:ladder_table)
#include "pair_geometry.cuh"

namespace {

using annp::block_threads;
using annp::Pair;
using annp::pair_geometry;
using annp::radial_coeff;
using annp::warp_sum;

constexpr int kNsfPad = 128;
constexpr int kAbPad = 384;
constexpr int kPart = kAbPad + kNsfPad;       // per-warp partial sums
constexpr int kTabMax = 2 * 19 + 2 * 19 * 19;  // L <= 18

template <typename T>
__device__ __forceinline__ void load_tab(T* tab, const T* __restrict__ src,
                                         int n) {
  for (int c = threadIdx.x; c < n; c += blockDim.x) tab[c] = src[c];
}

template <typename T>
__global__ void g_harm_kernel(const T* __restrict__ dxx,
                              const T* __restrict__ dxy,
                              const T* __restrict__ dxz,
                              const T* __restrict__ tab_g,
                              T* __restrict__ g_out, T* __restrict__ a_out,
                              int k, int npsf, int ntsf, double rc) {
  __shared__ T tab[kTabMax];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);   // [nwarps][kPart]

  const int nl = ntsf;
  const int lmax = ntsf - 1;
  const int n_harm = nl * nl;
  load_tab(tab, tab_g, 2 * nl + 2 * nl * nl);
  const T* h0 = tab;
  const T* d1 = tab + nl;
  const T* e1 = tab + 2 * nl;
  const T* e2 = e1 + nl * nl;

  const long long row = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  T* wpart = part + warp * kPart;

  T x = T(0), y = T(0), z = T(0);
  if (threadIdx.x < k) {
    const long long o = row * k + threadIdx.x;
    x = dxx[o];
    y = dxy[o];
    z = dxz[o];
  }
  const Pair<T> p = pair_geometry(x, y, z, rc);
  __syncthreads();   // tab staged

  // radial G_m = sum_j T_m(2r/rc - 1) fc_j
  const T xch = T(2) * p.r / T(rc) - T(1);
  T tp = p.m, tc = xch * p.m;
  T v = warp_sum(tp * p.fc);
  if (lane == 0) wpart[kAbPad + 0] = v;
  v = warp_sum(tc * p.fc);
  if (lane == 0) wpart[kAbPad + 1] = v;
  for (int n = 2; n < npsf; ++n) {
    const T tn = T(2) * xch * tc - tp;
    tp = tc;
    tc = tn;
    v = warp_sum(tc * p.fc);
    if (lane == 0) wpart[kAbPad + n] = v;
  }
  v = warp_sum(p.fc * p.fc);
  if (lane == 0) wpart[kAbPad + npsf] = v;

  // A_lm = sum_j fc_j Y_lm(u_j): m-major ladder, (x + iy)^m recurrence
  T cm = p.m, sm = T(0);
  int col = 0;
  for (int mm = 0; mm <= lmax; ++mm) {
    if (mm > 0) {
      const T c2 = p.ux * cm - p.uy * sm;
      const T s2 = p.ux * sm + p.uy * cm;
      cm = c2;
      sm = s2;
    }
    T h1 = T(0), h2 = T(0);
    for (int ll = mm; ll <= lmax; ++ll) {
      T h;
      if (ll == mm) {
        h = h0[mm] * p.m;
      } else if (ll == mm + 1) {
        h = d1[mm] * p.uz * h1;
      } else {
        h = e1[ll * nl + mm] * p.uz * h1 - e2[ll * nl + mm] * h2;
      }
      const T w = p.fc * h;
      v = warp_sum(w * cm);
      if (lane == 0) wpart[col] = v;
      ++col;
      if (mm > 0) {
        v = warp_sum(w * sm);
        if (lane == 0) wpart[col] = v;
        ++col;
      }
      h2 = h1;
      h1 = h;
    }
  }
  __syncthreads();

  // cross-warp sums; final A kept in warp 0's slots for the S_l pass (each
  // column is read and rewritten by one thread only)
  T* a_row = a_out + row * kAbPad;
  for (int c = threadIdx.x; c < kAbPad; c += blockDim.x) {
    T s = T(0);
    if (c < n_harm)
      for (int w = 0; w < nwarps; ++w) s += part[w * kPart + c];
    a_row[c] = s;
    part[c] = s;
  }
  for (int c = threadIdx.x; c <= npsf; c += blockDim.x) {
    T s = T(0);
    for (int w = 0; w < nwarps; ++w) s += part[w * kPart + kAbPad + c];
    part[kAbPad + c] = s;
  }
  __syncthreads();

  T* g_row = g_out + row * kNsfPad;
  for (int c = threadIdx.x; c < kNsfPad; c += blockDim.x) {
    T s = T(0);
    if (c < npsf) {
      s = part[kAbPad + c];
    } else if (c < npsf + nl) {
      // S_l = sum_m A_lm^2, m ascending as in the TPU kernel
      const int l = c - npsf;
      const T a0 = part[l];
      s = a0 * a0;
      int off = nl;                     // first column of the m = 1 block
      for (int mm = 1; mm <= l; ++mm) {
        const T ac = part[off + 2 * (l - mm)];
        const T as = part[off + 2 * (l - mm) + 1];
        s += ac * ac + as * as;
        off += 2 * (nl - mm);
      }
    } else if (c == npsf + nl) {
      s = part[kAbPad + npsf];
    }
    g_row[c] = s;
  }
}

template <typename T>
__global__ void force_harm_kernel(const T* __restrict__ dxx,
                                  const T* __restrict__ dxy,
                                  const T* __restrict__ dxz,
                                  const T* __restrict__ dedg,
                                  const T* __restrict__ b,
                                  const T* __restrict__ tab_g,
                                  T* __restrict__ fjx, T* __restrict__ fjy,
                                  T* __restrict__ fjz, int k, int npsf,
                                  int ntsf, double rc) {
  __shared__ T tab[kTabMax];
  __shared__ T bsh[kAbPad];
  __shared__ T wn[kNsfPad];

  const int nl = ntsf;
  const int lmax = ntsf - 1;
  const long long row = blockIdx.x;
  load_tab(tab, tab_g, 2 * nl + 2 * nl * nl);
  for (int c = threadIdx.x; c < kAbPad; c += blockDim.x)
    bsh[c] = b[row * kAbPad + c];
  for (int c = threadIdx.x; c < npsf; c += blockDim.x)
    wn[c] = dedg[row * kNsfPad + c];
  __syncthreads();
  if (threadIdx.x >= k) return;
  const T* h0 = tab;
  const T* d1 = tab + nl;
  const T* e1 = tab + 2 * nl;
  const T* e2 = e1 + nl * nl;

  const long long o = row * k + threadIdx.x;
  const Pair<T> p = pair_geometry(dxx[o], dxy[o], dxz[o], rc);

  // radial: coeff = sum_n w_n (T'_n (2/rc) fc + T_n dfc)
  const T coeff = radial_coeff(p, wn, npsf, rc);

  // angular: SY = sum B Y, (Gx, Gy, Gz) = sum B dY/du
  T sy = T(0), gx = T(0), gy = T(0), gz = T(0);
  T cm = p.m, sm = T(0), cm1 = T(0), sm1 = T(0);
  int col = 0;
  for (int mm = 0; mm <= lmax; ++mm) {
    if (mm > 0) {
      cm1 = cm;
      sm1 = sm;
      const T c2 = p.ux * cm - p.uy * sm;
      const T s2 = p.ux * sm + p.uy * cm;
      cm = c2;
      sm = s2;
    }
    T h1 = T(0), h2 = T(0), hd1 = T(0), hd2 = T(0);
    for (int ll = mm; ll <= lmax; ++ll) {
      T h, hd;
      if (ll == mm) {
        h = h0[mm] * p.m;
        hd = T(0);
      } else if (ll == mm + 1) {
        h = d1[mm] * p.uz * h1;
        hd = d1[mm] * h1;
      } else {
        const T a = e1[ll * nl + mm];
        const T c = e2[ll * nl + mm];
        h = a * p.uz * h1 - c * h2;
        hd = a * (h1 + p.uz * hd1) - c * hd2;
      }
      const T bc = bsh[col++];
      T wc;
      if (mm > 0) {
        const T bs = bsh[col++];
        wc = bc * cm + bs * sm;
        const T mh = T(mm) * h;
        gx = gx + mh * (bc * cm1 + bs * sm1);
        gy = gy + mh * (bs * cm1 - bc * sm1);
      } else {
        wc = bc * cm;
      }
      sy = sy + h * wc;
      gz = gz + hd * wc;
      h2 = h1;
      h1 = h;
      hd2 = hd1;
      hd1 = hd;
    }
  }
  const T q2 = bsh[col];   // column n_harm carries 2q, not a harmonic
  const T udotg = p.ux * gx + p.uy * gy + p.uz * gz;
  const T pref = p.dfc * (sy + q2 * p.fc) + p.fc * p.inv_r * (-udotg);
  const T fcr = p.fc * p.inv_r;
  fjx[o] = (coeff + pref) * p.ux + fcr * gx;
  fjy[o] = (coeff + pref) * p.uy + fcr * gy;
  fjz[o] = (coeff + pref) * p.uz + fcr * gz;
}

template <typename T>
int launch_g(const void* dxx, const void* dxy, const void* dxz,
             const void* tab, void* g, void* a, long long p, int k, int npsf,
             int ntsf, double rc, void* stream) {
  const int threads = block_threads(k);
  const size_t smem = sizeof(T) * (threads / 32) * kPart;
  if (p > 0)
    g_harm_kernel<T><<<(unsigned)p, threads, smem, (cudaStream_t)stream>>>(
        (const T*)dxx, (const T*)dxy, (const T*)dxz, (const T*)tab, (T*)g,
        (T*)a, k, npsf, ntsf, rc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_force(const void* dxx, const void* dxy, const void* dxz,
                 const void* dedg, const void* b, const void* tab, void* fjx,
                 void* fjy, void* fjz, long long p, int k, int npsf, int ntsf,
                 double rc, void* stream) {
  const int threads = block_threads(k);
  if (p > 0)
    force_harm_kernel<T><<<(unsigned)p, threads, 0, (cudaStream_t)stream>>>(
        (const T*)dxx, (const T*)dxy, (const T*)dxz, (const T*)dedg,
        (const T*)b, (const T*)tab, (T*)fjx, (T*)fjy, (T*)fjz, k, npsf, ntsf,
        rc);
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
