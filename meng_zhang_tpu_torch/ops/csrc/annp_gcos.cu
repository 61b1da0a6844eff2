// Cos-matrix ANNP descriptor kernel for Hopper (sm_90a), plain C interface.
//
// g_cos replaces the TPU kernel `_g_kernel` (meng_zhang_tpu/ops/
// pallas_annp.py, row body `_row_g`); its force counterpart force_cos is in
// annp_cos.cu. It reads [P, K] displacement planes dx = x_i - x_j (K <= 256;
// filler lanes carry dx = 2 box + 10 and give exactly 0) and works on one
// atom row per thread block, one lane per thread:
//   g_cos  g [P, 128]: radial G_m = sum_j T_m(2r/rc - 1) fc_j in cols
//          [0, npsf), angular G_n = 1/2 sum_{j != k} T_n((cos_jk + 1)/2)
//          fc_j fc_k in cols npsf + n, rest 0.
//
// What bounds it on this card: the TPU kernel builds the row's [K, K] cos
// matrix and runs the ntsf-term Chebyshev recurrence over every entry. Here
// only pairs of lanes inside the cutoff are visited (~108 of 128 on the fe
// scene), each unordered pair once (~6.2e3 a row), 7 + 4 ntsf FLOPs a pair
// against 12 bytes of dx read per lane: it is compute bound, and its time
// is its instruction count, so the pair loop holds nothing but the pair's
// work.
// Each thread computes its lane's geometry once, the lanes inside the cutoff
// are compacted into shared memory (a warp ballot and a prefix count across
// warps), thread j < n_act works for compacted lane j (the busy threads fill
// whole warps) and the triangular j < k loop is split evenly: thread j takes
// k = j + 1 .. j + n/2 (mod n), so every thread visits <= n/2 pairs, and
// the threads of a warp read neighbouring slots: no bank conflicts. The
// compacted lanes are stored twice, back to back, so that k = j + d needs no
// wrap and a step unrolled by four reads its partners at immediate offsets.
//   A warp runs as many steps as its busiest thread, so a last warp that is
// part full (12 of 32 threads at 108 active lanes) costs a full warp's
// steps. When the row has full warps too, the leftover lanes' steps are
// dealt to the full warps' threads instead, a chunk of one leftover lane's
// partners each (3 x 61 warp-steps a row, not 4 x 54), and the last warp
// skips the loop. Every sum runs over all of the row's pairs, so whose
// thread a pair's terms land in does not matter. (Dealing the flattened
// (lane, step) list evenly to all threads balances better still and read
// 2x slower on an H100: a warp's threads then read scattered slots.)
//   There is one instance per ntsf: the recurrence is unrolled to exactly
// ntsf terms, two FMAs a term (T_n, then its sum), with the ntsf sums in
// registers and no guard in the loop or after it. A recurrence unrolled to
// the bound 32 under a runtime guard `n < ntsf` compiles to 32 predicated
// sections that are all executed: 171 instructions a pair whatever ntsf is,
// which is what that kernel's time was. The row ends in a warp-shuffle and
// cross-warp reduction; no atomics, a fixed order: deterministic.
#include "pair_geometry.cuh"

namespace {

using annp::block_threads;
using annp::Pair;
using annp::pair_geometry;
using annp::warp_sum;

constexpr int kNsfPad = 128;        // g row width
constexpr int kMaxK = 256;          // lanes: one thread each, <= 8 warps
constexpr int kMaxWarps = kMaxK / 32;
constexpr int kMaxT = 32;           // angular functions (ntsf)
constexpr unsigned kFull = 0xffffffffu;

// Lanes inside the cutoff, compacted to the front of shared memory in lane
// order, and once more behind themselves (slot s + n_act = slot s). Every
// thread of the block calls it; returns the number of active lanes.
template <typename T>
__device__ __forceinline__ int compact_active(const Pair<T>& p, T* sx, T* sy,
                                              T* sz, T* sfc, int* wcount) {
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
  if (act) {
    const int s = base + __popc(bal & ((1u << lane) - 1u));
    sx[s] = p.ux;
    sy[s] = p.uy;
    sz[s] = p.uz;
    sfc[s] = p.fc;
    sx[s + n_act] = p.ux;
    sy[s + n_act] = p.uy;
    sz[s + n_act] = p.uz;
    sfc[s + n_act] = p.fc;
  }
  __syncthreads();
  return n_act;
}

// Lane j's pairs with its partners k = j + d0 + 1 .. j + d0 + cnt, each
// term w T_n(x_jk), w = fc_j fc_k, added to acc[n]; the recurrence unrolled
// to exactly NT terms.
template <typename T, int NT>
__device__ __forceinline__ void add_pairs(const T* sx, const T* sy,
                                          const T* sz, const T* sfc, int j,
                                          int d0, int cnt, T (&acc)[NT]) {
  const T ujx = sx[j], ujy = sy[j], ujz = sz[j], fcj = sfc[j];
  const T* px = sx + j + d0 + 1;
  const T* py = sy + j + d0 + 1;
  const T* pz = sz + j + d0 + 1;
  const T* pf = sfc + j + d0 + 1;
#pragma unroll 4
  for (int d = 0; d < cnt; ++d) {
    const T cs = ujx * px[d] + ujy * py[d] + ujz * pz[d];
    const T xa = T(0.5) * (cs + T(1));
    const T x2 = xa + xa;
    const T w = fcj * pf[d];
    T t0 = T(1), t1 = xa;
    acc[0] += w;
    if constexpr (NT > 1) acc[1] += w * xa;
#pragma unroll
    for (int n = 2; n < NT; ++n) {
      const T t2 = x2 * t1 - t0;
      t0 = t1;
      t1 = t2;
      acc[n] += w * t1;
    }
  }
}

// One instance per ntsf (NT): acc[] holds NT registers.
template <typename T, int NT>
__global__ void __launch_bounds__(kMaxK)
g_cos_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
             const T* __restrict__ dxz, T* __restrict__ g_out, int k,
             int npsf, double rc) {
  __shared__ T sx[2 * kMaxK], sy[2 * kMaxK], sz[2 * kMaxK], sfc[2 * kMaxK];
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

  const int n_act = compact_active(p, sx, sy, sz, sfc, wcount);

  // angular: sum_{j<k} T_n(x_jk) fc_j fc_k. Lane j's partners are k = j + d
  // (mod n_act), d = 1 .. nd = (n_act - 1) / 2, and for even n_act the half
  // step d = n_act / 2 for j < n_act / 2, so that each unordered pair is
  // visited once. The first `busy` threads take their own lanes: all n_act,
  // or the `full` warps' when a part-full last warp's `rest` lanes are
  // dealt to them, `chunk` partners of one leftover lane a thread (such a
  // lane lies in the upper half, so it has no half step; neighbouring
  // threads take neighbouring lanes). They are dealt when that takes the
  // block fewer warp-steps and leaves more than half of its warps busy
  // (with fewer, an SM's resident blocks hold too few busy warps).
  const int nd = (n_act - 1) / 2;
  const int nwarps = blockDim.x >> 5;
  const int rest = n_act & 31, full = n_act - rest;
  const int per = rest > 0 ? full / rest : 0;   // threads a leftover lane
  const int chunk = per > 0 ? (nd + per - 1) / per : 0;
  const bool deal =
      per > 0 && chunk * (full >> 5) < nd && 2 * (full >> 5) > nwarps;
  const int busy = deal ? full : n_act;
  const int busy_warps = (busy + 31) >> 5;
  T acc[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n] = T(0);
  if (tid < busy) {
    add_pairs<T, NT>(sx, sy, sz, sfc, tid, 0,
                     nd + (n_act % 2 == 0 && tid < n_act / 2), acc);
    if (deal) {
      const int c = tid / rest, d0 = c * chunk;
      if (d0 < nd)
        add_pairs<T, NT>(sx, sy, sz, sfc, full + tid - c * rest, d0,
                         d0 + chunk < nd ? chunk : nd - d0, acc);
    }
  }
  if (warp < busy_warps) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      v = warp_sum(acc[n]);
      if (lane == 0) part[warp][npsf + n] = v;
    }
  } else if (lane < NT) {
    part[warp][npsf + lane] = T(0);       // a warp that took no pair
  }
  __syncthreads();

  T* g_row = g_out + row * kNsfPad;
  for (int c = tid; c < kNsfPad; c += blockDim.x) {
    T s = T(0);
    if (c < npsf + NT)
      for (int w = 0; w < nwarps; ++w) s += part[w][c];
    g_row[c] = s;
  }
}

template <typename T, int NT = 1>
void launch_g_nt(int ntsf, unsigned grid, int block, cudaStream_t stream,
                 const T* dxx, const T* dxy, const T* dxz, T* g, int k,
                 int npsf, double rc) {
  if constexpr (NT < kMaxT) {
    if (ntsf > NT) {
      launch_g_nt<T, NT + 1>(ntsf, grid, block, stream, dxx, dxy, dxz, g, k,
                             npsf, rc);
      return;
    }
  }
  g_cos_kernel<T, NT><<<grid, block, 0, stream>>>(dxx, dxy, dxz, g, k, npsf,
                                                  rc);
}

template <typename T>
int launch_g(const void* dxx, const void* dxy, const void* dxz, void* g,
             long long p, int k, int npsf, int ntsf, double rc,
             void* stream) {
  if (p > 0)
    launch_g_nt<T>(ntsf, (unsigned)p, block_threads(k), (cudaStream_t)stream,
                   (const T*)dxx, (const T*)dxy, (const T*)dxz, (T*)g, k,
                   npsf, rc);
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

}  // extern "C"
