// Cos-matrix ANNP force kernel for Hopper (sm_90a), plain C interface.
//
// force_cos replaces the TPU kernel `_force_kernel` (meng_zhang_tpu/ops/
// pallas_annp.py, row body `_row_force`); its descriptor counterpart g_cos
// is in annp_gcos.cu. It reads [P, K] displacement planes dx = x_i - x_j
// (K <= 512; filler lanes carry dx = 2 box + 10 and give exactly 0) and
// works on one atom row per thread block, one lane per thread (blocks of up
// to 256 threads for K <= 256, as the main paths run it, and up to 512
// above, whose instances may hold at most 128 registers a thread):
//   force_cos  per-pair Fj = -dE_i/dx_j [P, K] x3 from dedg [P, 128] = dE/dG
//              already multiplied by sf_scale * e_scale.
//
// What bounds it on this card: the TPU kernel builds the row's [K, K] cos
// matrix and runs the ntsf-term Chebyshev recurrences over every entry.
// Here only pairs of lanes inside the cutoff are visited (~108 of 128 on
// the fe scene), each unordered pair once (~6.2e3 a row), ~190 FLOPs a pair
// (the T_n and U_n recurrences and the five sums on each side), against 12
// bytes of dx read per lane, so it is compute bound. The design keeps
// everything in registers and shared memory: each thread computes its
// lane's geometry once, the lanes inside the cutoff are compacted into
// shared memory (a warp ballot and a prefix count across warps), and the
// triangular j < k loop is split evenly: thread j takes k = j + 1 .. j +
// n/2 (mod n), so every thread visits <= n/2 pairs.
//   force_cos has one instance per ntsf, so the recurrences are unrolled to
// exactly ntsf terms with the dE/dG weights in registers and no guard; P'
// goes through T'_n = n U_(n-1), which costs a term four FMAs, not five.
// P(x_jk) and P'(x_jk) are symmetric in (j, k), so a pair computes them
// once and serves both lanes: the j side adds to thread j's registers, the
// k side to slot k's five sums in shared memory. At a given step d every
// thread of the block hits another slot, so those adds are plain and a
// barrier a step keeps the steps apart (shared-memory atomicAdd without
// the barriers read 1.8x slower in f32 and 2.4x in f64 on an H100). Each
// slot's sum therefore runs in a fixed order: the kernel is deterministic,
// though its order is not the plain version's. The delivery stays outside.
#include "pair_geometry.cuh"

namespace {

using annp::block_threads;
using annp::Pair;
using annp::pair_geometry;
using annp::radial_coeff;

constexpr int kNsfPad = 128;        // g / dedg row width
constexpr int kWarps = 8;           // warps of a K <= 256 block
constexpr int kWideWarps = 16;      // warps of a K <= 512 block
constexpr int kMaxT = 32;           // angular functions (ntsf)
constexpr unsigned kFull = 0xffffffffu;

// u_x, u_y, u_z and a fourth value in one 16- (f32) or 32-byte (f64) slot,
// so that a slot is read and written with vector loads and stores
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T x, y, z, w;
};

// One instance per ntsf (NT) and block size (W warps at most): the T_n
// and U_n recurrences are unrolled to exactly NT terms and wa[], nwa[]
// hold NT registers each.
template <typename T, int NT, int W>
__global__ void __launch_bounds__(32 * W)
force_cos_kernel(const T* __restrict__ dxx, const T* __restrict__ dxy,
                 const T* __restrict__ dxz, const T* __restrict__ dedg,
                 T* __restrict__ fjx, T* __restrict__ fjy,
                 T* __restrict__ fjz, int k, int npsf, double rc) {
  __shared__ Vec4<T> geo[32 * W];   // compacted lanes: u and fc
  __shared__ Vec4<T> acc[32 * W];   // per slot: sum a cs, sum a u (x, y, z)
  __shared__ T accb[32 * W];        // per slot: sum fc P
  __shared__ T wsh[kNsfPad];
  __shared__ int wcount[W];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row = blockIdx.x;
  for (int c = tid; c < npsf + NT; c += blockDim.x)
    wsh[c] = dedg[row * kNsfPad + c];
  acc[tid] = Vec4<T>{T(0), T(0), T(0), T(0)};
  accb[tid] = T(0);

  const long long o = row * k + tid;
  T x = T(0), y = T(0), z = T(0);         // lanes >= k: rsq 0, masked
  if (tid < k) {
    x = dxx[o];
    y = dxy[o];
    z = dxz[o];
  }
  const Pair<T> p = pair_geometry(x, y, z, rc);

  // lanes inside the cutoff, compacted to the front of geo in lane order
  const bool act = p.m != T(0);
  const unsigned bal = __ballot_sync(kFull, act);
  if (lane == 0) wcount[warp] = __popc(bal);
  __syncthreads();
  int slot = 0, n_act = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    if (w < warp) slot += wcount[w];
    n_act += wcount[w];
  }
  slot += __popc(bal & ((1u << lane) - 1u));
  if (act) geo[slot] = Vec4<T>{p.ux, p.uy, p.uz, p.fc};
  __syncthreads();

  // Thread j < n_act works for compacted lane j, whichever lane that is:
  // the busy threads fill whole warps. It takes the pairs (j, j + d mod
  // n_act), d = 1 .. n_act/2 (d = n_act/2 only for j < n_act/2 when n_act
  // is even), so each unordered pair is visited once. With P = sum_n w_n
  // T_n(x_jk) and P' its derivative, slot j's sums over its partners k are
  //   sum fc_k P' cs, sum fc_k P' u_k, sum fc_k P
  // (the column sums of A[k,j] = 1/4 fc_k fc_j P' and B[k,j] = fc_k dfc_j
  // P with lane j's own factors taken out); the pair adds its j side to
  // this thread's registers and its k side to slot k's sums in shared
  // memory. At step d the block's threads hit distinct slots k, so the
  // adds are plain, with a barrier a step to keep the steps apart.
  T rcs = T(0), rx = T(0), ry = T(0), rz = T(0), rb = T(0);
  const bool busy = tid < n_act;
  const int nd =
      busy ? (n_act - 1) / 2 + ((n_act % 2 == 0 && tid < n_act / 2)) : 0;
  const int steps = n_act / 2;             // the largest nd of the block
  T wa[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) wa[n] = wsh[npsf + n];
  T nwa[NT];                               // n w_n, for P' = sum n w_n U_(n-1)
#pragma unroll
  for (int n = 0; n < NT; ++n) nwa[n] = T(n) * wa[n];
  const Vec4<T> gj = geo[busy ? tid : 0];
  int kk = tid;
  for (int d = 0; d < steps; ++d) {
    if (d < nd) {
      kk = (kk + 1 == n_act) ? 0 : kk + 1;
      const Vec4<T> gk = geo[kk];
      const T cs = gj.x * gk.x + gj.y * gk.y + gj.z * gk.z;
      const T xa = T(0.5) * (cs + T(1));
      const T x2 = xa + xa;
      // T_0 = 1, T_1 = x; T'_n = n U_(n-1) with U_0 = 1, U_1 = 2x and
      // T's recurrence: four FMAs a term where T'_n's own recurrence
      // (T'_n = 2 T_(n-1) + 2x T'_(n-1) - T'_(n-2)) takes five
      T t0 = T(1), t1 = xa, u0 = T(1), u1 = x2;
      T ps = wa[0], dps = T(0);
      if (NT > 1) {
        ps += wa[1] * t1;
        dps += wa[1];
      }
#pragma unroll
      for (int n = 2; n < NT; ++n) {
        const T t2 = x2 * t1 - t0;
        t0 = t1;
        t1 = t2;
        ps += wa[n] * t1;
        dps += nwa[n] * u1;                 // u1 = U_(n-1)
        const T u2 = x2 * u1 - u0;
        u0 = u1;
        u1 = u2;
      }
      const T aj = gk.w * dps;              // the j side: fc_k P'
      rcs += aj * cs;
      rx += aj * gk.x;
      ry += aj * gk.y;
      rz += aj * gk.z;
      rb += gk.w * ps;
      const T ak = gj.w * dps;              // the k side: fc_j P'
      Vec4<T> a = acc[kk];
      a.x += ak * cs;
      a.y += ak * gj.x;
      a.z += ak * gj.y;
      a.w += ak * gj.z;
      acc[kk] = a;
      accb[kk] += gj.w * ps;
    }
    __syncthreads();
  }
  // every k side has arrived: slot j's sums are thread j's alone
  if (busy) {
    Vec4<T> a = acc[tid];
    a.x += rcs;
    a.y += rx;
    a.z += ry;
    a.w += rz;
    acc[tid] = a;
    accb[tid] += rb;
  }
  __syncthreads();
  if (tid >= k) return;

  // radial: coeff = sum_n w_n (T'_n (2/rc) fc + T_n dfc); Fj += coeff u
  const T coeff = radial_coeff(p, wsh, npsf, rc);
  // masked lanes (p.m = 0) read a slot that is not theirs and write 0
  const Vec4<T> s = acc[act ? slot : 0];
  const T aown = T(0.25) * p.fc;
  const T sac = aown * s.x, sax = aown * s.y, say = aown * s.z,
          saz = aown * s.w;
  const T sb = p.dfc * accb[act ? slot : 0];
  // dG_ang/dx_j = 2A (cos u_j - u_k)/r_j - B u_j; Fj -= dG/dx_j
  const T two_ir = T(2) * p.inv_r;
  fjx[o] = (coeff * p.ux - ((sac * p.ux - sax) * two_ir - sb * p.ux)) * p.m;
  fjy[o] = (coeff * p.uy - ((sac * p.uy - say) * two_ir - sb * p.uy)) * p.m;
  fjz[o] = (coeff * p.uz - ((sac * p.uz - saz) * two_ir - sb * p.uz)) * p.m;
}

template <typename T, int W, int NT = 1>
void launch_force_nt(int ntsf, unsigned grid, int block,
                     cudaStream_t stream, const T* dxx, const T* dxy,
                     const T* dxz, const T* dedg, T* fjx, T* fjy, T* fjz,
                     int k, int npsf, double rc) {
  if constexpr (NT < kMaxT) {
    if (ntsf > NT) {
      launch_force_nt<T, W, NT + 1>(ntsf, grid, block, stream, dxx, dxy,
                                    dxz, dedg, fjx, fjy, fjz, k, npsf, rc);
      return;
    }
  }
  force_cos_kernel<T, NT, W><<<grid, block, 0, stream>>>(
      dxx, dxy, dxz, dedg, fjx, fjy, fjz, k, npsf, rc);
}

template <typename T>
int launch_force(const void* dxx, const void* dxy, const void* dxz,
                 const void* dedg, void* fjx, void* fjy, void* fjz,
                 long long p, int k, int npsf, int ntsf, double rc,
                 void* stream) {
  if (k > 32 * kWideWarps) return (int)cudaErrorInvalidValue;
  if (p > 0) {
    const int block = block_threads(k);
    if (block <= 32 * kWarps)
      launch_force_nt<T, kWarps>(ntsf, (unsigned)p, block,
                                 (cudaStream_t)stream, (const T*)dxx,
                                 (const T*)dxy, (const T*)dxz,
                                 (const T*)dedg, (T*)fjx, (T*)fjy, (T*)fjz,
                                 k, npsf, rc);
    else
      launch_force_nt<T, kWideWarps>(ntsf, (unsigned)p, block,
                                     (cudaStream_t)stream, (const T*)dxx,
                                     (const T*)dxy, (const T*)dxz,
                                     (const T*)dedg, (T*)fjx, (T*)fjy,
                                     (T*)fjz, k, npsf, rc);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

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
