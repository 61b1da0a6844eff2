// Short-list compaction for Hopper (sm_90a), plain C interface.
//
// compact_short replaces no TPU kernel: the JAX package leaves the
// compaction to XLA (`PallasAnnp.compact_short`, a sort of each row chunk's
// keys, meng_zhang_tpu/ops/pallas_annp.py:845, `_compact_block_norev`
// :698). Its plain twin is ops/fused_annp.py:compact_short_plain, which
// masks each [rows, K] chunk of the skin list and sorts its keys.
//
// What it computes: for each row i of the skin list idx [N, K] (partner ids
// ascending, padded with the sentinel M = len(src)), the partners j with
// 1e-12 < |x_i - src_j|^2 < rc_s^2 under the per-axis minimum image on the
// periodic axes, in the row's order, into the first columns of out [N, Ks],
// the rest of the row M; count[i] the row's partners inside rc_s, all of
// them; *overflow set when some row has more than Ks (it keeps its first
// Ks).
//
// The sort does no work: the skin rows are ascending, so keeping a row's
// in-range lanes in their order gives the sorted keys' first Ks columns.
// One warp walks a row in 32-lane tiles, any K; a ballot and a popc of the
// lanes below place each kept id. kTiles tiles are loaded before any is
// tested, so a lane has kTiles id loads and then 3 kTiles position loads in
// flight. Two tiles and blocks of four rows ran fastest at the benchmark
// cells' shapes on an H100 (four tiles and eight rows: 3-10 % slower; two
// ids a lane as one 16-byte load: 3-24 % slower).
//
// What bounds it on this card: bytes. It reads the ids (8 K bytes a row)
// and writes the short row (8 Ks bytes); the partners' positions are
// gathered from L2 (the position table is at most 24 MB at 2M atoms in
// f32), and the arithmetic is ~15 operations a lane.
//
// The geometry rounds as the eager torch ops of the plain version do (no
// contraction into FMA: __f*_rn / __d*_rn; torch.round is round half to
// even, rint), so the kept set is bit for bit the plain version's. The
// image wrap divides by the box on the card (true division, as torch
// divides by a 0-dim CUDA tensor); a box given from the host is, as torch
// divides a CUDA tensor by a CPU scalar, a product with its reciprocal.
// rc_s^2 and 1e-12 are rounded to T, as torch rounds a Python scalar it
// compares a T tensor with.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;   // rows (warps) a block
constexpr int kTiles = 2;   // 32-lane tiles loaded before any is tested

__device__ __forceinline__ float r_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float r_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float r_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float r_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float r_rint(float a) { return rintf(a); }
__device__ __forceinline__ double r_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double r_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double r_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double r_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double r_rint(double a) { return rint(a); }

// One axis of dx = x_i - x_j, wrapped as pair_dx_planes wraps it:
// d - b round(d / b), or d - b round(d * (1 / b)) for a host box.
template <typename T>
__device__ __forceinline__ T axis_dx(T xi, T xj, bool periodic, T b, T inv_b,
                                     bool host_box) {
  T d = r_sub(xi, xj);
  if (periodic) {
    const T q = host_box ? r_mul(d, inv_b) : r_div(d, b);
    d = r_sub(d, r_mul(b, r_rint(q)));
  }
  return d;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
compact_short_kernel(const T* __restrict__ x, const T* __restrict__ src,
                     const long long* __restrict__ idx,
                     const T* __restrict__ box_dev, T hb0, T hb1, T hb2,
                     int pbc, T rsq_hi, T rsq_lo, long long rows, int k,
                     int ks, long long m, long long* __restrict__ out,
                     int* __restrict__ count, bool* __restrict__ overflow) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const bool host_box = box_dev == nullptr;
  const T b[3] = {host_box ? hb0 : box_dev[0], host_box ? hb1 : box_dev[1],
                  host_box ? hb2 : box_dev[2]};
  T inv_b[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) inv_b[a] = r_div(T(1), b[a]);
  const T xi[3] = {x[3 * row], x[3 * row + 1], x[3 * row + 2]};
  const long long* irow = idx + row * k;
  long long* orow = out + row * ks;
  const unsigned below = (1u << lane) - 1u;
  int kept = 0;  // warp-uniform
  for (int t0 = 0; t0 < k; t0 += 32 * kTiles) {
    long long j[kTiles];
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      const int s = t0 + 32 * u + lane;
      j[u] = s < k ? irow[s] : m;
    }
    T xj[kTiles][3];
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      // filler ids (>= m) are never kept: pair_dx_planes puts them at
      // 2 box + 10 on each axis, beyond any rc_s
      const bool real = (unsigned long long)j[u] < (unsigned long long)m;
#pragma unroll
      for (int a = 0; a < 3; ++a) xj[u][a] = real ? src[3 * j[u] + a] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      bool in = false;
      if ((unsigned long long)j[u] < (unsigned long long)m) {
        T d[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          d[a] = axis_dx(xi[a], xj[u][a], (pbc >> a) & 1, b[a], inv_b[a],
                         host_box);
        const T rsq = r_add(r_add(r_mul(d[0], d[0]), r_mul(d[1], d[1])),
                            r_mul(d[2], d[2]));
        in = (rsq < rsq_hi) && (rsq > rsq_lo);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, in);
      const int pos = kept + __popc(ballot & below);
      if (in && pos < ks) orow[pos] = j[u];
      kept += __popc(ballot);
    }
  }
  for (int s = min(kept, ks) + lane; s < ks; s += 32) orow[s] = m;
  if (lane == 0) {
    count[row] = kept;
    if (kept > ks) *overflow = true;
  }
}

template <typename T>
int launch(const void* x, const void* src, const void* idx,
           const void* box_dev, const double* box_host, int pbc,
           double rc_s, long long rows, int k, int ks, long long m,
           void* out, void* count, void* overflow, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(overflow, 0, sizeof(bool), s);
  if (err != cudaSuccess || rows == 0) return static_cast<int>(err);
  const long long blocks = (rows + kWarps - 1) / kWarps;
  compact_short_kernel<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                            s>>>(
      static_cast<const T*>(x), static_cast<const T*>(src),
      static_cast<const long long*>(idx), static_cast<const T*>(box_dev),
      T(box_host[0]), T(box_host[1]), T(box_host[2]), pbc, T(rc_s * rc_s),
      T(1.0e-12), rows, k, ks, m, static_cast<long long*>(out),
      static_cast<int*>(count), static_cast<bool*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// box_dev: the box [3] on the card (T), or null, and then box_host (3
// doubles, host memory) is the box; pbc: bit a set when axis a is periodic.
int compact_short_f32(const void* x, const void* src, const void* idx,
                      const void* box_dev, const double* box_host, int pbc,
                      double rc_s, long long rows, int k, int ks, long long m,
                      void* out, void* count, void* overflow, void* stream) {
  return launch<float>(x, src, idx, box_dev, box_host, pbc, rc_s, rows, k, ks,
                       m, out, count, overflow, stream);
}

int compact_short_f64(const void* x, const void* src, const void* idx,
                      const void* box_dev, const double* box_host, int pbc,
                      double rc_s, long long rows, int k, int ks, long long m,
                      void* out, void* count, void* overflow, void* stream) {
  return launch<double>(x, src, idx, box_dev, box_host, pbc, rc_s, rows, k,
                        ks, m, out, count, overflow, stream);
}

}  // extern "C"
