// PB-SYM scatter for NVIDIA Hopper (sm_90a): every point's bandwidth
// cylinder added into the density grid, in one launch, with atomics.
//
// Replaces no Pallas kernel: the reference's scatter
// (src/repro/core/pb.py::_pb_impl) is plain jnp, and the port's was a Python
// loop over blocks of points (core/pb.py), each block materialising
// (B, Dx*Dy*Dt) indices and values for index_add_, with a few dozen launches
// and two host syncs a block. That loop stays for CPU tensors, the Table-3
// variants and the chunked path's fixed-order adds; this kernel is the single
// query's and the mesh shards' scatter on the card. It computes
//
//   grid[X, Y, T] += (ks(u_pX, v_pY) * norm) * kt(w_pT)
//
// for every point p and every voxel (X, Y, T) of its cylinder's bounding box
// that lies inside the grid and where both factors are non-zero.
//
// What bounds it on this card: the adds. Each support pair is one float add
// into device memory, resolved in L2, from thousands of points at once; the
// arithmetic (a ks per column, a kt per t, one multiply per pair) is small
// beside it, and the bytes are the points read once and the grid's lines.
//
// What the design does about it:
//  * One warp a point, one lane a column (X, Y) of its cylinder: the 32 adds
//    of a warp instruction go to 32 different columns and never collide.
//  * PB-SYM hoisting: a warp stages u (per X), v (per Y) and kt (per T) of its
//    point in shared memory once; ks is evaluated once per (point, column),
//    and a pair costs one multiply.
//  * Only the support inside the grid is added. A column outside the grid or
//    with ks = 0 adds nothing, and the t range is cut, once per point (a
//    warp-wide min and max), to where kt != 0 and T lies in the grid.
//  * Runs along t. t is the grid's fastest axis, so a column's values are
//    contiguous; they go out as 16- and 8-byte vector reductions (atomicAdd
//    on float4 / float2, sm_90) where aligned, scalar ones at ragged ends.
//  * The points are walked in a scrambled order (i -> i * order mod n, order
//    coprime to n, chosen by the wrapper), so that points that lie together
//    in the input (a cluster) do not all add into the same voxels at once.
//  * No host sync and no allocation: the wrapper zeroes the grid and passes
//    the domain's floats, the normalisation and the kernel ids as arguments.
//
// Rounding: home voxels are floor((p - o) / s) with IEEE division, unclipped
// (Domain.point_voxels_unclipped); the voxel centres o + (X + 0.5) * s, u, v,
// w, ks, kt and their product follow the loop of core/pb.py step by step,
// with IEEE single operations the compiler may not contract (__fadd_rn,
// __fmul_rn, __fdiv_rn), so every term has the loop's bits. Only the order
// of each voxel's sum differs, as it already did under index_add_'s atomics:
// two launches may differ in the last bits of a voxel.
#include <cuda_runtime.h>
#include <climits>

// The ids the Python side maps its callables to (core/kernels_math.py).
#define KS_EPANECHNIKOV 0
#define KS_PAPER_VERBATIM 1
#define KT_EPANECHNIKOV 0
#define KT_PAPER_VERBATIM 1

namespace {

constexpr int THREADS = 256;               // threads of a block
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

constexpr float TWO_OVER_PI = static_cast<float>(2.0 / 3.14159265358979323846);
constexpr float PI_OVER_TWO = static_cast<float>(3.14159265358979323846 / 2.0);

struct ScatterParams {
  float ox, oy, ot, sres, tres, hs, ht, norm;
  int Gx, Gy, Gt, Hs, Ht;
  long long n, order;
};

// Home voxel of coordinate c: floor((c - origin) / res), unclipped, converted
// as torch converts a float to int32 on the card.
__device__ __forceinline__ int home_voxel(float c, float origin, float res) {
  return static_cast<int>(floorf(__fdiv_rn(__fsub_rn(c, origin), res)));
}

// ((origin + (idx + 0.5) * res) - c) / h, each step rounded on its own.
__device__ __forceinline__ float offset_over_h(int idx, float origin, float res,
                                               float c, float h) {
  const float centre = __fadd_rn(
      origin, __fmul_rn(__fadd_rn(static_cast<float>(idx), 0.5f), res));
  return __fdiv_rn(__fsub_rn(centre, c), h);
}

// ks(u, v) * norm in the loop's order; 0 outside the unit disk.
template <int KS>
__device__ __forceinline__ float ks_times_norm(float u, float v, float norm) {
  const float r2 = __fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v));
  float val;
  if (KS == KS_EPANECHNIKOV) {
    const float d = __fsub_rn(1.0f, r2);
    val = __fmul_rn(TWO_OVER_PI, __fmul_rn(d, d));
  } else {
    const float a = __fsub_rn(1.0f, u);
    const float b = __fsub_rn(1.0f, v);
    val = __fmul_rn(__fmul_rn(PI_OVER_TWO, __fmul_rn(a, a)), __fmul_rn(b, b));
  }
  return __fmul_rn(r2 < 1.0f ? val : 0.0f, norm);
}

template <int KT>
__device__ __forceinline__ float kt_eval(float w) {
  float val;
  if (KT == KT_EPANECHNIKOV) {
    val = __fmul_rn(0.75f, __fsub_rn(1.0f, __fmul_rn(w, w)));
  } else {
    const float a = __fsub_rn(1.0f, w);
    val = __fmul_rn(0.75f, __fmul_rn(a, a));
  }
  return fabsf(w) < 1.0f ? val : 0.0f;
}

// grid[idx + k] += ks * kt[j + k] for k = 0 .. last - j: 16-byte reductions
// where idx is 16-byte aligned, 8-byte ones where it is 8-byte aligned.
__device__ __forceinline__ void add_run(float* __restrict__ grid, long long idx,
                                        const float* kt, int j, int last,
                                        float ks) {
  while (j <= last) {
    const int left = last - j + 1;
    if ((idx & 3) == 0 && left >= 4) {
      atomicAdd(reinterpret_cast<float4*>(grid + idx),
                make_float4(__fmul_rn(ks, kt[j]), __fmul_rn(ks, kt[j + 1]),
                            __fmul_rn(ks, kt[j + 2]), __fmul_rn(ks, kt[j + 3])));
      j += 4;
      idx += 4;
    } else if ((idx & 1) == 0 && left >= 2) {
      atomicAdd(reinterpret_cast<float2*>(grid + idx),
                make_float2(__fmul_rn(ks, kt[j]), __fmul_rn(ks, kt[j + 1])));
      j += 2;
      idx += 2;
    } else {
      atomicAdd(grid + idx, __fmul_rn(ks, kt[j]));
      j += 1;
      idx += 1;
    }
  }
}

template <int KS, int KT>
__global__ void __launch_bounds__(THREADS)
stkde_scatter_kernel(const float* __restrict__ pts,  // (n, 3) x, y, t
                     float* __restrict__ grid,       // (Gx, Gy, Gt), zeroed
                     const ScatterParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int D = 2 * p.Hs + 1;
  const int Dt = 2 * p.Ht + 1;
  float* su = smem + warp * (2 * D + Dt);  // u of the cylinder's D columns X
  float* sv = su + D;                      // v of its D rows Y
  float* skt = sv + D;                     // kt of its Dt times T

  const long long i = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (i >= p.n) return;  // the whole warp: one point a warp
  const long long q = (i * p.order) % p.n;
  const float px = pts[3 * q], py = pts[3 * q + 1], pt = pts[3 * q + 2];
  // the cylinder's box [v - H, v + H] against the grid, in 64 bits
  const long long x0 = static_cast<long long>(home_voxel(px, p.ox, p.sres)) - p.Hs;
  const long long y0 = static_cast<long long>(home_voxel(py, p.oy, p.sres)) - p.Hs;
  const long long t0 = static_cast<long long>(home_voxel(pt, p.ot, p.tres)) - p.Ht;
  if (x0 + D <= 0 || x0 >= p.Gx || y0 + D <= 0 || y0 >= p.Gy ||
      t0 + Dt <= 0 || t0 >= p.Gt)
    return;  // the box misses the grid

  for (int j = lane; j < D; j += 32) {
    su[j] = offset_over_h(static_cast<int>(x0) + j, p.ox, p.sres, px, p.hs);
    sv[j] = offset_over_h(static_cast<int>(y0) + j, p.oy, p.sres, py, p.hs);
  }
  int lo = INT_MAX, hi = -1;  // the t range to add: kt != 0, T in the grid
  for (int j = lane; j < Dt; j += 32) {
    const int T = static_cast<int>(t0) + j;
    const float k = kt_eval<KT>(offset_over_h(T, p.ot, p.tres, pt, p.ht));
    skt[j] = k;
    if (k != 0.0f && T >= 0 && T < p.Gt) {
      lo = min(lo, j);
      hi = max(hi, j);
    }
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  __syncwarp();  // the staging is complete
  if (hi < 0) return;

  const int cols = D * D;
  for (int c = lane; c < cols; c += 32) {
    const int a = c / D;
    const int b = c - a * D;
    const long long X = x0 + a, Y = y0 + b;
    if (X < 0 || X >= p.Gx || Y < 0 || Y >= p.Gy) continue;
    const float ks = ks_times_norm<KS>(su[a], sv[b], p.norm);
    if (ks == 0.0f) continue;
    add_run(grid, (X * p.Gy + Y) * p.Gt + t0 + lo, skt, lo, hi, ks);
  }
}

template <int KS, int KT>
int launch(const float* pts, float* grid, const ScatterParams& p, int smem,
           cudaStream_t stream) {
  auto kernel = stkde_scatter_kernel<KS, KT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (p.n + WARPS - 1) / WARPS;
  kernel<<<static_cast<unsigned int>(blocks), THREADS,
           static_cast<size_t>(smem), stream>>>(pts, grid, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of a block: each warp's u, v and kt.
extern "C" long long stkde_scatter_smem_bytes(int Hs, int Ht) {
  return static_cast<long long>(WARPS) *
         (2LL * (2 * Hs + 1) + (2 * Ht + 1)) *
         static_cast<long long>(sizeof(float));
}

// Adds the n points' cylinders into `grid` (zeroed by the caller) on
// `stream` and returns cudaGetLastError() (0 = ok). `pts` is (n, 3) float32,
// `grid` (Gx, Gy, Gt) float32 and 16-byte aligned.
extern "C" int stkde_scatter_launch(const void* pts, long long n, void* grid,
                                    int Gx, int Gy, int Gt, int Hs, int Ht,
                                    float ox, float oy, float ot, float sres,
                                    float tres, float hs, float ht, float norm,
                                    int ks_id, int kt_id, long long order,
                                    void* stream) {
  if (n <= 0) return 0;
  ScatterParams p;
  p.ox = ox; p.oy = oy; p.ot = ot;
  p.sres = sres; p.tres = tres; p.hs = hs; p.ht = ht; p.norm = norm;
  p.Gx = Gx; p.Gy = Gy; p.Gt = Gt; p.Hs = Hs; p.Ht = Ht;
  p.n = n; p.order = order;
  const int smem = static_cast<int>(stkde_scatter_smem_bytes(Hs, Ht));
  const float* in = static_cast<const float*>(pts);
  float* out = static_cast<float*>(grid);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool epan_s = ks_id == KS_EPANECHNIKOV;
  const bool epan_t = kt_id == KT_EPANECHNIKOV;
  if (epan_s && epan_t)
    return launch<KS_EPANECHNIKOV, KT_EPANECHNIKOV>(in, out, p, smem, s);
  if (epan_s)
    return launch<KS_EPANECHNIKOV, KT_PAPER_VERBATIM>(in, out, p, smem, s);
  if (epan_t)
    return launch<KS_PAPER_VERBATIM, KT_EPANECHNIKOV>(in, out, p, smem, s);
  return launch<KS_PAPER_VERBATIM, KT_PAPER_VERBATIM>(in, out, p, smem, s);
}
