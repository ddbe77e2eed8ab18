// PB-SYM tile accumulation for NVIDIA Hopper (sm_90a), fp32, CUDA cores.
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/stkde_tile.py
// (launched by `_stkde_tiles_pallas`). It computes the same function:
//
//   out[tile][x, y, t] = sum over the tile's candidate points p of
//                        ks(u_px, v_py) * norm  *  kt(w_pt) * valid_p
//
// for every output tile (bx, by, bt) of the padded grid, from capacity-padded
// overlap buckets pts (ntiles, cap, 3) and valid (ntiles, cap).
//
// What bounds it on this card: fp32 arithmetic outside the tensor cores.
// Each (point, column) pair costs one ks evaluation plus 2*bt operations of
// the contraction, while the bytes are only the buckets read once and the
// grid written once, so the arithmetic is far above the memory time.
//
// What the design does about it:
//  * one block per output tile; a thread owns up to COLS columns (x, y) of
//    the tile and keeps their BT_PASS sums in registers for the whole point
//    stream, so the tile is written once and no Ks panel ever reaches memory;
//  * a panel of points is staged in shared memory as u[p][x], v[p][y] and
//    Kt[p][t] (built cooperatively, one division per entry), so the inner
//    loop is one ks evaluation and BT_PASS FMAs against a broadcast Kt row;
//  * a column whose ks is zero for a point skips that point's FMAs (adding
//    +0 would not change the sum);
//  * a bucket holds its valid points first, so with `counts` a block stops at
//    the end of the panel that holds its last real point; Kt is still
//    multiplied by `valid`, and the skipped terms are exact zeros.
//
// Rounding: u, v, w and the kernel functions are computed in the order of the
// plain PyTorch version (kernels/ref.py) with IEEE single operations that the
// compiler may not contract (__fadd_rn, __fmul_rn, __fdiv_rn), because two of
// the four kernel functions are not zero at the edge of their support and a
// one-ulp difference there would flip a whole contribution. Only the
// accumulation uses fmaf.
//
// Tile shapes are run-time values: columns are walked with a stride of the
// block, and bt in passes of BT_PASS. Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

// The ids the Python side maps its callables to (core/kernels_math.py).
#define KS_EPANECHNIKOV 0
#define KS_PAPER_VERBATIM 1
#define KT_EPANECHNIKOV 0
#define KT_PAPER_VERBATIM 1

namespace {

constexpr int THREADS = 256;  // threads of a block
constexpr int COLS = 4;       // columns (x, y) a thread owns in one pass
constexpr int BT_PASS = 16;   // t values a thread accumulates in one pass

constexpr float TWO_OVER_PI = static_cast<float>(2.0 / 3.14159265358979323846);
constexpr float PI_OVER_TWO = static_cast<float>(3.14159265358979323846 / 2.0);

struct TileParams {
  float ox, oy, ot, sres, tres, hs, ht, norm;
  int ntx, nty, ntt, bx, by, bt, cap, panel, kt_id;
};

template <int KS>
__device__ __forceinline__ float ks_eval(float u, float v) {
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
  return r2 < 1.0f ? val : 0.0f;
}

__device__ __forceinline__ float kt_eval(int kt_id, float w) {
  float val;
  if (kt_id == KT_EPANECHNIKOV) {
    val = __fmul_rn(0.75f, __fsub_rn(1.0f, __fmul_rn(w, w)));
  } else {
    const float a = __fsub_rn(1.0f, w);
    val = __fmul_rn(0.75f, __fmul_rn(a, a));
  }
  return fabsf(w) < 1.0f ? val : 0.0f;
}

// Voxel-centre offset of voxel `idx` from coordinate `c`, over bandwidth `h`:
// ((origin + (idx + 0.5) * res) - c) / h, each step rounded on its own.
__device__ __forceinline__ float offset_over_h(int idx, float origin, float res,
                                               float c, float h) {
  const float centre = __fadd_rn(
      origin, __fmul_rn(__fadd_rn(static_cast<float>(idx), 0.5f), res));
  return __fdiv_rn(__fsub_rn(centre, c), h);
}

template <int KS>
__global__ void __launch_bounds__(THREADS)
stkde_tile_kernel(const float* __restrict__ pts,    // (ntiles, cap, 3)
                  const float* __restrict__ valid,  // (ntiles, cap)
                  const int* __restrict__ counts,   // (ntiles) or null
                  float* __restrict__ out,          // (ntx*bx, nty*by, ntt*bt)
                  const TileParams p) {
  extern __shared__ __align__(16) float smem[];
  float* skt = smem;                      // (panel, BT_PASS), rows 64 bytes
  float* su = skt + p.panel * BT_PASS;    // (panel, bx)
  float* sv = su + p.panel * p.bx;        // (panel, by)

  const int tile_id = blockIdx.x;
  const int tk = tile_id % p.ntt;
  const int tj = (tile_id / p.ntt) % p.nty;
  const int ti = tile_id / (p.ntt * p.nty);
  const float* tile_pts = pts + static_cast<int64_t>(tile_id) * p.cap * 3;
  const float* tile_valid = valid + static_cast<int64_t>(tile_id) * p.cap;

  // Points to walk: the whole bucket, or up to the end of the panel that
  // holds the last valid point (cap is a multiple of panel).
  int lim = p.cap;
  if (counts != nullptr) {
    const int c = counts[tile_id];
    lim = min(p.cap, ((c + p.panel - 1) / p.panel) * p.panel);
  }

  const int ncols = p.bx * p.by;
  const int64_t stride_y = static_cast<int64_t>(p.ntt) * p.bt;
  const int64_t stride_x = static_cast<int64_t>(p.nty) * p.by * stride_y;

  for (int c0 = 0; c0 < ncols; c0 += THREADS * COLS) {
    int cx[COLS], cy[COLS];
    bool live[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int c = c0 + static_cast<int>(threadIdx.x) + k * THREADS;
      live[k] = c < ncols;
      cx[k] = live[k] ? c / p.by : 0;
      cy[k] = live[k] ? c % p.by : 0;
    }

    for (int t0 = 0; t0 < p.bt; t0 += BT_PASS) {
      float acc[COLS][BT_PASS];
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
#pragma unroll
        for (int t = 0; t < BT_PASS; ++t) acc[k][t] = 0.0f;
      }

      for (int q0 = 0; q0 < lim; q0 += p.panel) {
        __syncthreads();  // the previous panel has been consumed
        for (int i = threadIdx.x; i < p.panel * p.bx; i += THREADS) {
          const int q = i / p.bx, x = i % p.bx;
          su[i] = offset_over_h(ti * p.bx + x, p.ox, p.sres,
                                tile_pts[static_cast<int64_t>(q0 + q) * 3 + 0],
                                p.hs);
        }
        for (int i = threadIdx.x; i < p.panel * p.by; i += THREADS) {
          const int q = i / p.by, y = i % p.by;
          sv[i] = offset_over_h(tj * p.by + y, p.oy, p.sres,
                                tile_pts[static_cast<int64_t>(q0 + q) * 3 + 1],
                                p.hs);
        }
        for (int i = threadIdx.x; i < p.panel * BT_PASS; i += THREADS) {
          const int q = i / BT_PASS, t = t0 + i % BT_PASS;
          float val = 0.0f;
          if (t < p.bt) {
            const float w = offset_over_h(
                tk * p.bt + t, p.ot, p.tres,
                tile_pts[static_cast<int64_t>(q0 + q) * 3 + 2], p.ht);
            val = __fmul_rn(kt_eval(p.kt_id, w), tile_valid[q0 + q]);
          }
          skt[i] = val;
        }
        __syncthreads();

        for (int q = 0; q < p.panel; ++q) {
          float kt[BT_PASS];
          const float4* row = reinterpret_cast<const float4*>(skt + q * BT_PASS);
#pragma unroll
          for (int j = 0; j < BT_PASS / 4; ++j) {
            const float4 r = row[j];
            kt[4 * j + 0] = r.x;
            kt[4 * j + 1] = r.y;
            kt[4 * j + 2] = r.z;
            kt[4 * j + 3] = r.w;
          }
#pragma unroll
          for (int k = 0; k < COLS; ++k) {
            const float s = __fmul_rn(
                ks_eval<KS>(su[q * p.bx + cx[k]], sv[q * p.by + cy[k]]),
                p.norm);
            if (s != 0.0f) {
#pragma unroll
              for (int t = 0; t < BT_PASS; ++t)
                acc[k][t] = fmaf(s, kt[t], acc[k][t]);
            }
          }
        }
      }

      // Every block stores its tile, also when it walked no point at all.
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        if (!live[k]) continue;
        float* dst = out + (static_cast<int64_t>(ti) * p.bx + cx[k]) * stride_x +
                     (static_cast<int64_t>(tj) * p.by + cy[k]) * stride_y +
                     static_cast<int64_t>(tk) * p.bt + t0;
#pragma unroll
        for (int t = 0; t < BT_PASS; ++t)
          if (t0 + t < p.bt) dst[t] = acc[k][t];
      }
    }
  }
}

}  // namespace

// Shared memory one block needs for a panel of `panel` points, in bytes.
extern "C" long long stkde_tile_smem_bytes(int bx, int by, int panel) {
  return static_cast<long long>(panel) * (BT_PASS + bx + by) *
         static_cast<long long>(sizeof(float));
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// `counts` may be null: every block then walks its whole bucket.
extern "C" int stkde_tile_launch(const void* pts, const void* valid,
                                 const void* counts, void* out,
                                 int ntx, int nty, int ntt,
                                 int bx, int by, int bt, int cap, int panel,
                                 float ox, float oy, float ot,
                                 float sres, float tres, float hs, float ht,
                                 float norm, int ks_id, int kt_id,
                                 void* stream) {
  TileParams p;
  p.ox = ox; p.oy = oy; p.ot = ot;
  p.sres = sres; p.tres = tres; p.hs = hs; p.ht = ht; p.norm = norm;
  p.ntx = ntx; p.nty = nty; p.ntt = ntt;
  p.bx = bx; p.by = by; p.bt = bt;
  p.cap = cap; p.panel = panel; p.kt_id = kt_id;

  auto kernel = ks_id == KS_EPANECHNIKOV
                    ? stkde_tile_kernel<KS_EPANECHNIKOV>
                    : stkde_tile_kernel<KS_PAPER_VERBATIM>;
  const long long smem = stkde_tile_smem_bytes(bx, by, panel);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long ntiles = static_cast<long long>(ntx) * nty * ntt;
  kernel<<<static_cast<unsigned int>(ntiles), THREADS,
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(valid),
      static_cast<const int*>(counts), static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}
