// PB-SYM tile accumulation for NVIDIA Hopper (sm_90a): work items over the
// tiles' points, the contraction in 3xTF32 on the tensor cores.
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
// What bounds it on this card: operations. Each (point, column) pair costs
// one ks evaluation and its hi/lo split on the CUDA cores plus 3 * 2 * bt
// TF32 operations on the tensor cores, while the bytes are the buckets read
// once and the grid written once.
//
// What the design does about it:
//  * Work items, not tiles. The grid is a list of items (tile, first point,
//    length, slot), each at most `seg` points long, heaviest first
//    (kernels/stkde_tile.py::plan_segments). A heavy tile is walked by many
//    blocks at once, so no single block sets the kernel's time.
//  * Deterministic reduction, no float atomics. A tile's first item writes
//    straight into `out`; its later items write partial tiles into `scratch`
//    (slot order = segment order), and stkde_reduce_kernel adds them into
//    `out` in that order with IEEE adds.
//  * Exact walks. An item walks exactly its `length` points; the last panel
//    is partly filled, its missing entries give ks = 0 and Kt = 0, so every
//    term left out is an exact zero. An empty tile is one empty item and is
//    written as 0.0.
//  * Tensor cores. M = the tile's columns (x, y), K = points, N = bt in
//    passes of 16. A warp owns 16-column strips; it evaluates ks in
//    registers for exactly the (column, point) pairs of its A fragment of
//    mma.sync m16n8k8 (tf32), splits each value into hi (rounded to TF32)
//    and lo = value - hi, and issues A_lo*B_hi + A_hi*B_lo + A_hi*B_hi
//    against Kt, staged hi/lo per panel in shared memory in fragment order.
//    The tensor cores round their fp32 sums towards zero, so a strip's sum
//    on them is cut after FLUSH k-steps (one panel) and added into the
//    running fp32 sum with a round-to-nearest add.
//  * Little per pair on the CUDA cores. ks's constant factor and norm go
//    into Kt (once per panel and t), so A is only the support-masked shape
//    of ks; for Epanechnikov a panel stages u*u and v*v, so a pair costs an
//    add, a compare, a subtract and a square before its split.
//  * Staging off the critical path. A panel's raw points (x, y, t, valid)
//    are one coalesced load, issued into registers while the panel before
//    is consumed; u, v and Kt are built from the shared copy.
//
// Rounding: u, v, w, r2, the support tests and kt are computed in the order
// of the plain PyTorch version (kernels/ref.py) with IEEE single operations
// that the compiler may not contract (__fadd_rn, __fmul_rn, __fdiv_rn),
// because two of the four kernel functions are not zero at the edge of
// their support and a one-ulp difference there would flip a whole
// contribution. Moving the constant factors into Kt changes a term by a few
// ulps; the split drops less than 2^-21 of a term; both are far inside the
// rtol=1e-5 the kernel is held to.
//
// Tile shapes are run-time values: columns are walked in passes of
// COLS_PER_PASS and bt in passes of BT_PASS. Offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

// The ids the Python side maps its callables to (core/kernels_math.py).
#define KS_EPANECHNIKOV 0
#define KS_PAPER_VERBATIM 1
#define KT_EPANECHNIKOV 0
#define KT_PAPER_VERBATIM 1

namespace {

constexpr int THREADS = 256;               // threads of a block
constexpr int WARPS = THREADS / 32;
constexpr int STRIPS = 8;                  // 16-column strips a warp owns
constexpr int COLS_PER_PASS = WARPS * STRIPS * 16;
constexpr int BT_PASS = 16;                // t values of one pass (2 n-tiles)
constexpr int PANEL = 64;                  // points staged per panel
constexpr int KSTEPS = PANEL / 8;          // mma k-steps of a panel
constexpr int FLUSH = 8;                   // k-steps summed on the tensor cores
constexpr float OUTSIDE = 2.0f;            // u, v of a missing entry: ks = 0
constexpr int RAW = (4 * PANEL + THREADS - 1) / THREADS;  // raw loads a thread

constexpr float TWO_OVER_PI = static_cast<float>(2.0 / 3.14159265358979323846);
constexpr float PI_OVER_TWO = static_cast<float>(3.14159265358979323846 / 2.0);

struct TileParams {
  float ox, oy, ot, sres, tres, hs, ht, bscale;
  int ntx, nty, ntt, bx, by, bt, cap, us, vs, kt_id;
};

// ks without its constant factor (ks_scale, which goes into Kt with norm),
// from what a panel stages: u*u and v*v for Epanechnikov (the only use of u
// and v there), u and v otherwise. r2 and the support test r2 < 1 are
// rounded as in the plain version, so no contribution flips.
template <int KS>
__device__ __forceinline__ float stage_uv(float u) {
  return KS == KS_EPANECHNIKOV ? __fmul_rn(u, u) : u;
}

template <int KS>
__device__ __forceinline__ float ks_shape(float a, float b) {
  if (KS == KS_EPANECHNIKOV) {
    const float r2 = __fadd_rn(a, b);
    const float d = __fsub_rn(1.0f, r2);
    return r2 < 1.0f ? __fmul_rn(d, d) : 0.0f;
  }
  const float r2 = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
  const float x = __fsub_rn(1.0f, a);
  const float y = __fsub_rn(1.0f, b);
  return r2 < 1.0f ? __fmul_rn(__fmul_rn(x, x), __fmul_rn(y, y)) : 0.0f;
}

constexpr float ks_scale(int ks_id) {
  return ks_id == KS_EPANECHNIKOV ? TWO_OVER_PI : PI_OVER_TWO;
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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi = x rounded to TF32 (to nearest, ties away, as cvt.rna for the finite,
// non-negative values of A), lo = x - hi exactly. lo goes to the tensor
// cores as it is, which drop its last 13 bits: |error| < 2^-21 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a * b on the tensor cores; a is a 16x8 row fragment, b an 8x8 column
// fragment, d a 16x8 fp32 fragment (PTX ISA, mma.m16n8k8 .tf32).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row stride of a shared (PANEL, n) array: >= n, == 8 or 24 (mod 32), so the
// four points of an A fragment's column fall into different banks.
__host__ __device__ inline int smem_stride(int n) {
  int s = (n + 7) / 8 * 8;
  if (s % 16 == 0) s += 8;
  return s;
}

// Shared memory layout of a block, in floats.
constexpr int SB_FLOATS = KSTEPS * 2 * 32 * 4;  // Kt hi/lo, fragment order
constexpr int SCOL_FLOATS = COLS_PER_PASS * 2;  // (x, y) of a pass's columns
constexpr int SRAW_FLOATS = 4 * PANEL;          // x, y, t, valid of a panel

// The raw panel is 3 * PANEL coordinates, then PANEL valid flags: entry i of
// the panel that starts at point q0 (0.0 past the item's end), read as one
// coalesced run, and where it goes in the (4, PANEL) shared copy.
__device__ __forceinline__ float load_raw(const float* seg_pts,
                                          const float* seg_valid, int q0,
                                          int len, int i) {
  if (i < 3 * PANEL)
    return q0 + i / 3 < len ? seg_pts[static_cast<int64_t>(q0) * 3 + i] : 0.0f;
  const int q = i - 3 * PANEL;
  return q < PANEL && q0 + q < len ? seg_valid[q0 + q] : 0.0f;
}

__device__ __forceinline__ int raw_slot(int i) {
  return i < 3 * PANEL ? (i % 3) * PANEL + i / 3 : i;
}

template <int KS>
__global__ void __launch_bounds__(THREADS, 2)
stkde_tile_kernel(const float* __restrict__ pts,    // (ntiles, cap, 3)
                  const float* __restrict__ valid,  // (ntiles, cap)
                  const int4* __restrict__ items,   // (n_items) work items
                  float* __restrict__ out,          // (ntx*bx, nty*by, ntt*bt)
                  float* __restrict__ scratch,      // (slots, bx*by*bt)
                  const TileParams p) {
  extern __shared__ __align__(16) float smem[];
  float4* sb = reinterpret_cast<float4*>(smem);     // (KSTEPS, 2, 32)
  int2* scol = reinterpret_cast<int2*>(smem + SB_FLOATS);
  float* su = smem + SB_FLOATS + SCOL_FLOATS;       // (PANEL, us)
  float* sv = su + PANEL * p.us;                    // (PANEL, vs)
  float* sraw = sv + PANEL * p.vs;                  // (4, PANEL)

  const int4 item = items[blockIdx.x];
  const int tile_id = item.x, first = item.y, len = item.z, slot = item.w;
  const int tk = tile_id % p.ntt;
  const int tj = (tile_id / p.ntt) % p.nty;
  const int ti = tile_id / (p.ntt * p.nty);
  const float* seg_pts =
      pts + (static_cast<int64_t>(tile_id) * p.cap + first) * 3;
  const float* seg_valid = valid + static_cast<int64_t>(tile_id) * p.cap + first;

  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int ncols = p.bx * p.by;
  const int64_t tile_elems = static_cast<int64_t>(ncols) * p.bt;
  const int64_t stride_y = static_cast<int64_t>(p.ntt) * p.bt;
  const int64_t stride_x = static_cast<int64_t>(p.nty) * p.by * stride_y;

  for (int c0 = 0; c0 < ncols; c0 += COLS_PER_PASS) {
    for (int t0 = 0; t0 < p.bt; t0 += BT_PASS) {
      const bool two_nt = t0 + 8 < p.bt;  // the second n-tile holds a t
      float acc[STRIPS][2][4];
#pragma unroll
      for (int s = 0; s < STRIPS; ++s)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[s][nt][i] = 0.0f;

      __syncthreads();  // the previous pass has read scol
      for (int i = threadIdx.x; i < COLS_PER_PASS; i += THREADS) {
        const int c = c0 + i;
        scol[i] = c < ncols ? make_int2(c / p.by, c % p.by) : make_int2(0, 0);
      }

      // The first raw panel; each later one is loaded into registers while
      // the panel before it is consumed, then stored for its staging.
      float raw[RAW];
#pragma unroll
      for (int r = 0; r < RAW; ++r) {
        const int i = static_cast<int>(threadIdx.x) + r * THREADS;
        if (i < SRAW_FLOATS)
          sraw[raw_slot(i)] = load_raw(seg_pts, seg_valid, 0, len, i);
      }

      for (int q0 = 0; q0 < len; q0 += PANEL) {
        __syncthreads();  // the raw panel is in; the previous one is consumed
        // u (u*u for Epanechnikov) for (q, x), v likewise for (q, y); a
        // lane keeps one x (y) and walks the points with the warps' stride.
        for (int x = lane; x < p.bx; x += 32)
          for (int q = warp; q < PANEL; q += WARPS)
            su[q * p.us + x] = stage_uv<KS>(
                q0 + q < len ? offset_over_h(ti * p.bx + x, p.ox, p.sres,
                                             sraw[q], p.hs)
                             : OUTSIDE);
        for (int y = lane; y < p.by; y += 32)
          for (int q = warp; q < PANEL; q += WARPS)
            sv[q * p.vs + y] = stage_uv<KS>(
                q0 + q < len ? offset_over_h(tj * p.by + y, p.oy, p.sres,
                                             sraw[PANEL + q], p.hs)
                             : OUTSIDE);
        for (int i = threadIdx.x; i < PANEL * BT_PASS; i += THREADS) {
          const int q = i / BT_PASS, t = i % BT_PASS;
          float val = 0.0f;
          if (q0 + q < len && t0 + t < p.bt) {
            const float w = offset_over_h(tk * p.bt + t0 + t, p.ot, p.tres,
                                          sraw[2 * PANEL + q], p.ht);
            val = __fmul_rn(__fmul_rn(kt_eval(p.kt_id, w), sraw[3 * PANEL + q]),
                            p.bscale);
          }
          const uint32_t hi = to_tf32(val);
          const uint32_t lo = to_tf32(__fsub_rn(val, __uint_as_float(hi)));
          // B fragment: b0 = B[k = tig][n = g], b1 = B[k = tig + 4][n = g],
          // stored per lane as (b0 hi, b1 hi, b0 lo, b1 lo).
          const int k = q & 7, n = t & 7;
          float* dst = reinterpret_cast<float*>(
                           sb + ((q >> 3) * 2 + (t >> 3)) * 32 + n * 4 + (k & 3)) +
                       (k >> 2);
          dst[0] = __uint_as_float(hi);
          dst[2] = __uint_as_float(lo);
        }
        __syncthreads();

        const bool more = q0 + PANEL < len;
        if (more) {
#pragma unroll
          for (int r = 0; r < RAW; ++r) {
            const int i = static_cast<int>(threadIdx.x) + r * THREADS;
            raw[r] = i < SRAW_FLOATS
                         ? load_raw(seg_pts, seg_valid, q0 + PANEL, len, i)
                         : 0.0f;
          }
        }

        const int nk = min(KSTEPS, (len - q0 + 7) >> 3);
#pragma unroll
        for (int s = 0; s < STRIPS; ++s) {
          const int strip = (s * WARPS + warp) * 16;  // first column in pass
          if (c0 + strip >= ncols) continue;          // warp-uniform
          const int2 ca = scol[strip + g], cb = scol[strip + g + 8];
          for (int kk = 0; kk < nk; kk += FLUSH) {
            float part[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f},
                                {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
            for (int k = 0; k < FLUSH; ++k) {
              const int ks = kk + k;
              if (ks < nk) {
                // A fragment: a0 = (row g, k tig), a1 = (row g+8, k tig),
                // a2 = (row g, k tig+4), a3 = (row g+8, k tig+4).
                const int pa = ks * 8 + tig, pb = pa + 4;
                float a[4];
                a[0] = ks_shape<KS>(su[pa * p.us + ca.x], sv[pa * p.vs + ca.y]);
                a[1] = ks_shape<KS>(su[pa * p.us + cb.x], sv[pa * p.vs + cb.y]);
                a[2] = ks_shape<KS>(su[pb * p.us + ca.x], sv[pb * p.vs + ca.y]);
                a[3] = ks_shape<KS>(su[pb * p.us + cb.x], sv[pb * p.vs + cb.y]);
                uint32_t ahi[4], alo[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) split_tf32(a[i], ahi[i], alo[i]);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                  if (nt == 1 && !two_nt) break;
                  const float4 b = sb[(ks * 2 + nt) * 32 + lane];
                  const uint32_t bh0 = __float_as_uint(b.x);
                  const uint32_t bh1 = __float_as_uint(b.y);
                  mma_tf32(part[nt], alo, bh0, bh1);
                  mma_tf32(part[nt], ahi, __float_as_uint(b.z),
                           __float_as_uint(b.w));
                  mma_tf32(part[nt], ahi, bh0, bh1);
                }
              }
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[s][nt][i] = __fadd_rn(acc[s][nt][i], part[nt][i]);
          }
        }

        // sraw was last read before the barrier above: the next raw panel
        // may go in now, and the barrier at the loop's top publishes it.
        if (more) {
#pragma unroll
          for (int r = 0; r < RAW; ++r) {
            const int i = static_cast<int>(threadIdx.x) + r * THREADS;
            if (i < SRAW_FLOATS) sraw[raw_slot(i)] = raw[r];
          }
        }
      }

      // Every item stores its sums, also when it walked no point at all:
      // the tile's first item into `out`, the others into their slot.
      // D fragment: d0 = (row g, n 2*tig), d1 = (row g, n 2*tig+1),
      // d2 = (row g+8, n 2*tig), d3 = (row g+8, n 2*tig+1).
#pragma unroll
      for (int s = 0; s < STRIPS; ++s) {
        const int strip = (s * WARPS + warp) * 16;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + strip + g + 8 * h;
          if (c >= ncols) continue;
          const int x = c / p.by, y = c - x * p.by;
          float* dst;
          if (slot < 0) {
            dst = out + (static_cast<int64_t>(ti) * p.bx + x) * stride_x +
                  (static_cast<int64_t>(tj) * p.by + y) * stride_y +
                  static_cast<int64_t>(tk) * p.bt;
          } else {
            dst = scratch + slot * tile_elems + static_cast<int64_t>(c) * p.bt;
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int t = t0 + nt * 8 + 2 * tig + j;
              if (t < p.bt) dst[t] = acc[s][nt][2 * h + j];
            }
        }
      }
    }
  }
}

// out[tile] += scratch[first slot], scratch[first slot + 1], ... in that
// order, for every tile that was split over several items.
__global__ void __launch_bounds__(THREADS)
stkde_reduce_kernel(const int* __restrict__ reduce,  // (n_split, 3)
                    const float* __restrict__ scratch,
                    float* __restrict__ out, int nty, int ntt, int bx, int by,
                    int bt) {
  const int* r = reduce + static_cast<int64_t>(blockIdx.x) * 3;
  const int tile_id = r[0], slot0 = r[1], nslots = r[2];
  const int64_t tile_elems = static_cast<int64_t>(bx) * by * bt;
  const int64_t e =
      static_cast<int64_t>(blockIdx.y) * THREADS + threadIdx.x;
  if (e >= tile_elems) return;
  const int tk = tile_id % ntt;
  const int tj = (tile_id / ntt) % nty;
  const int ti = tile_id / (ntt * nty);
  const int t = static_cast<int>(e % bt);
  const int c = static_cast<int>(e / bt);
  const int x = c / by, y = c - x * by;
  const int64_t stride_y = static_cast<int64_t>(ntt) * bt;
  const int64_t stride_x = static_cast<int64_t>(nty) * by * stride_y;
  float* dst = out + (static_cast<int64_t>(ti) * bx + x) * stride_x +
               (static_cast<int64_t>(tj) * by + y) * stride_y +
               static_cast<int64_t>(tk) * bt + t;
  float v = *dst;
  const float* src = scratch + slot0 * tile_elems + e;
  for (int j = 0; j < nslots; ++j) v = __fadd_rn(v, src[j * tile_elems]);
  *dst = v;
}

template <int KS>
cudaError_t prepare(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(stkde_tile_kernel<KS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// Points staged per panel; a work item's length is best a multiple of it.
extern "C" int stkde_tile_panel() { return PANEL; }

// Shared memory one block needs for a tile of bx x by columns, in bytes.
extern "C" long long stkde_tile_smem_bytes(int bx, int by) {
  return (static_cast<long long>(SB_FLOATS) + SCOL_FLOATS + SRAW_FLOATS +
          static_cast<long long>(PANEL) * (smem_stride(bx) + smem_stride(by))) *
         static_cast<long long>(sizeof(float));
}

// Blocks of the split pass that fit on one SM (0 if none, or on error).
extern "C" int stkde_tile_blocks_per_sm(int bx, int by, int ks_id) {
  const long long smem = stkde_tile_smem_bytes(bx, by);
  int n = 0;
  cudaError_t err = ks_id == KS_EPANECHNIKOV
                        ? prepare<KS_EPANECHNIKOV>(static_cast<int>(smem))
                        : prepare<KS_PAPER_VERBATIM>(static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n,
        ks_id == KS_EPANECHNIKOV ? stkde_tile_kernel<KS_EPANECHNIKOV>
                                 : stkde_tile_kernel<KS_PAPER_VERBATIM>,
        THREADS, static_cast<size_t>(smem));
  return err == cudaSuccess ? n : 0;
}

// Launches the split pass over `n_items` work items on `stream` and returns
// cudaGetLastError() (0 = ok). `items` is (n_items, 4) int32: tile, first
// point, length, scratch slot (-1: the tile's first item, into `out`).
extern "C" int stkde_tile_launch(const void* pts, const void* valid,
                                 const void* items, int n_items, void* out,
                                 void* scratch, int ntx, int nty, int ntt,
                                 int bx, int by, int bt, int cap,
                                 float ox, float oy, float ot,
                                 float sres, float tres, float hs, float ht,
                                 float norm, int ks_id, int kt_id,
                                 void* stream) {
  TileParams p;
  p.ox = ox; p.oy = oy; p.ot = ot;
  p.sres = sres; p.tres = tres; p.hs = hs; p.ht = ht;
  p.bscale = ks_scale(ks_id) * norm;
  p.ntx = ntx; p.nty = nty; p.ntt = ntt;
  p.bx = bx; p.by = by; p.bt = bt; p.cap = cap;
  p.us = smem_stride(bx); p.vs = smem_stride(by); p.kt_id = kt_id;

  const int smem = static_cast<int>(stkde_tile_smem_bytes(bx, by));
  const bool epan = ks_id == KS_EPANECHNIKOV;
  const cudaError_t err =
      epan ? prepare<KS_EPANECHNIKOV>(smem) : prepare<KS_PAPER_VERBATIM>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = epan ? stkde_tile_kernel<KS_EPANECHNIKOV>
                     : stkde_tile_kernel<KS_PAPER_VERBATIM>;
  kernel<<<static_cast<unsigned int>(n_items), THREADS,
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(valid),
      static_cast<const int4*>(items), static_cast<float*>(out),
      static_cast<float*>(scratch), p);
  return static_cast<int>(cudaGetLastError());
}

// Launches the reduction over `n_split` split tiles on `stream` and returns
// cudaGetLastError(). `reduce` is (n_split, 3) int32: tile, first slot, slots.
extern "C" int stkde_tile_reduce_launch(const void* reduce, int n_split,
                                        const void* scratch, void* out,
                                        int nty, int ntt, int bx, int by,
                                        int bt, void* stream) {
  const long long elems = static_cast<long long>(bx) * by * bt;
  const dim3 grid(static_cast<unsigned int>(n_split),
                  static_cast<unsigned int>((elems + THREADS - 1) / THREADS));
  stkde_reduce_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(reduce), static_cast<const float*>(scratch),
      static_cast<float*>(out), nty, ntt, bx, by, bt);
  return static_cast<int>(cudaGetLastError());
}
