// Fused Harris response + 3x3 non-max suppression for Hopper (sm_90a).
//
// Replaces the TPU kernel okvis2_tpu/ops/harris_pallas.py::harris_nms_pallas
// (body _band_kernel). It computes the function of the XLA path,
// okvis2_tpu/frontend/detection.py::harris_response + _nms3, for a
// [C,H,W] float32 stack:
//   Sobel gradients (shift-adds, /8) -> products Ixx, Iyy, Ixy ->
//   3x3 box (/9) -> response det - k*tr^2 -> 3x3 NMS (value kept where it
//   is >= its 8 neighbours, else -inf).
//
// Borders wrap cyclically (indices modulo H and W), as jnp.roll / torch.roll
// do in the plain version. The Pallas band kernel clamps its halo instead;
// that is not copied, because detection normalises by the std of the WHOLE
// response map and sub-pixel offsets roll across the border, so border
// values reach every score.
//
// Rounding: every operation uses the explicitly rounded intrinsics
// (__fadd_rn, __fmul_rn, ...), which nvcc never contracts into FMAs, in
// the plain version's operation order (okvis2_torch/ops/harris_cuda.py,
// whose Sobel and box passes are separable). The kernel therefore
// reproduces the plain PyTorch version bit for bit.
//
// Bound at the main path's shape [2,480,752]: memory. The function must read
// the image once and write two maps: 3*C*H*W*4 B = 8.66 MB, about 2.6 us at
// 3.35 TB/s. Its arithmetic is ~44 flops per pixel (31.8 MFLOP), about
// 0.5 us at 67 TFLOP/s of float32.
//
// Design: a separable row pipeline, one warp per block and task. A task is
// one camera, a strip of SW output columns and a run of RB output rows
// (grid = strips x runs x cameras). Each lane owns CPL adjacent columns; the
// HL lanes at each end of the warp are the strip's halo and only feed their
// neighbours. The warp walks down the RB + 6 image rows its run needs and,
// for each new image row, computes in order: the [1,2,1] smoothing along
// the row; the [1,2,1] smoothing down the column (three image rows held in
// registers); ix and iy; the three products; their horizontal 3-sums; the
// vertical 3-sum of the last three rows' sums, * (1/9); the response; its
// horizontal 3-max; and, with the last three rows' maxima, the NMS. Every
// intermediate is computed once per column and row of the walk. Horizontal
// neighbours come by warp shuffle (two per exchanged row of values, six
// such rows per image row); vertical neighbours stay in registers.
// Against the 32x8-tile design it replaces, which was issue- and latency-
// bound, not bandwidth-bound:
//   1. Shared-memory traffic: none. The tile design staged image, products
//      and response in shared memory (~67 accesses per output, each pass
//      recomputing the next one's halo); here 12 shuffles per lane and
//      image row carry all horizontal traffic, 3 per output at CPL = 4.
//   2. Index math: each lane's wrapped columns are computed once (a modulo
//      only in the strips on the image's edge) and the row pointer advances
//      by W, reset to row 0 when it passes H. No per-element division, and
//      the 3-D grid needs none per task either.
//   3. Loads: the loads of all RB + 6 image rows of a run are issued
//      before any arithmetic, straight into registers: the run's whole
//      region is in flight at once, with no shared memory and no barrier.
//      Where W % 4 == 0 and the pointers are 16-byte aligned they are
//      float4 vectors, in the strips on the edge too; otherwise the same
//      kernel takes scalar accesses.
//      TMA is not used: the region of a run is 13 rows of 512 B, it would
//      stage through shared memory only to be read back into registers, and
//      its zero fill at the edges is not the cyclic halo.
// CPL = 4 gives strips of 120 columns; RB = 7 is the fastest of the run
// depths harris_bench.py times (PERF.md).
//
// nvcc -Xptxas -v, sm_90a: the vector instance (VEC) 111
// registers, the scalar one 113; no shared memory, no barriers, 0 bytes
// stack frame, 0 bytes spilled. chip_smoke.py prints it in its build phase.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CPL = 4;                   // columns per lane (one float4)
constexpr int RB = 7;                    // output rows per warp
constexpr int NR = RB + 6;               // image rows a warp walks (halo 3 + 3)
constexpr int HL = 1;                    // halo lanes on each side of the warp (3 px <= CPL)
constexpr int SW = (32 - 2 * HL) * CPL;  // output columns per warp (the strip): 120
constexpr unsigned FULL = 0xffffffffu;

// (a + b) + c: one pass of the 3-tap box, and of the [1,2,1] smoothing of
// the Sobel operator with b = 2 p (exact)
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, b), c);
}

// The lane's CPL values with the left neighbour's last and the right
// neighbour's first: e[j] is column j-1, e[j+1] column j, e[j+2] column j+1.
// Lanes 0 and 31 get their own values at the ends; those columns are halo.
__device__ __forceinline__ void widen(const float (&q)[CPL], float (&e)[CPL + 2]) {
  e[0] = __shfl_up_sync(FULL, q[CPL - 1], 1);
#pragma unroll
  for (int j = 0; j < CPL; ++j) e[j + 1] = q[j];
  e[CPL + 1] = __shfl_down_sync(FULL, q[0], 1);
}

// Shift a ring of three rows and put `v` in as the newest (index 2, row y+1).
__device__ __forceinline__ void push(float (&ring)[3][CPL], const float (&v)[CPL]) {
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    ring[0][j] = ring[1][j];
    ring[1][j] = ring[2][j];
    ring[2][j] = v[j];
  }
}

template <bool VEC>
__device__ __forceinline__ void load_row(float (&dst)[CPL], const float* __restrict__ row,
                                         const int (&col)[CPL]) {
  if constexpr (VEC) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row + col[0]));
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < CPL; ++j) dst[j] = __ldg(row + col[j]);
  }
}

template <bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ row, int c0, int W,
                                          const float (&v)[CPL]) {
  if constexpr (VEC) {
    if (c0 < W) *reinterpret_cast<float4*>(row + c0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (c0 + j < W) row[c0 + j] = v[j];
  }
}

// One warp per block; grid = (strips, runs of RB rows, cameras). A warp walks
// down the RB + 6 image rows [y0 - 3, y0 + RB + 3), wrapped, and writes its
// RB output rows [y0, y0 + RB).
// VEC: W % 4 == 0 and all three pointers 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(32)
harris_nms_kernel(const float* __restrict__ img, float* __restrict__ resp_out,
                  float* __restrict__ nms_out, int H, int W, float k) {
  const size_t plane = (size_t)H * (size_t)W;
  const float* im = img + blockIdx.z * plane;
  float* ro = resp_out + blockIdx.z * plane;
  float* no = nms_out + blockIdx.z * plane;

  // this lane's columns, wrapped once; only strips on the edge take the modulo
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * SW + (lane - HL) * CPL;
  int col[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    int c = c0 + j;
    if (c < 0 || c >= W) {
      c %= W;
      if (c < 0) c += W;
    }
    col[j] = c;
  }
  const bool store_lane = lane >= HL && lane < 32 - HL;

  // the first image row of the walk, wrapped once; only the first run
  // takes the modulo
  const int y0 = blockIdx.y * RB;
  int rl = y0 - 3;
  if (rl < 0) {
    rl %= H;
    if (rl < 0) rl += H;
  }
  const float* rowp = im + (size_t)rl * W;
  auto next_row = [&]() {
    if (++rl == H) {
      rl = 0;
      rowp = im;
    } else {
      rowp += W;
    }
  };

  float px[NR][CPL];  // image rows, all loaded before the compute
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    load_row<VEC>(px[i], rowp, col);
    next_row();
  }
  const float ninth = (float)(1.0 / 9.0);
  float sh[3][CPL] = {};     // sm_h of image rows i-2, i-1, i
  float hs[3][3][CPL] = {};  // horizontal 3-sums of (xx, yy, xy), rows i-3, i-2, i-1
  float rs[3][CPL] = {};     // response of rows i-4, i-3, i-2
  float hm[3][CPL] = {};     // its horizontal 3-max, same rows

#pragma unroll
  for (int i = 0; i < NR; ++i) {
    // 1. image row i: [1,2,1] along the row, sm_h = (p[x+1] + 2 p[x]) + p[x-1]
    {
      float v[CPL], e[CPL + 2];
      widen(px[i], e);
#pragma unroll
      for (int j = 0; j < CPL; ++j) v[j] = sum3(e[j + 2], __fmul_rn(2.0f, e[j + 1]), e[j]);
      push(sh, v);
    }
    if (i < 2) continue;

    // 2. image row i-1: sm_v = (p[y+1] + 2 p[y]) + p[y-1] down the column,
    //    ix = (sm_v[x+1] - sm_v[x-1]) / 8, iy = (sm_h[y+1] - sm_h[y-1]) / 8,
    //    the products and their horizontal 3-sums (P[x+1] + P[x]) + P[x-1]
    {
      float sv[CPL], ev[CPL + 2], p[3][CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        sv[j] = sum3(px[i][j], __fmul_rn(2.0f, px[i - 1][j]), px[i - 2][j]);
      widen(sv, ev);
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const float ix = __fmul_rn(__fsub_rn(ev[j + 2], ev[j]), 0.125f);
        const float iy = __fmul_rn(__fsub_rn(sh[2][j], sh[0][j]), 0.125f);
        p[0][j] = __fmul_rn(ix, ix);
        p[1][j] = __fmul_rn(iy, iy);
        p[2][j] = __fmul_rn(ix, iy);
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float v[CPL], e[CPL + 2];
        widen(p[q], e);
#pragma unroll
        for (int j = 0; j < CPL; ++j) v[j] = sum3(e[j + 2], e[j + 1], e[j]);
        push(hs[q], v);
      }
    }
    if (i < 4) continue;

    // 3. image row i-2: box = ((hs[y+1] + hs[y]) + hs[y-1]) / 9, the
    //    response det - (k tr) tr, and its horizontal 3-max
    {
      float r[CPL], m[CPL], e[CPL + 2];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const float xx = __fmul_rn(sum3(hs[0][2][j], hs[0][1][j], hs[0][0][j]), ninth);
        const float yy = __fmul_rn(sum3(hs[1][2][j], hs[1][1][j], hs[1][0][j]), ninth);
        const float xy = __fmul_rn(sum3(hs[2][2][j], hs[2][1][j], hs[2][0][j]), ninth);
        const float det = __fsub_rn(__fmul_rn(xx, yy), __fmul_rn(xy, xy));
        const float tr = __fadd_rn(xx, yy);
        r[j] = __fsub_rn(det, __fmul_rn(__fmul_rn(k, tr), tr));
      }
      widen(r, e);
#pragma unroll
      for (int j = 0; j < CPL; ++j) m[j] = fmaxf(fmaxf(e[j], e[j + 1]), e[j + 2]);
      push(rs, r);
      push(hm, m);
    }
    if (i < 6) continue;

    // 4. image row i-3 (output row y0 + i - 6): 3x3 NMS and the two stores
    const int y = y0 + i - 6;
    if (store_lane && y < H) {
      float n[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const float m = fmaxf(fmaxf(hm[0][j], hm[1][j]), hm[2][j]);
        n[j] = rs[1][j] >= m ? rs[1][j] : -INFINITY;
      }
      store_row<VEC>(ro + (size_t)y * W, c0, W, rs[1]);
      store_row<VEC>(no + (size_t)y * W, c0, W, n);
    }
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*). Returns
// cudaGetLastError() so the caller sees a refused launch, or -1 for a
// shape the grid cannot hold (more than 65535 cameras or runs of rows).
extern "C" int harris_nms_launch(const float* img, float* resp, float* nms,
                                 int C, int H, int W, float k, void* stream) {
  const int n_strips = (W + SW - 1) / SW, n_runs = (H + RB - 1) / RB;
  if (C < 1 || H < 1 || W < 1 || C > 65535 || n_runs > 65535) return -1;
  const dim3 grid(n_strips, n_runs, C);
  const bool vec = W % 4 == 0 && aligned(img) && aligned(resp) && aligned(nms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    harris_nms_kernel<true><<<grid, 32, 0, s>>>(img, resp, nms, H, W, k);
  else
    harris_nms_kernel<false><<<grid, 32, 0, s>>>(img, resp, nms, H, W, k);
  return static_cast<int>(cudaGetLastError());
}
