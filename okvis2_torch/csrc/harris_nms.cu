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
// the plain version's operation order. The kernel therefore reproduces the
// plain PyTorch version (okvis2_torch/ops/harris_cuda.py) bit for bit.
//
// Bound at the main path's shape [2,480,752]: memory. The function must read
// the image once and write two maps: 3 x 2*480*752*4 B = 8.66 MB, about
// 2.6 us at 3.35 TB/s. Its arithmetic is ~44 flops per pixel (31.8 MFLOP),
// about 0.5 us at 67 TFLOP/s of float32 — negligible.
//
// Design against that bound: one block per 32x8 output tile and camera
// (the camera is grid.z). The tile plus a 3-px halo is read once into shared
// memory; gradient products (halo 2) and the response (halo 1) stay in
// shared memory; resp and nms are each written once. No width or height
// restriction: the ragged edge is masked on the store.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;  // output tile width  (= blockDim.x)
constexpr int TH = 8;   // output tile height (= blockDim.y)
// staged regions: image (halo 3), gradient products (halo 2), response (halo 1)
constexpr int IW = TW + 6, IH = TH + 6;
constexpr int GW = TW + 4, GH = TH + 4;
constexpr int RW = TW + 2, RH = TH + 2;

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// (a + 2 b) + c: the [1,2,1] smoothing of the Sobel operator
__device__ __forceinline__ float smooth121(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, __fmul_rn(2.0f, b)), c);
}

// (a + b) + c: one pass of the 3-tap box
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, b), c);
}

__global__ void __launch_bounds__(TW * TH)
harris_nms_kernel(const float* __restrict__ img, float* __restrict__ resp_out,
                  float* __restrict__ nms_out, int H, int W, float k) {
  __shared__ float s_img[IH][IW];
  __shared__ float s_xx[GH][GW];
  __shared__ float s_yy[GH][GW];
  __shared__ float s_xy[GH][GW];
  __shared__ float s_resp[RH][RW];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const size_t plane = (size_t)H * (size_t)W;
  const float* im = img + (size_t)blockIdx.z * plane;
  const int tid = threadIdx.y * TW + threadIdx.x;
  constexpr int NT = TW * TH;

  // 1. image tile + 3-px halo, cyclic at the borders
  for (int i = tid; i < IH * IW; i += NT) {
    const int ry = i / IW, rx = i % IW;
    const int gy = wrap(y0 - 3 + ry, H), gx = wrap(x0 - 3 + rx, W);
    s_img[ry][rx] = im[(size_t)gy * W + gx];
  }
  __syncthreads();

  // 2. Sobel gradients and their products on the halo-2 region
  //    ix = (smv[x+1] - smv[x-1]) / 8,  smv = [1,2,1] down the column
  //    iy = (smh[y+1] - smh[y-1]) / 8,  smh = [1,2,1] along the row
  for (int i = tid; i < GH * GW; i += NT) {
    const int y = i / GW + 1, x = i % GW + 1;  // position in s_img
    const float smv_r = smooth121(s_img[y + 1][x + 1], s_img[y][x + 1], s_img[y - 1][x + 1]);
    const float smv_l = smooth121(s_img[y + 1][x - 1], s_img[y][x - 1], s_img[y - 1][x - 1]);
    const float smh_d = smooth121(s_img[y + 1][x + 1], s_img[y + 1][x], s_img[y + 1][x - 1]);
    const float smh_u = smooth121(s_img[y - 1][x + 1], s_img[y - 1][x], s_img[y - 1][x - 1]);
    const float ix = __fmul_rn(__fsub_rn(smv_r, smv_l), 0.125f);
    const float iy = __fmul_rn(__fsub_rn(smh_d, smh_u), 0.125f);
    s_xx[y - 1][x - 1] = __fmul_rn(ix, ix);
    s_yy[y - 1][x - 1] = __fmul_rn(iy, iy);
    s_xy[y - 1][x - 1] = __fmul_rn(ix, iy);
  }
  __syncthreads();

  // 3. 3x3 box of the products and the Harris response on the halo-1 region
  const float ninth = (float)(1.0 / 9.0);
  for (int i = tid; i < RH * RW; i += NT) {
    const int y = i / RW + 1, x = i % RW + 1;  // position in s_xx
#define BOX3(S)                                                          \
  __fmul_rn(sum3(sum3(S[y + 1][x + 1], S[y + 1][x], S[y + 1][x - 1]),    \
                 sum3(S[y][x + 1], S[y][x], S[y][x - 1]),                \
                 sum3(S[y - 1][x + 1], S[y - 1][x], S[y - 1][x - 1])),   \
            ninth)
    const float xx = BOX3(s_xx);
    const float yy = BOX3(s_yy);
    const float xy = BOX3(s_xy);
#undef BOX3
    const float det = __fsub_rn(__fmul_rn(xx, yy), __fmul_rn(xy, xy));
    const float tr = __fadd_rn(xx, yy);
    s_resp[y - 1][x - 1] = __fsub_rn(det, __fmul_rn(__fmul_rn(k, tr), tr));
  }
  __syncthreads();

  // 4. 3x3 NMS and the two stores
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gx = x0 + tx, gy = y0 + ty;
  if (gx < W && gy < H) {
    const float r = s_resp[ty + 1][tx + 1];
    float m = r;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, s_resp[ty + dy][tx + dx]);
    const size_t o = (size_t)blockIdx.z * plane + (size_t)gy * W + gx;
    resp_out[o] = r;
    nms_out[o] = r >= m ? r : -INFINITY;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as void*). Returns
// cudaGetLastError() so the caller sees a refused launch.
extern "C" int harris_nms_launch(const float* img, float* resp, float* nms,
                                 int C, int H, int W, float k, void* stream) {
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, C);
  harris_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, resp, nms, H, W, k);
  return static_cast<int>(cudaGetLastError());
}
