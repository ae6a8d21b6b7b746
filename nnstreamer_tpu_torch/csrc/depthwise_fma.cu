// Depthwise 3x3 convolution in XLA:CPU's fused multiply-add order, for
// Hopper (sm_90a).
//
//     out = fmaf(x_8 w_8, ... fmaf(x_2 w_2, fmaf(x_0, w_0, x_1 w_1)))
//
// over the nine taps of each output element in (ky, kx) order, tap 1's
// product rounded on its own: the order in which XLA:CPU, under jit,
// contracts nnstreamer_tpu's shifted multiply-add chain
// (models/tflite_import.py::depthwise_shift_add, ``acc + sl * w``) at the
// shapes listed in models/tflite_import.py::DEPTHWISE_FMA_SHAPES, which are
// all 3x3, undilated, channel multiplier 1, at strides 1 and 2; nothing
// else is built. On a fake-quantized input x = k*s, the tap whose slice is
// the whole unpadded input (``direct``: the centre tap of a stride-1 SAME
// window) is k * (s*w), as XLA's simplifier reassociates it. Every step
// is written with __fmaf_rn / __fmul_rn so that nvcc neither contracts nor
// splits anything on its own.
//
// Not a TPU kernel's port: the reference's depthwise conv is XLA's
// elementwise code, not Pallas.
//
// Bound on an H100 SXM: 18 operations per output against one read of x
// and one write of out, far under the card's float32 ridge, so the bytes
// bound it. Design: a block computes an 8 x 8 tile of output pixels for
// 32 channels of one image. It first stages the input tile those outputs
// read, halo included, in shared memory, one warp loading one pixel's 32
// channels (a 128-byte line) at a time; each input value is then read
// from device memory once per block, and the halo a second time by the
// neighbouring block (an 8 x 8 tile reads 10 x 10 input pixels at stride
// 1, 17 x 17 at stride 2). Warp w computes output column w of the tile,
// lane l channel l, down the tile's eight rows, every tap read from
// shared memory without bank conflicts. Where the chain is summed from
// does not change its bits.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;            // channels of a block, one per lane
constexpr int kWarps = 8;             // output columns of a block
constexpr int kThreads = kLanes * kWarps;
constexpr int kTileH = 8;             // output rows of a block

// S the stride; kDirect: the centre tap (4) is the direct tap (stride 1)
template <int S, bool kDirect>
__global__ void __launch_bounds__(kThreads)
depthwise_fma_3x3(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int h, int wd, int c, int oh,
                  int ow, int pad_t, int pad_l, float in_scale) {
  constexpr int kInH = (kTileH - 1) * S + 3, kInW = (kWarps - 1) * S + 3;
  __shared__ float tile[kInH * kInW][kLanes];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int cblocks = (c + kLanes - 1) / kLanes;
  const int b = blockIdx.z / cblocks;
  const int ch = (blockIdx.z % cblocks) * kLanes + lane;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kWarps;
  const int y0 = i0 * S - pad_t, x0 = j0 * S - pad_l;
  const float* xn = x + static_cast<long long>(b) * h * wd * c;
  // the input tile with its halo; a padded tap reads 0, as the
  // reference's zero-padded slice does
  for (int p = warp; p < kInH * kInW; p += kWarps) {
    const int y = y0 + p / kInW, xx = x0 + p % kInW;
    tile[p][lane] =
        (ch < c && y >= 0 && y < h && xx >= 0 && xx < wd)
            ? __ldg(xn + (static_cast<long long>(y) * wd + xx) * c + ch)
            : 0.f;
  }
  float wv[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wv[k] = ch < c ? __ldg(w + k * c + ch) : 0.f;
  if (kDirect) wv[4] = __fmul_rn(in_scale, wv[4]);
  __syncthreads();
  const int j = j0 + warp;
  if (ch >= c || j >= ow) return;
  for (int r = 0; r < kTileH && i0 + r < oh; ++r) {
    float v[9];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        v[ky * 3 + kx] = tile[(r * S + ky) * kInW + warp * S + kx][lane];
    if (kDirect)  // k = round(x / s) exactly: |k| <= 255
      v[4] = rintf(__fdiv_rn(v[4], in_scale));
    float acc = __fmaf_rn(v[0], wv[0], __fmul_rn(v[1], wv[1]));
#pragma unroll
    for (int k = 2; k < 9; ++k) acc = __fmaf_rn(v[k], wv[k], acc);
    out[((static_cast<long long>(b) * oh + i0 + r) * ow + j) * c + ch] = acc;
  }
}

}  // namespace

// x (n, h, wd, c) NHWC float32, w (3, 3, c) float32 (tflite's [1, 3, 3, c]
// without its leading 1), out (n, oh, ow, c); stride 1 or 2 on both axes,
// pad_t / pad_l the zero rows and columns before the input; direct is the
// reassociated tap's index (4, the centre, at stride 1) or -1, in_scale
// the input's scale s.
extern "C" int nns_depthwise_fma(const void* x, const void* w, void* out,
                                 int n, int h, int wd, int c, int oh, int ow,
                                 int stride, int pad_t, int pad_l,
                                 int direct, float in_scale, void* stream) {
  if (n < 0 || h <= 0 || wd <= 0 || c <= 0 || oh < 0 || ow < 0 ||
      (stride != 1 && stride != 2) || pad_t < 0 || pad_l < 0 ||
      (direct != -1 && (direct != 4 || stride != 1 || !(in_scale > 0.f))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || oh == 0 || ow == 0) return 0;
  const long long zs =
      static_cast<long long>(n) * ((c + kLanes - 1) / kLanes);
  if (zs > 65535 || (oh + kTileH - 1) / kTileH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((ow + kWarps - 1) / kWarps),
                  static_cast<unsigned>((oh + kTileH - 1) / kTileH),
                  static_cast<unsigned>(zs));
  const auto* fx = static_cast<const float*>(x);
  const auto* fw = static_cast<const float*>(w);
  auto* fo = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (direct == 4)
    depthwise_fma_3x3<1, true><<<grid, kThreads, 0, st>>>(
        fx, fw, fo, h, wd, c, oh, ow, pad_t, pad_l, in_scale);
  else if (stride == 1)
    depthwise_fma_3x3<1, false><<<grid, kThreads, 0, st>>>(
        fx, fw, fo, h, wd, c, oh, ow, pad_t, pad_l, in_scale);
  else
    depthwise_fma_3x3<2, false><<<grid, kThreads, 0, st>>>(
        fx, fw, fo, h, wd, c, oh, ow, pad_t, pad_l, in_scale);
  return static_cast<int>(cudaGetLastError());
}
