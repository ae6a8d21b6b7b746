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
// window) is k * (s*w), as XLA's simplifier reassociates it; k is
// rint(x * float32(1/s)), which is k exactly: x * (1/s) is k within a few
// ulps (|k| <= 255, three roundings of 2^-24), far from a half. Every step
// is written with __fmaf_rn / __fmul_rn so that nvcc neither contracts nor
// splits anything on its own.
//
// Not a TPU kernel's port: the reference's depthwise conv is XLA's
// elementwise code, not Pallas.
//
// Bound on an H100 SXM: 18 operations per output against one read of x
// and one write of out, far under the card's float32 ridge, so the bytes
// bound it (3.35 TB/s). Design: a persistent block walks its share of
// tiles, each TH x TW output pixels of one image by CB channels (the
// wrapper picks the tile per shape, ops/depthwise_fma.py::tile_for: whole
// images at 7x7 and most 14x14 shapes, 7 to 28 pixels a side elsewhere,
// the fastest measured at the fixture's shapes). A tile's input,
// halo and zero padding included, is staged in shared memory by 16-byte
// cp.async copies (a pixel's CB channels contiguous; padding zero-filled by
// the copy itself), into a ring of 2 to 4 slots: the next tiles' copies are
// in flight while this tile's FMAs and stores run. A thread owns 4
// channels (every C here is a multiple of 4) of one output column's run of
// R rows: it reads float4 taps from shared memory, keeps the window's
// rows in registers as it walks down (3 new taps a row at stride 1, 6 at
// stride 2), and stores float4s; neighbouring threads hold neighbouring
// channels, so a warp's reads and stores are whole 16-byte runs. Where the
// chain is summed from does not change its bits.

#include <cuda_runtime.h>

namespace {

struct Params {
  const float* x;
  const float* w;
  float* out;
  int h, wd, c, oh, ow, pad_t, pad_l;
  int th, tw, cb, rows;   // the tile and a thread's run of rows
  int in_h, in_w;         // the tile's input, halo included
  int tiles_y, tiles_x, cblocks, tiles;
  float in_scale, inv_scale;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, or 16 zero bytes where `valid` is false (src is not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct TileAt {
  int b, y0, x0, c0;   // image, first output row and column, first channel
};

__device__ __forceinline__ TileAt tile_at(const Params& p, int t) {
  TileAt r;
  int q = t / p.cblocks;
  r.c0 = (t - q * p.cblocks) * p.cb;
  t = q, q = t / p.tiles_x;
  r.x0 = (t - q * p.tiles_x) * p.tw;
  t = q, q = t / p.tiles_y;
  r.y0 = (t - q * p.tiles_y) * p.th;
  r.b = q;
  return r;
}

template <int S>
__device__ __forceinline__ void load_tile(const Params& p, float4* slot,
                                          int t) {
  const TileAt at = tile_at(p, t);
  const int q4 = p.cb / 4;
  const int iy0 = at.y0 * S - p.pad_t, ix0 = at.x0 * S - p.pad_l;
  const float* xn = p.x + static_cast<long long>(at.b) * p.h * p.wd * p.c;
  const int row = p.in_w * q4;   // float4s of an input row of the tile
  for (int e = threadIdx.x; e < row; e += blockDim.x) {
    const int px = e / q4, q = e - px * q4;
    const int xx = ix0 + px, ch = at.c0 + 4 * q;
    const bool col_ok = xx >= 0 && xx < p.wd && ch < p.c;
    const float* src = xn + static_cast<long long>(xx) * p.c + ch;
    for (int iy = 0; iy < p.in_h; ++iy) {
      const int y = iy0 + iy;
      const bool valid = col_ok && y >= 0 && y < p.h;
      cp_async16_zfill(slot + iy * row + e,
                       valid ? src + static_cast<long long>(y) * p.wd * p.c
                             : p.x,
                       valid);
    }
  }
}

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(__fmaf_rn(a.x, b.x, c.x), __fmaf_rn(a.y, b.y, c.y),
                     __fmaf_rn(a.z, b.z, c.z), __fmaf_rn(a.w, b.w, c.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

// S the stride; kDirect: the centre tap (4) is the direct tap (stride 1);
// kSlots tiles' inputs in the ring, kSlots - 1 of them in flight
template <int S, bool kDirect, int kSlots>
__global__ void __launch_bounds__(512)
depthwise_fma_3x3(const Params p) {
  extern __shared__ __align__(16) float4 ring[];
  const int q4 = p.cb / 4;
  const int slot_len = p.in_h * p.in_w * q4;   // float4s
  const int my_tiles =
      (p.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  auto issue = [&](int i) {
    if (i < my_tiles)
      load_tile<S>(p, ring + (i % kSlots) * slot_len,
                   blockIdx.x + i * gridDim.x);
    cp_async_commit();
  };
  // this thread: channel quad cq of output column col, rows r0 .. r1 - 1
  const int cq = threadIdx.x % q4;
  const int rest = threadIdx.x / q4;
  const int col = rest % p.tw;
  const int r0 = rest / p.tw * p.rows;
  const int r1 = min(p.th, r0 + p.rows);
  for (int i = 0; i < kSlots - 1; ++i) issue(i);
  for (int i = 0; i < my_tiles; ++i) {
    cp_async_wait<kSlots - 2>();
    __syncthreads();   // tile i landed; every thread is done with i - 1
    issue(i + kSlots - 1);   // into the slot tile i - 1 was read from
    const TileAt at = tile_at(p, blockIdx.x + i * gridDim.x);
    const int ch = at.c0 + 4 * cq;
    const int ox = at.x0 + col;
    if (r0 < r1 && ch < p.c && ox < p.ow) {
      const float4* t = ring + (i % kSlots) * slot_len;
      float4 wv[9];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        wv[k] = __ldg(reinterpret_cast<const float4*>(p.w + k * p.c + ch));
      if (kDirect) wv[4] = mul4(make_float4(p.in_scale, p.in_scale,
                                            p.in_scale, p.in_scale),
                                wv[4]);
      // the window's three rows of three taps, input rows r * S + ky
      float4 v[3][3];
#define NNS_LOAD_ROW(ky, iy)                                      \
  _Pragma("unroll") for (int kx = 0; kx < 3; ++kx)                \
      v[ky][kx] = t[((iy) * p.in_w + col * S + kx) * q4 + cq];
      NNS_LOAD_ROW(0, r0 * S)
      NNS_LOAD_ROW(1, r0 * S + 1)
      float* o = p.out +
                 ((static_cast<long long>(at.b) * p.oh + at.y0 + r0) * p.ow +
                  ox) * p.c + ch;
      const long long row_step = static_cast<long long>(p.ow) * p.c;
      for (int r = r0; r < r1 && at.y0 + r < p.oh; ++r) {
        if (r > r0) {   // slide the window down by S rows
          if (S == 1) {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              v[0][kx] = v[1][kx], v[1][kx] = v[2][kx];
          } else {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) v[0][kx] = v[2][kx];
            NNS_LOAD_ROW(1, r * S + 1)
          }
        }
        NNS_LOAD_ROW(2, r * S + 2)
        float4 c4 = v[1][1];
        if (kDirect) {   // k = round(x / s), exactly: |k| <= 255
          c4 = make_float4(rintf(__fmul_rn(c4.x, p.inv_scale)),
                           rintf(__fmul_rn(c4.y, p.inv_scale)),
                           rintf(__fmul_rn(c4.z, p.inv_scale)),
                           rintf(__fmul_rn(c4.w, p.inv_scale)));
        }
        float4 acc = fma4(v[0][0], wv[0], mul4(v[0][1], wv[1]));
        acc = fma4(v[0][2], wv[2], acc);
        acc = fma4(v[1][0], wv[3], acc);
        acc = fma4(c4, wv[4], acc);
        acc = fma4(v[1][2], wv[5], acc);
        acc = fma4(v[2][0], wv[6], acc);
        acc = fma4(v[2][1], wv[7], acc);
        acc = fma4(v[2][2], wv[8], acc);
        *reinterpret_cast<float4*>(o) = acc;
        o += row_step;
      }
#undef NNS_LOAD_ROW
    }
  }
  cp_async_wait<0>();
}

template <int S, bool kDirect, int kSlots>
cudaError_t launch(const Params& p, int grid, int threads, int smem,
                   cudaStream_t st) {
  auto* k = depthwise_fma_3x3<S, kDirect, kSlots>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<grid, threads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x (n, h, wd, c) NHWC float32, w (3, 3, c) float32 (tflite's [1, 3, 3, c]
// without its leading 1), out (n, oh, ow, c), all dense and 16-byte
// aligned, c a multiple of 4; stride 1 or 2 on both axes, pad_t / pad_l
// the zero rows and columns before the input; direct is the reassociated
// tap's index (4, the centre, at stride 1) or -1, in_scale the input's
// scale s; the tile th x tw output pixels by cb channels (a multiple of
// 4), a thread's run of `rows` rows, the ring's slots (2 to 4) and the
// grid (blocks) as the wrapper chose them.
extern "C" int nns_depthwise_fma(const void* x, const void* w, void* out,
                                 int n, int h, int wd, int c, int oh, int ow,
                                 int stride, int pad_t, int pad_l,
                                 int direct, float in_scale, int th, int tw,
                                 int cb, int rows, int slots, int grid,
                                 void* stream) {
  if (n < 0 || h <= 0 || wd <= 0 || c <= 0 || c % 4 || oh < 0 || ow < 0 ||
      (stride != 1 && stride != 2) || pad_t < 0 || pad_l < 0 ||
      (direct != -1 && (direct != 4 || stride != 1 || !(in_scale > 0.f))) ||
      th <= 0 || tw <= 0 || cb <= 0 || cb % 4 || rows <= 0 || grid <= 0 ||
      slots < 2 || slots > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || oh == 0 || ow == 0) return 0;
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.out = static_cast<float*>(out);
  p.h = h, p.wd = wd, p.c = c, p.oh = oh, p.ow = ow;
  p.pad_t = pad_t, p.pad_l = pad_l;
  p.th = th, p.tw = tw, p.cb = cb, p.rows = rows;
  p.in_h = (th - 1) * stride + 3, p.in_w = (tw - 1) * stride + 3;
  p.tiles_y = (oh + th - 1) / th, p.tiles_x = (ow + tw - 1) / tw;
  p.cblocks = (c + cb - 1) / cb;
  const long long tiles =
      static_cast<long long>(n) * p.tiles_y * p.tiles_x * p.cblocks;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  p.in_scale = in_scale;
  p.inv_scale = direct == 4 ? 1.0f / in_scale : 0.f;   // float32(1 / s)
  const int threads = (cb / 4) * tw * ((th + rows - 1) / rows);
  const long long smem = 1LL * slots * p.in_h * p.in_w * cb * 4;
  if (threads > 512 || smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int g = static_cast<int>(p.tiles < grid ? p.tiles : grid);
  auto st = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  using Launch = cudaError_t (*)(const Params&, int, int, int, cudaStream_t);
  static const Launch kLaunch[3][3] = {
      {launch<1, true, 2>, launch<1, true, 3>, launch<1, true, 4>},
      {launch<1, false, 2>, launch<1, false, 3>, launch<1, false, 4>},
      {launch<2, false, 2>, launch<2, false, 3>, launch<2, false, 4>}};
  const int kind = direct == 4 ? 0 : stride == 1 ? 1 : 2;
  return static_cast<int>(kLaunch[kind][slots - 2](p, g, threads, sm, st));
}
