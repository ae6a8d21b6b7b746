// Exact (flash) attention over a whole sequence for Hopper (sm_90a).
//
// Replaces the TPU kernel nnstreamer_tpu/ops/pallas_attention.py::_attn_kernel
// (reached through flash_attention, pallas_call at :89):
//     out = softmax(q . K^T / sqrt(D) [, k_pos <= q_pos]) . V
// for q, k, v of shape (B, H, S, D), with the online softmax (running max m,
// sum l, accumulator acc) in f32 over key tiles, so the S x S score matrix
// never reaches device memory. Under the causal mask the key loop stops at
// the diagonal tile.
//
// Bound on an H100 SXM: in f32, operations. A causal pass does
// S(S+1)/2 * 4D flops per (b, h) (q.k and p.v, two each per element), at
// B=8, H=16, S=512, D=64 about 4.3 GFLOP, 0.064 ms at the 67 TFLOP/s of the
// CUDA cores, against 67 MB of q/k/v/o, 0.020 ms at 3.35 TB/s. In bf16 the
// bytes halve and, at the tensor cores' rate, bytes bound it (0.010 ms).
// This kernel does all its arithmetic in f32 on the CUDA cores, for bf16
// inputs too; no TF32 and no library call.
//
// Design: one block of 256 threads per (b, h, 64-row q tile); a loop inside
// the block walks the 64-key tiles (the TPU's sequential fori_loop). Thread
// (ty, tx) = (tid / 16, tid % 16) owns the 4 q rows ty*4.. and, in the
// score tile, the 4 keys tx*4..; in the output, the D/16 columns
// tx*(D/16).. (for D = 8, threads tx < 8 one column each). So a row's 16
// owners are 16 lanes of one warp, and the row's max and sum are 4
// shuffles, with m and l kept in registers, replicated across them. Q and
// each K tile are kept transposed in shared memory (d-major), so a step of
// the q.k loop is one float4 load of 4 rows of Q (2 addresses a warp,
// broadcast) and one of 4 keys; the weights P are stored transposed too
// (key-major), so a step of the p.v loop is one float4 load of P and the
// thread's values of one V row. Everything is widened to f32 when it is
// loaded. Rows and keys past S are zero-filled and masked, so S
// need not be a multiple of the tile.
//
// Later work, not done here: tensor cores (mma.sync / wgmma) in bf16,
// cp.async or TMA double-buffering of the K/V tiles, and a larger q tile
// per block with fewer redundant K/V reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // q rows per block and keys per tile
constexpr int kLd = kTile + 4;      // row stride of the transposed tiles:
                                    // keeps float4 alignment, spreads banks

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// reduce over the 16 lanes that own one row (lanes differ in bits 0-3)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Load a kTile x D tile (rows [row0, row0 + kTile) of a (S, D) slice),
// transposed into dst[d * kLd + r], widened to f32 and times `mul`; rows
// past S are zero.
template <int D, typename T>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                int row0, int s_len,
                                                float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float x =
        row0 + r < s_len ? to_f32(src[(size_t)(row0 + r) * D + d]) * mul : 0.f;
    dst[d * kLd + r] = x;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int s_len, int n_qtiles, int causal, float scale) {
  constexpr int kCols = D >= 16 ? D / 16 : 1;  // output columns a thread
  const bool owns_cols = (threadIdx.x & 15) * kCols < D;
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;                // [D][kLd]: scaled q, d-major
  float* k_t = q_t + D * kLd;       // [D][kLd]: a key tile, d-major
  float* v_s = k_t + D * kLd;       // [kTile][D]: a value tile
  float* p_t = v_s + kTile * D;     // [kTile][kLd]: weights, key-major

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x / n_qtiles, qt = blockIdx.x % n_qtiles;
  const size_t base = (size_t)bh * s_len * D;
  const int q0 = qt * kTile;

  load_transposed<D>(q_t, q + base, q0, s_len, scale);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = (s_len + kTile - 1) / kTile;
  const int n_tiles = causal ? qt + 1 : n_kv;  // causal: stop at the diagonal
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's k_t, v_s and p_t are consumed
    load_transposed<D>(k_t, k + base, k0, s_len, 1.f);
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int r = i / D;
      v_s[i] = k0 + r < s_len ? to_f32(v[base + (size_t)k0 * D + i]) : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(q_t + d * kLd + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(k_t + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask, then the online-softmax update of this thread's 4 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        ok[j] = kp < s_len && (!causal || kp <= qp);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_t + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile && owns_cols; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(p_t + kk * kLd + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float* vr = v_s + kk * D + tx * kCols;
      float bv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bv[j] = vr[j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= s_len || !owns_cols) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + base + (size_t)qp * D + tx * kCols;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(o + j, acc[i][j] * inv_l);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int s_len, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * D * kLd + kTile * D + kTile * kLd) * sizeof(float);
  auto kernel = flash_attention_kernel<D, T>;
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (s_len + kTile - 1) / kTile;
  kernel<<<bh * n_qtiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s_len, n_qtiles, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int s_len, int d_head, int causal, float scale,
             cudaStream_t stream) {
  switch (d_head) {
    case 8: return launch<8, T>(q, k, v, out, bh, s_len, causal, scale, stream);
    case 16: return launch<16, T>(q, k, v, out, bh, s_len, causal, scale, stream);
    case 32: return launch<32, T>(q, k, v, out, bh, s_len, causal, scale, stream);
    case 64: return launch<64, T>(q, k, v, out, bh, s_len, causal, scale, stream);
    case 128: return launch<128, T>(q, k, v, out, bh, s_len, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out: (bh, s_len, d_head) contiguous, all f32 or all bf16;
// d_head in {8, 16, 32, 64, 128}. Launches on `stream` and returns a CUDA error
// code (0 on success).
extern "C" int nns_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, int bh,
                                   int s_len, int d_head, int causal,
                                   int bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, bh, s_len, d_head,
                                        causal, scale, s)
              : dispatch<float>(q, k, v, out, bh, s_len, d_head, causal,
                                scale, s);
}
