// Cached-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel nnstreamer_tpu/ops/pallas_decode.py::_decode_kernel
// (reached through cached_decode_attention, pallas_call at :83): one query
// token attends against the prefix [0, pos] of its K/V cache,
//     out = softmax(q . K^T / sqrt(D), keys <= pos) . V,
// with the online softmax (running max m, sum l, accumulator acc) in f32 over
// block_k-key tiles, reading only the ceil((pos+1)/block_k) tiles that hold
// valid keys.
//
// Bound on an H100 SXM: bytes. Every valid key and value row is read once,
// 2*B*H*(pos+1)*D*sizeof(cache) bytes, at 3.35 TB/s; the arithmetic is 4
// flops per element read. At B=8, H=16, D=64, pos=1023 that is 67 MB, about
// 20 us with an f32 cache and about 10 us with bf16.
//
// Design: one block per (b, h) row of the cache, 256 threads. A tile's scores
// are computed a warp per key with the lanes across D (a coalesced read of
// the key row) and a shuffle reduction; the tile's max and sum are block
// reductions (shuffles, then one value per warp in shared memory). For the
// weighted sum, thread t owns column t % D and every (256/D)-th key of the
// tile, so neighbouring threads read neighbouring values of one row; the
// per-thread partial accumulators are summed once at the end. The positions
// past pos are never read. pos is read from device memory, so a decode step
// needs no host sync.
//
// Later work, not done here: split-K flash-decoding over the prefix (B*H=128
// blocks leave the card's 132 SMs one block each), cp.async/TMA pipelining of
// the tiles, and packed bf16 loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Every thread of the block gets the result. The leading barrier comes from
// the caller's data; the trailing one lets `red` be reused at once.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ pos_ptr,
                        float* __restrict__ out, int t_len, int d_head,
                        int block_k, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                // d_head: the scaled query
  float* p_s = q_s + d_head;        // block_k: a tile's scores, then weights
  float* red = p_s + block_k;       // kWarps: block reductions
  float* acc_s = red + kWarps;      // kThreads: partial accumulators

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* qb = q + row * d_head;
  const T* kb = k + row * t_len * d_head;
  const T* vb = v + row * t_len * d_head;

  // keys [0, pos] are visible; a pos past the cache is clamped to its end
  const int pos = min(*pos_ptr, t_len - 1);
  const int n_valid = pos + 1;
  const int n_tiles = pos < 0 ? 0 : (pos + block_k) / block_k;

  for (int d = tid; d < d_head; d += kThreads) q_s[d] = qb[d] * scale;
  __syncthreads();

  const int groups = kThreads / d_head;  // the wrapper checks d_head <= 256
  const int g = tid / d_head, col = tid % d_head;
  const bool owns_col = g < groups;
  float m = -1e30f, l = 0.f, acc = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int base = t * block_k;
    const int valid = min(block_k, n_valid - base);
    // scores: a warp per key, lanes across the head dimension
    for (int j = warp; j < valid; j += kWarps) {
      const T* kr = kb + (size_t)(base + j) * d_head;
      float s = 0.f;
      for (int d = lane; d < d_head; d += 32) s += q_s[d] * to_f32(kr[d]);
      s = warp_sum(s);
      if (lane == 0) p_s[j] = s;
    }
    __syncthreads();
    float mx = -1e30f;
    for (int j = tid; j < valid; j += kThreads) mx = fmaxf(mx, p_s[j]);
    const float m_new = fmaxf(m, block_reduce<true>(mx, red));
    float sum = 0.f;
    for (int j = tid; j < valid; j += kThreads) {
      const float p = expf(p_s[j] - m_new);
      p_s[j] = p;
      sum += p;
    }
    const float alpha = expf(m - m_new);
    // block_reduce's barrier also publishes the weights written above
    l = l * alpha + block_reduce<false>(sum, red);
    m = m_new;
    if (owns_col) {
      acc *= alpha;
      for (int j = g; j < valid; j += groups)
        acc += p_s[j] * to_f32(vb[(size_t)(base + j) * d_head + col]);
    }
    __syncthreads();  // p_s is overwritten by the next tile
  }

  if (owns_col) acc_s[tid] = acc;
  __syncthreads();
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
  for (int d = tid; d < d_head; d += kThreads) {
    float a = 0.f;
    for (int gg = 0; gg < groups; ++gg) a += acc_s[gg * d_head + d];
    out[row * d_head + d] = a * inv_l;
  }
}

}  // namespace

// q, out: (rows, D) f32; k, v: (rows, t_len, D) f32 or bf16, contiguous;
// pos: one int32 on the device. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int nns_decode_attention(const void* q, const void* k,
                                    const void* v, const void* pos, void* out,
                                    int rows, int t_len, int d_head,
                                    int block_k, int kv_bf16, float scale,
                                    void* stream) {
  const size_t smem = (size_t)(d_head + block_k + kWarps + kThreads) *
                      sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_bf16) {
    decode_attention_kernel<__nv_bfloat16><<<rows, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos),
        static_cast<float*>(out), t_len, d_head, block_k, scale);
  } else {
    decode_attention_kernel<float><<<rows, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(pos),
        static_cast<float*>(out), t_len, d_head, block_k, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
