// Cached-decode attention for Hopper (sm_90a): split-K ("flash-decoding")
// with asynchronous copies.
//
// Replaces the TPU kernel nnstreamer_tpu/ops/pallas_decode.py::_decode_kernel
// (reached through cached_decode_attention, pallas_call at :83): one query
// token attends against the prefix [0, pos] of its K/V cache,
//     out = softmax(q . K^T / sqrt(D), keys <= pos) . V,
// in f32, reading only the keys that are visible.
//
// Bound on an H100 SXM: bytes. Every valid key and value row is read once,
// 2*B*H*(pos+1)*D*sizeof(cache) bytes, at 3.35 TB/s; the arithmetic is 4
// flops per element read. At B=8, H=16, D=64, pos=543 that is 35.7 MB, a
// bound of 0.0107 ms with an f32 cache and 0.0053 ms with bf16.
//
// Design. At decode B*H is about the SM count (128 rows at the main shape
// for 132 SMs), and reaching 3.35 TB/s at ~1 us of latency takes some
// 25 KB in flight per SM, so one block per row cannot fill the card:
// - The grid is (B*H) x n_split. n_split is fixed by the wrapper from B*H, T
//   and the SM count, never from pos, so a captured launch replays
//   unchanged. Each block reads pos from the device and takes a share of
//   ceil((pos+1)/n_split) keys rounded up to 16; a block whose share is
//   empty returns at once. At the main shape (B*H = 128) that is 6
//   splits of 96 keys at pos 543: 768 blocks of 128 threads, ~6 per SM.
// - A block's share is contiguous in the cache. Its K rows and then its V
//   rows stream through a 3-stage shared-memory ring of 8 KB stages with
//   16-byte cp.async copies, neighbouring threads on neighbouring
//   addresses: two stages (16 KB) are in flight while the third is
//   consumed, and the first V stages load while the last K stage is scored.
// - Scores are a few lanes per key (8 lanes per 256-byte f32 row, 16 keys a
//   pass, a 3-shuffle reduction), read from shared memory. Because a share
//   is at most ceil(T/n_split) keys, all its scores fit in shared memory, so
//   the block takes their max and sum once, between the K and the V stream,
//   and the weighted sum needs no rescaling.
// - Each split writes its partial (m, l, acc[D]) in f32 to scratch that the
//   wrapper allocates. The last split of a (b, h) to finish, found with an
//   acquire-release atomic counter per row, combines them in one pass of
//   independent L2 loads: m = max m_i, out = sum 2^(m_i-m) acc_i /
//   sum 2^(m_i-m) l_i (scores are kept in log2 units). It resets its
//   counter to 0, so the wrapper's counters stay zero between calls on a
//   stream. A prefix that fits one share is written directly.
// Keys past pos are never read: a NaN there cannot reach the output.
//
// Positions per row: pos is one int32 for every row, or one per batch
// entry (the continuous engine's slots, each at its own position). Row
// r = b*H + h reads pos[r / pos_stride]: the wrapper passes pos_stride = H
// for a (B,) vector and = rows for a single value. Each block derives its
// share from its own row's pos, and n_split stays a function of the shapes,
// so rows at different positions simply leave different numbers of splits
// idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;             // ring slots
constexpr int kStageBytes = 8192;      // one slot: kSub keys of K or of V
constexpr int kShareAlign = 16;        // shares are multiples of 16 keys
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one 16-byte vector of the cache, widened to f32
__device__ __forceinline__ void widen(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
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

template <int D, typename T>
struct Layout {
  static constexpr int kVe = 16 / sizeof(T);   // elements per 16-byte vector
  static constexpr int kNv = D / kVe;          // vectors per key row
  static constexpr int kSub = kStageBytes / (D * sizeof(T));  // keys a slot
  static constexpr int kLanes = kNv < 8 ? kNv : 8;   // lanes per key (scores)
  static constexpr int kKeysPerPass = kThreads / kLanes;
  static constexpr int kGroups = kThreads / kNv;     // key groups (P . V)
  static_assert(D % kVe == 0 && kNv <= kThreads, "head dim");
  // once both streams are consumed the ring holds the acc reduction buffer
  static_assert(kGroups * D * 4 <= kStages * kStageBytes, "ring");
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos_ptr,
                    float* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ counters, int t_len, int pos_stride,
                    float scale_log2) {
  using L = Layout<D, T>;
  constexpr int kVe = L::kVe, kNv = L::kNv, kSub = L::kSub;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);                  // [kStages][kSub][D]
  float* acc_s = reinterpret_cast<float*>(smem);         // [kGroups][D], later
  float* q_s = reinterpret_cast<float*>(smem + kStages * kStageBytes);  // [D]
  float* p_s = q_s + D;                                  // [share]
  __shared__ float ml_s[2];
  __shared__ int last_s;

  const int rows = gridDim.x, row = blockIdx.x;
  const int n_split = gridDim.y, split = blockIdx.y;
  const int tid = threadIdx.x;
  float* o = out + (size_t)row * D;
  // the query's load overlaps the read of pos
  const float q_d = tid < D ? q[(size_t)row * D + tid] : 0.f;

  // keys [0, pos] are visible; a pos past the cache is clamped to its end
  const int n_valid = min(pos_ptr[row / pos_stride], t_len - 1) + 1;
  if (n_valid <= 0) {  // nothing visible: the output is zero
    if (split == 0)
      for (int d = tid; d < D; d += kThreads) o[d] = 0.f;
    return;
  }
  const int per = (n_valid + n_split - 1) / n_split;
  const int share = (per + kShareAlign - 1) / kShareAlign * kShareAlign;
  const int n_active = (n_valid + share - 1) / share;
  const int t0 = split * share;
  if (t0 >= n_valid) return;
  const int n_keys = min(share, n_valid - t0);
  const int n_sub = (n_keys + kSub - 1) / kSub;
  const int n_items = 2 * n_sub;  // K slots, then V slots
  const size_t base = ((size_t)row * t_len + t0) * D;

  // item i < n_sub: K rows [i*kSub, ...); item n_sub + i: the same V rows
  auto load_item = [&](int i) {
    const bool is_v = i >= n_sub;
    const int sub = is_v ? i - n_sub : i;
    const int r0 = sub * kSub;
    const int n_vec = min(kSub, n_keys - r0) * kNv;
    const T* src = (is_v ? v : k) + base + (size_t)r0 * D;
    T* dst = ring + (i % kStages) * kSub * D;
    for (int j = tid; j < n_vec; j += kThreads)
      cp_async16(dst + j * kVe, src + j * kVe);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_items) load_item(i);
    cp_async_commit();
  }
  if (tid < D) q_s[tid] = q_d * scale_log2;

  const int lane_k = tid % L::kLanes;   // scores: lane within a key
  const int grp = tid / kNv, col = tid % kNv;   // P . V: key group, vector
  float acc[kVe];
#pragma unroll
  for (int e = 0; e < kVe; ++e) acc[e] = 0.f;

  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<kStages - 2>();   // this thread's copies of item i landed
    __syncthreads();                // everyone's; slot (i-1) % kStages free
    if (i + kStages - 1 < n_items) load_item(i + kStages - 1);
    cp_async_commit();
    const T* slot = ring + (i % kStages) * kSub * D;
    if (i < n_sub) {
      // scores of this slot's keys, kLanes lanes per key
      const int r0 = i * kSub, n_rows = min(kSub, n_keys - r0);
      for (int j0 = 0; j0 < n_rows; j0 += L::kKeysPerPass) {
        const int j = j0 + tid / L::kLanes;
        float s = 0.f;
        if (j < n_rows) {
#pragma unroll
          for (int c = lane_k; c < kNv; c += L::kLanes) {
            float kv[kVe];
            widen(slot + j * D + c * kVe, kv);
#pragma unroll
            for (int e = 0; e < kVe; ++e) s = fmaf(q_s[c * kVe + e], kv[e], s);
          }
        }
#pragma unroll
        for (int off = L::kLanes / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (j < n_rows && lane_k == 0) p_s[r0 + j] = s;
      }
      continue;
    }
    if (i == n_sub) {
      // every score is in p_s (the barrier above): max, weights and sum
      if (tid < 32) {
        float mx = -INFINITY;
        for (int j = tid; j < n_keys; j += 32) mx = fmaxf(mx, p_s[j]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int j = tid; j < n_keys; j += 32) {
          const float p = exp2f(p_s[j] - mx);
          p_s[j] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (tid == 0) {
          ml_s[0] = mx;
          ml_s[1] = sum;
        }
      }
      __syncthreads();
    }
    // weighted sum of this slot's values: thread (grp, col) owns one
    // 16-byte column vector and every kGroups-th key
    const int r0 = (i - n_sub) * kSub, n_rows = min(kSub, n_keys - r0);
    for (int j = grp; j < n_rows; j += L::kGroups) {
      const float p = p_s[r0 + j];
      float vv[kVe];
      widen(slot + j * D + col * kVe, vv);
#pragma unroll
      for (int e = 0; e < kVe; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is consumed: acc_s may reuse it
#pragma unroll
  for (int e = 0; e < kVe; e += 4)
    *reinterpret_cast<float4*>(acc_s + grp * D + col * kVe + e) =
        make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  __syncthreads();

  const float m = ml_s[0], l = ml_s[1];
  if (n_active == 1) {  // the whole prefix was this block's share
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.f;
      for (int gg = 0; gg < L::kGroups; ++gg) a += acc_s[gg * D + d];
      o[d] = a / l;
    }
    return;
  }
  // partials: acc at part[(row * n_split + split) * D], then (m, l) pairs
  float* part_ml = part + (size_t)rows * n_split * D;
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
    for (int gg = 0; gg < L::kGroups; ++gg) a += acc_s[gg * D + d];
    part[((size_t)row * n_split + split) * D + d] = a;
  }
  if (tid == 0) {
    part_ml[((size_t)row * n_split + split) * 2] = m;
    part_ml[((size_t)row * n_split + split) * 2 + 1] = l;
  }
  // the barrier orders every thread's partial stores before thread 0's
  // release; the last block's acquire orders its reads after all of them
  __syncthreads();
  if (tid == 0) {
    int done;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(done)
                 : "l"(counters + row)
                 : "memory");
    last_s = done + 1 == n_active;
    if (last_s) counters[row] = 0;   // ready for the next call
  }
  __syncthreads();
  if (!last_s) return;

  // combine the n_active partials of this row (other blocks wrote them:
  // read through L2), merged online in one pass whose loads do not depend
  // on each other, so they overlap in one round trip
  const float* racc = part + (size_t)row * n_split * D;
  const float* rml = part_ml + (size_t)row * n_split * 2;
  for (int d = tid; d < D; d += kThreads) {
    float mx = -INFINITY, lsum = 0.f, a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_active; ++s) {
      const float ms = __ldcg(rml + 2 * s), ls = __ldcg(rml + 2 * s + 1);
      const float as = __ldcg(racc + (size_t)s * D + d);
      const float mn = fmaxf(mx, ms);
      const float c_old = exp2f(mx - mn), c_new = exp2f(ms - mn);
      lsum = lsum * c_old + ls * c_new;
      a = a * c_old + as * c_new;
      mx = mn;
    }
    o[d] = a / lsum;
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, void* part, void* counters, int rows, int t_len,
           int pos_stride, int n_split, float scale, cudaStream_t stream) {
  const int max_per = (t_len + n_split - 1) / n_split;
  const int max_share = (max_per + kShareAlign - 1) / kShareAlign * kShareAlign;
  // the ring, then q and the share's scores in f32
  const size_t smem =
      (size_t)kStages * kStageBytes + (size_t)(D + max_share) * 4;
  auto kernel = decode_split_kernel<D, T>;
  if (smem > 48 * 1024) {  // above 48 KB dynamic shared memory is opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(rows, n_split), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), t_len, pos_stride, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* pos,
             void* out, void* part, void* counters, int rows, int t_len,
             int pos_stride, int d_head, int n_split, float scale,
             cudaStream_t s) {
  switch (d_head) {
    case 8: return launch<8, T>(q, k, v, pos, out, part, counters, rows, t_len, pos_stride, n_split, scale, s);
    case 16: return launch<16, T>(q, k, v, pos, out, part, counters, rows, t_len, pos_stride, n_split, scale, s);
    case 32: return launch<32, T>(q, k, v, pos, out, part, counters, rows, t_len, pos_stride, n_split, scale, s);
    case 64: return launch<64, T>(q, k, v, pos, out, part, counters, rows, t_len, pos_stride, n_split, scale, s);
    case 128: return launch<128, T>(q, k, v, pos, out, part, counters, rows, t_len, pos_stride, n_split, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (rows, D) f32; k, v: (rows, t_len, D) f32 or bf16, contiguous and
// 16-byte aligned; D in {8, 16, 32, 64, 128}; pos: int32 on the device, row
// r reading pos[r / pos_stride] (rows / pos_stride values, pos_stride >= 1).
// part: rows * n_split * (D + 2) f32 of scratch; counters: rows int32 that
// are zero (and are left zero). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int nns_decode_attention(const void* q, const void* k,
                                    const void* v, const void* pos, void* out,
                                    void* part, void* counters, int rows,
                                    int t_len, int pos_stride, int d_head,
                                    int n_split, int kv_bf16, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pos_stride < 1) return static_cast<int>(cudaErrorInvalidValue);
  return kv_bf16 ? dispatch<__nv_bfloat16>(q, k, v, pos, out, part, counters,
                                           rows, t_len, pos_stride, d_head,
                                           n_split, scale, s)
                 : dispatch<float>(q, k, v, pos, out, part, counters, rows,
                                   t_len, pos_stride, d_head, n_split, scale,
                                   s);
}
