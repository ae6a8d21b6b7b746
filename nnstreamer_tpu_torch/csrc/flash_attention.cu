// Exact (flash) attention over a whole sequence for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the TPU kernel nnstreamer_tpu/ops/pallas_attention.py::_attn_kernel
// (reached through flash_attention, pallas_call at :89):
//     out = softmax(q . K^T / sqrt(D) [, k_pos <= q_pos]) . V
// for q, k, v of shape (B, H, S, D), with the online softmax (running max m,
// sum l, accumulator acc) in f32 over key tiles, so the S x S score matrix
// never reaches device memory.
//
// Bound on an H100 SXM. A causal pass does S(S+1)/2 * (4D + 1) operations
// per (b, h) (q.k and p.v, two each per element, and an exp): at B=8,
// H=16, S=512, D=64 about 4.3 GFLOP. bf16 inputs run at the tensor cores'
// 989 TFLOP/s (0.0044 ms) and move 33.6 MB (0.0100 ms at 3.35 TB/s), so
// bytes bound them. f32 inputs run as three TF32 products each (below), at
// 495/3 = 165 TFLOP/s of f32 work: 0.026 ms, against 67.1 MB, 0.020 ms, so
// operations bound them.
//
// Design (FlashAttention-2 on mma.sync). The CUDA cores' 67 TFLOP/s of
// f32 alone put the bound out of reach (0.064 ms), for bf16 inputs too,
// so the products run on the tensor cores:
// - A block of 4 warps owns a 64-row q tile; each warp owns 16 q rows. The
//   block walks 64-key tiles; under the causal mask it stops at the
//   diagonal tile, and only the diagonal tile and a ragged last tile (S not
//   a multiple of 64) are masked. Blocks of the longest causal rows are
//   scheduled first.
// - K and V tiles go through a 2-stage shared-memory ring with 16-byte
//   cp.async copies (rows past S are zero-filled): tile j+1 loads while
//   tile j is multiplied. Rows are padded by 16 bytes, so ldmatrix and the
//   f32 V reads are free of bank conflicts. The q tile is staged in K's
//   second slot and kept in registers, so f32 at D = 64 takes 70 KB of
//   shared memory and 3 blocks fit an SM.
// - S = Q K^T stays in registers (the m16n8 accumulator layout); the row
//   max and the row sum are quad shuffles (the sum once, at the end); P
//   stays in registers as the A operand of P . V.
// - bf16: m16n8k16 bf16 products with f32 accumulation; ldmatrix loads Q and
//   K fragments, ldmatrix.trans the V fragments. P is split into two bf16
//   terms, hi + lo (two products): JAX computes P . V in f32, and P rounded
//   once to bf16 puts an error of up to 2^-9 of each weight into the
//   output, which the bf16 tolerance (rtol 2e-4 + 2^-8, atol 2e-5) does not
//   allow on outputs near zero; a once-rounded P failed it on the card.
//   D = 8 pads the k = 16 fragment with zeros in registers.
// - f32: m16n8k8 TF32 with the 3xTF32 split (x = hi + lo, both TF32;
//   hi.hi + hi.lo + lo.hi), which keeps products to about f32 accuracy
//   (plain TF32 keeps ~3 decimal digits). The f32 accumulator layout of S
//   is used as P's A fragment with the 8 keys of each k-step permuted
//   (A column t <-> key 2t, t + 4 <-> key 2t + 1), and V is read from
//   shared memory in the same permuted order.
//
// Later work, not done here: wgmma with TMA and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;   // q rows per block, 16 per warp
constexpr int kBlockK = 64;            // keys per K/V tile
static_assert(kBlockQ == kBlockK, "the causal diagonal is one tile");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid == false, 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += a . b, 16x8 f32 accumulator
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
// c += a . b to about f32 accuracy: lo.hi + hi.lo + hi.hi (3xTF32)
__device__ __forceinline__ void mma_3xtf32(float* c, const unsigned* a_hi,
                                           const unsigned* a_lo, unsigned b0_hi,
                                           unsigned b1_hi, unsigned b0_lo,
                                           unsigned b1_lo) {
  mma_tf32(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
// (x0, x1) = hi + lo, each a pair of bf16
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int D, typename T>
struct Tile {
  static constexpr int kVe = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int kNv = D / kVe;          // 16-byte vectors per row
  static constexpr int kLd = D + kVe;          // row stride: 16 bytes of pad
  static constexpr int kElems = kBlockK * kLd; // one K or V tile
};

// rows [row0, row0 + 64) of a (s_len, D) slice into a padded tile; rows
// past s_len are zero
template <int D, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int s_len) {
  using TL = Tile<D, T>;
  for (int i = threadIdx.x; i < kBlockK * TL::kNv; i += kThreads) {
    const int r = i / TL::kNv, c = i % TL::kNv;   // kNv is a power of 2
    const bool ok = row0 + r < s_len;
    cp_async16(dst + r * TL::kLd + c * TL::kVe,
               src + (size_t)(ok ? row0 + r : 0) * D + c * TL::kVe, ok);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int s_len, int n_qtiles, int causal, float scale_log2) {
  using TL = Tile<D, T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kLd = TL::kLd;
  constexpr int kNb = kBlockK / 8;     // 8-key column blocks of S
  constexpr int kOb = D / 8;           // 8-wide column blocks of O
  // Q's k-steps: 16 columns (bf16, D = 8 padded) or 8 (TF32)
  constexpr int kQs = kBf16 ? (D >= 16 ? D / 16 : 1) : D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);      // [2][kBlockK][kLd]
  T* v_s = k_s + 2 * TL::kElems;                // [2][kBlockK][kLd]
  // the q tile waits in K's second stage until its fragments are loaded
  T* q_s = k_s + TL::kElems;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;        // fragment row, column pair
  // blocks of the last (longest causal) q tiles first
  const int n_bh = gridDim.x / n_qtiles;
  const int qt = n_qtiles - 1 - (int)blockIdx.x / n_bh;
  const size_t base = (size_t)(blockIdx.x % n_bh) * s_len * D;
  const int q0 = qt * kBlockQ;
  const int n_kv = (s_len + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(qt + 1, n_kv) : n_kv;

  load_tile<D>(q_s, q + base, q0, s_len);
  load_tile<D>(k_s, k + base, 0, s_len);
  load_tile<D>(v_s, v + base, 0, s_len);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Q's A fragments (raw f32 bits for TF32), kept in registers: matrices
  // (rows 0-7 | 8-15) x (the k-step's first | second half)
  unsigned qa[kQs][4];
  {
    const T* qr = q_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd;
#pragma unroll
    for (int ks = 0; ks < kQs; ++ks) {
      if constexpr (kBf16 && D == 8) {
        ldsm_x2(qa[ks], qr);
        qa[ks][2] = qa[ks][3] = 0u;
      } else if constexpr (kBf16) {
        ldsm_x4(qa[ks], qr + ks * 16 + (lane >> 4) * 8);
      } else {
        ldsm_x4(qa[ks], qr + ks * 8 + (lane >> 4) * 4);
      }
    }
  }
  __syncthreads();  // K's second stage may now be loaded

  float o[kOb][4];
#pragma unroll
  for (int j = 0; j < kOb; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + g;         // this thread's rows: +0, +8

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {  // the next tile loads while this one computes
      const int st = (kt + 1) & 1;
      load_tile<D>(k_s + st * TL::kElems, k + base, (kt + 1) * kBlockK, s_len);
      load_tile<D>(v_s + st * TL::kElems, v + base, (kt + 1) * kBlockK, s_len);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* kt_s = k_s + (kt & 1) * TL::kElems;
    const T* vt_s = v_s + (kt & 1) * TL::kElems;

    // S = Q K^T, 16 x 64 per warp
    float s[kNb][4];
#pragma unroll
    for (int j = 0; j < kNb; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    {
      const int mi = lane >> 3, r = lane & 7;
#pragma unroll
      for (int ks = 0; ks < kQs; ++ks) {
        if constexpr (kBf16) {
#pragma unroll
          for (int nb = 0; nb < kNb; nb += 2) {
            unsigned b[4];
            if constexpr (D == 8) {  // the step's upper 8 columns are zero
              ldsm_x2(b, kt_s + (nb * 8 + (mi & 1) * 8 + r) * kLd);
              mma_bf16(s[nb], qa[ks], b[0], 0u);
              mma_bf16(s[nb + 1], qa[ks], b[1], 0u);
            } else {
              // (keys nb*8 | +8) x (columns ks*16 | +8)
              ldsm_x4(b, kt_s + (nb * 8 + (mi >> 1) * 8 + r) * kLd + ks * 16 +
                             (mi & 1) * 8);
              mma_bf16(s[nb], qa[ks], b[0], b[1]);
              mma_bf16(s[nb + 1], qa[ks], b[2], b[3]);
            }
          }
        } else {
          unsigned a_hi[4], a_lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(__uint_as_float(qa[ks][e]), a_hi[e], a_lo[e]);
#pragma unroll
          for (int nb = 0; nb < kNb; nb += 2) {
            unsigned b[4], hi[4], lo[4];
            // (keys nb*8 | +8) x (columns ks*8 | +4)
            ldsm_x4(b, kt_s + (nb * 8 + (mi >> 1) * 8 + r) * kLd + ks * 8 +
                           (mi & 1) * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_tf32(__uint_as_float(b[e]), hi[e], lo[e]);
            mma_3xtf32(s[nb], a_hi, a_lo, hi[0], hi[1], lo[0], lo[1]);
            mma_3xtf32(s[nb + 1], a_hi, a_lo, hi[2], hi[3], lo[2], lo[3]);
          }
        }
      }
    }

    // mask (the diagonal tile, a ragged last tile), online softmax in log2
    // units; element e of a block is row row_a + (e >> 1) * 8, key
    // k0 + nb * 8 + 2t + (e & 1)
    const int k0 = kt * kBlockK;
    const bool masked = (causal && kt == qt) || k0 + kBlockK > s_len;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale_log2;
        if (masked) {
          const int key = k0 + nb * 8 + 2 * t + (e & 1);
          if (key >= s_len || (causal && key > row_a + (e >> 1) * 8))
            x = -INFINITY;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no visible key yet keeps weights and sums at zero
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nb][e] - m_use[e >> 1]);
        s[nb][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int j = 0; j < kOb; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V
    if constexpr (kBf16) {
      const int mi = lane >> 3, r = lane & 7;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        // A fragment of keys kk*16..+15: S blocks 2kk and 2kk+1
        unsigned p_hi[4], p_lo[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], p_hi[0], p_lo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], p_hi[1], p_lo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], p_hi[2], p_lo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], p_hi[3], p_lo[3]);
        if constexpr (D == 8) {
          unsigned b[2];   // (keys kk*16 | +8) x columns 0..7, transposed
          ldsm_x2_t(b, vt_s + (kk * 16 + (mi & 1) * 8 + r) * kLd);
          mma_bf16(o[0], p_lo, b[0], b[1]);
          mma_bf16(o[0], p_hi, b[0], b[1]);
        } else {
#pragma unroll
          for (int ob = 0; ob < kOb; ob += 2) {
            unsigned b[4];   // (keys kk*16 | +8) x (columns ob*8 | +8)
            ldsm_x4_t(b, vt_s + (kk * 16 + (mi & 1) * 8 + r) * kLd +
                             (ob + (mi >> 1)) * 8);
            mma_bf16(o[ob], p_lo, b[0], b[1]);
            mma_bf16(o[ob], p_hi, b[0], b[1]);
            mma_bf16(o[ob + 1], p_lo, b[2], b[3]);
            mma_bf16(o[ob + 1], p_hi, b[2], b[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        // k-step of keys j*8..+7, permuted: A column t is key 2t, column
        // t + 4 is key 2t + 1, which is where the S accumulator has them
        unsigned p_hi[4], p_lo[4];
        split_tf32(s[j][0], p_hi[0], p_lo[0]);
        split_tf32(s[j][2], p_hi[1], p_lo[1]);
        split_tf32(s[j][1], p_hi[2], p_lo[2]);
        split_tf32(s[j][3], p_hi[3], p_lo[3]);
        const float* v0 =
            reinterpret_cast<const float*>(vt_s) + (j * 8 + 2 * t) * kLd + g;
#pragma unroll
        for (int ob = 0; ob < kOb; ++ob) {
          unsigned b0_hi, b0_lo, b1_hi, b1_lo;
          split_tf32(v0[ob * 8], b0_hi, b0_lo);
          split_tf32(v0[kLd + ob * 8], b1_hi, b1_lo);
          mma_3xtf32(o[ob], p_hi, p_lo, b0_hi, b1_hi, b0_lo, b1_lo);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

  // the row sums are spread over the quad that holds the row
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= s_len) continue;
    T* dst = out + base + (size_t)row * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kOb; ++j)
      store2(dst + j * 8, o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int s_len, int causal, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)4 * Tile<D, T>::kElems * sizeof(T);
  auto kernel = flash_attention_kernel<D, T>;
  if (smem > 48 * 1024) {  // above 48 KB dynamic shared memory is opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_qtiles = (s_len + kBlockQ - 1) / kBlockQ;
  kernel<<<bh * n_qtiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s_len, n_qtiles, causal,
      scale * kLog2e);
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

// q, k, v, out: (bh, s_len, d_head) contiguous and 16-byte aligned, all f32
// or all bf16; d_head in {8, 16, 32, 64, 128}. Launches on `stream` and
// returns a CUDA error code (0 on success).
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
