// Sequential-FMA float32 GEMM for Hopper (sm_90a).
//
//     out[m, n] = fmaf(a[m, K-1], b[K-1, n], ... fmaf(a[m, 0], b[0, n], 0.f))
//
// One float32 fused multiply-add per step of K, in K's order: the summation
// order of XLA:CPU's precision=HIGHEST float32 conv at the shapes listed in
// models/tflite_import.py::FMA_ORDER_SHAPES, so the port's fake-quant
// executor snaps each of those convs' outputs to the reference's step.
// What fixes the last bits is each output's chain over K: tiling M and N
// changes only which thread runs a chain, not its order. A split K, a
// reduction tree over K or TF32 would give other bits, so none is used.
//
// Not a TPU kernel's port: the reference's conv is XLA's, not Pallas.
//
// Bound on an H100 SXM: 2*M*N*K float32 operations on the CUDA cores
// (67 TFLOP/s with FMA) against (M*K + K*N + M*N)*4 bytes. Op 0 of the
// fixture (K = 27, N = 32) is on the bytes side; the 1x1 convs with K and
// N in the hundreds are on the operations side.
//
// Design: a block owns a BM x BN tile of out and walks K in steps of 32.
// Each step stages a's BM x 32 slab (k-major, rows padded by 4 floats) and
// b's 32 x BN slab in shared memory, both read with coalesced loads; each
// thread then runs TM x TN chains in registers, one fmaf each per k, fed by
// float4 reads: its TM rows are adjacent, its TN columns are TN/4 runs of
// 4 spaced BN/(TN/4) apart, so a warp's b reads and its float4 stores of
// out cover whole 128-byte lines. N <= 32 (op 0) takes a 256 x 32 tile;
// wider N a 64 x 64 tile, small enough that the 1x1 convs at 14x14 and
// batch 64 (M = 12544, N = 64) still fill the card's 132 SMs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 32;

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
fma_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, long long m_rows, int k_len,
                int n_cols, bool vec_store) {
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 fragments");
  constexpr int kCols = BN / TN;  // threads along n
  constexpr int kRows = BM / TM;  // threads along m
  constexpr int kThreads = kCols * kRows;
  constexpr int kRuns = TN / 4;   // a thread's runs of 4 columns
  constexpr int kRunGap = BN / kRuns;
  __shared__ __align__(16) float as[kBK][BM + 4];
  __shared__ __align__(16) float bs[kBK][BN];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_len; k0 += kBK) {
    const int kt = min(kBK, k_len - k0);
    for (int e = threadIdx.x; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const long long m = m0 + r;
      as[c][r] = (m < m_rows && c < kt) ? __ldg(a + m * k_len + k0 + c) : 0.f;
    }
    for (int e = threadIdx.x; e < kBK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int n = n0 + c;
      bs[r][c] = (r < kt && n < n_cols)
                     ? __ldg(b + static_cast<long long>(k0 + r) * n_cols + n)
                     : 0.f;
    }
    __syncthreads();
    // only the kt real steps: a padded step would add fmaf(0, 0, acc)
    for (int kk = 0; kk < kt; ++kk) {
      float ai[TM], bj[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&as[kk][ty * TM + i]);
        ai[i] = v.x, ai[i + 1] = v.y, ai[i + 2] = v.z, ai[i + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < kRuns; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(&bs[kk][g * kRunGap + tx * 4]);
        bj[4 * g] = v.x, bj[4 * g + 1] = v.y, bj[4 * g + 2] = v.z,
        bj[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= m_rows) break;
#pragma unroll
    for (int g = 0; g < kRuns; ++g) {
      const int n = n0 + g * kRunGap + tx * 4;
      float* o = out + m * n_cols + n;
      const float* v = &acc[i][4 * g];
      if (vec_store && n + 4 <= n_cols) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < n_cols) o[j] = v[j];
      }
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch(const float* a, const float* b, float* out,
                   long long m_rows, int k_len, int n_cols,
                   cudaStream_t stream) {
  const long long mb = (m_rows + BM - 1) / BM;
  const int nb = (n_cols + BN - 1) / BN;
  if (mb > 0x7fffffffLL || nb > 65535) return cudaErrorInvalidValue;
  const bool vec = n_cols % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  fma_gemm_kernel<BM, BN, TM, TN>
      <<<dim3(static_cast<unsigned>(mb), nb), (BM / TM) * (BN / TN), 0,
         stream>>>(a, b, out, m_rows, k_len, n_cols, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nns_fma_gemm(const void* a, const void* b, void* out,
                            int m_rows, int k_len, int n_cols, void* stream) {
  if (m_rows < 0 || k_len < 0 || n_cols <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m_rows == 0) return 0;
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  auto* fo = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      n_cols <= 32
          ? launch<256, 32, 8, 4>(fa, fb, fo, m_rows, k_len, n_cols, st)
          : launch<64, 64, 4, 8>(fa, fb, fo, m_rows, k_len, n_cols, st);
  return static_cast<int>(err);
}
