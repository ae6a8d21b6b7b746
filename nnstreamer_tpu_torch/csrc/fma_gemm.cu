// Sequential-FMA float32 GEMM for Hopper (sm_90a).
//
//     out[m, n] = fmaf(a[m, K-1], b[K-1, n], ... fmaf(a[m, 0], b[0, n], 0.f))
//
// One float32 fused multiply-add per step of K, in K's order: the summation
// order of XLA:CPU's precision=HIGHEST float32 conv (and dot) at the shapes
// listed with one chain in models/tflite_import.py::FMA_ORDERS, so the
// port's fake-quant executor snaps each of those ops' outputs to the
// reference's step. With chains = 2 or 4 each output keeps that many such
// chains, chain c over k = c, c + chains, ..., summed pairwise: c0 + c1, or
// (c0 + c1) + (c2 + c3). With kblock > 0 (a multiple of 32; one chain) the
// chain starts again from 0 at every kblock steps of K and the blocks' sums
// are added in order: (b0 + b1) + b2 ... What fixes the last bits is each
// output's chain over K: tiling M and N, pipelining the loads and choosing
// which thread runs a chain change none of them. A split chain, a reduction
// tree over K, tensor cores or TF32 would give other bits, so none is used;
// every step is __fmaf_rn and every sum __fadd_rn, so that nvcc neither
// contracts nor splits anything on its own.
//
// Not a TPU kernel's port: the reference's conv is XLA's, not Pallas.
//
// What bounds it on an H100 SXM: 2*M*N*K float32 operations on the CUDA
// cores (67 TFLOP/s with FMA) against (M*K + K*N + M*N)*4 bytes (3.35
// TB/s). Two classes of shapes meet in a fake-quant forward:
// - streaming (M >= 50176, K <= 192, N <= 192): the bytes bound them, the
//   output's most (N > K); they must read A once and write out once at the
//   memory's rate;
// - long K (M = 3136 or 12544 at 7x7 and 14x14, K up to 960, N up to
//   1280): the operations bound them, and there are few rows, so the card
//   is full only if the tiles are small enough to give every SM work.
//
// Design. A persistent block walks its share of BM x BN output tiles and,
// in each, K in steps of kBK = 32; the (tile, K step) pairs of a block form
// one sequence, advanced by counters (no 64-bit division in the loop), and
// a ring of ST slabs of A (BM x 32, row-major, the row pitch padded by 4
// floats) and of B (32 x BN) in shared memory runs ST - 1 steps ahead of
// the FMAs, filled by cp.async: 16-byte copies where A's rows lie a
// multiple of 4 floats apart (the importer lays op 0's K = 27 and the
// MEAN's K = 49 on a padded pitch) and N is a multiple of 4, 4-byte copies
// elsewhere. A copy never reaches past K, and a step past K is never
// computed: fmaf(0, 0, -0.f) is +0.f. So the next tile's loads are in
// flight while the current one's FMAs and stores run, on the streaming
// shapes too, whose K fits one step; where B is one slab for the whole run
// (K <= 32 and N <= BN) each ring slot loads it once. A thread runs TM x TN
// outputs: per four steps of K it reads its TM rows of A as float4s along
// K (a warp's rows adjacent, so conflict-free) and per step TN/4 float4s of
// B (a warp's reads one 128-byte line), and stores float4s of out. Of an
// order's independent parts, the 2 or 4 chains are held by each thread
// (TM x TN x chains accumulators) or split between as many groups of
// threads (the long-K 7x7 and FC shapes, which have few tiles: more warps
// on each), whose sums group 0 adds pairwise through shared memory; K
// blocks run in one thread, their sums kept apart. A single chain is never
// split. The tile comes from a table of 25 (kConfigs): BN from the widths
// that divide N (16, 24, 32, 48, 64, 96, 128), so no shape computes padded
// columns in bulk; for the shapes of a batch-64 fake-quant forward the
// tile measured fastest on the card (kTuned), for any other the one a
// model fitted to those measurements picks (model_cost). The grid is the
// tiles or the resident blocks, the fewer.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 32;      // steps of K a slab holds
constexpr int kStages = 3;   // slabs in the ring
constexpr int kPad = 4;      // floats after each row of an A slab

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const float* a;
  const float* b;
  float* out;
  int m_rows, k_len, n_cols, kblock;
  long long lda, ldb;     // A's and B's row strides, floats
  int n_tiles, k_steps;   // tiles along N, K steps a tile
  int tiles;              // all tiles
  bool a_vec, b_vec, out_vec, b_const;
};

// where a block is in its sequence of (tile, K step) pairs, advanced one
// step at a time: no division but one by n_tiles when the tile changes
struct Cursor {
  int tile, ks, m0, n0;
  __device__ void at(const Args& p, int t, int bm, int bn) {
    tile = t, ks = 0;
    m0 = t / p.n_tiles * bm;
    n0 = (t - t / p.n_tiles * p.n_tiles) * bn;
  }
  __device__ void next(const Args& p, int bm, int bn) {
    if (++ks == p.k_steps) at(p, tile + gridDim.x, bm, bn);
  }
};

// BM x BN output tiles, TM x TN outputs a thread; CH chains, held by each
// thread (SPLIT false) or one by each of CH groups of threads (SPLIT true,
// the groups' sums added pairwise through shared memory at the end); KB:
// K blocks (kblock, one chain); ST slabs in the ring
template <int BM, int BN, int TM, int TN, int CH, bool SPLIT, bool KB, int ST>
struct Tile {
  static constexpr int kChains = SPLIT ? 1 : CH;   // chains a thread holds
  static constexpr int kGroupThreads = (BM / TM) * (BN / TN);
  static constexpr int kThreads = (SPLIT ? CH : 1) * kGroupThreads;
  static constexpr int kAPitch = kBK + kPad;
  static constexpr int kASlab = BM * kAPitch;   // floats
  static constexpr int kBSlab = kBK * BN;
  static constexpr int kRed = SPLIT ? (CH - 1) * BM * BN : 0;
  static constexpr int kSmemBytes = (ST * (kASlab + kBSlab) + kRed) * 4;
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 fragments");
  static_assert(BM % TM == 0 && BN % TN == 0, "whole thread tiles");
  static_assert(CH == 1 || CH == 2 || CH == 4, "one, two or four chains");
  static_assert(!SPLIT || (CH > 1 && kGroupThreads % 32 == 0),
                "a group is whole warps");
  static_assert(!KB || CH == 1, "K blocks take one chain");
  static_assert(kThreads % kBK == 0, "a row's K step is one warp's copy");
};

// one (tile, K step) of the sequence into a ring slot
template <int BM, int BN>
__device__ __forceinline__ void load_step(const Args& p, float* as, float* bs,
                                          const Cursor& c, bool load_b) {
  constexpr int kAPitch = kBK + kPad;
  const int k0 = c.ks * kBK;
  const int kt = min(kBK, p.k_len - k0);
  const int rows = min(BM, p.m_rows - c.m0);
  const float* a0 = p.a + c.m0 * p.lda + k0;
  if (p.a_vec) {   // 16-byte chunks: (row, 4 steps of K)
    constexpr int kChunks = BM * (kBK / 4);
    for (int e = threadIdx.x; e < kChunks; e += blockDim.x) {
      const int r = e / (kBK / 4), k = (e % (kBK / 4)) * 4;
      if (r < rows && k < kt) cp_async16(as + r * kAPitch + k, a0 + r * p.lda + k);
    }
  } else {   // 4-byte copies; a warp reads one run of a row's K
    for (int r = threadIdx.x / kBK; r < rows; r += blockDim.x / kBK) {
      const int k = threadIdx.x % kBK;
      if (k < kt) cp_async4(as + r * kAPitch + k, a0 + r * p.lda + k);
    }
  }
  if (!load_b) return;
  const float* b0 = p.b + k0 * p.ldb + c.n0;
  const int cols = min(BN, p.n_cols - c.n0);
  if (p.b_vec) {
    constexpr int kRow = BN / 4;
    for (int e = threadIdx.x; e < kBK * kRow; e += blockDim.x) {
      const int r = e / kRow, n = (e % kRow) * 4;
      if (r < kt && n < cols) cp_async16(bs + r * BN + n, b0 + r * p.ldb + n);
    }
  } else {
    for (int e = threadIdx.x; e < kBK * BN; e += blockDim.x) {
      const int r = e / BN, n = e % BN;
      if (r < kt && n < cols) cp_async4(bs + r * BN + n, b0 + r * p.ldb + n);
    }
  }
}

// a thread's B fragment at step k: its TN columns as TN/4 float4s
template <int BN, int TN>
__device__ __forceinline__ void load_b_frag(const float* bcol, int k,
                                            float (&bj)[TN]) {
  constexpr int kRuns = TN / 4, kRunGap = BN / kRuns;
#pragma unroll
  for (int g = 0; g < kRuns; ++g) {
    const float4 v =
        *reinterpret_cast<const float4*>(bcol + k * BN + g * kRunGap);
    bj[4 * g] = v.x, bj[4 * g + 1] = v.y, bj[4 * g + 2] = v.z,
    bj[4 * g + 3] = v.w;
  }
}

// the FMAs of one slab (its first kt steps; FULL: all kBK, unrolled).
// Step k feeds chain k % CH (k0 is a multiple of kBK): in a thread's
// chain j % CH of each run of 4 steps, or, split, the group's chain g.
template <int BM, int BN, int TM, int TN, int CH, bool SPLIT, bool FULL>
__device__ __forceinline__ void run_slab(const float* __restrict__ arow,
                                         const float* __restrict__ bcol,
                                         float (&acc)[SPLIT ? 1 : CH][TM][TN],
                                         int g, int kt) {
  constexpr int kPitch = kBK + kPad, kRowGap = (BM / TM) * kPitch;
  if constexpr (SPLIT) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += CH) {
      const int k = kk + g;
      if (!FULL && k >= kt) break;
      float ai[TM], bj[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ai[i] = arow[i * kRowGap + k];
      load_b_frag<BN, TN>(bcol, k, bj);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n)
          acc[0][i][n] = __fmaf_rn(ai[i], bj[n], acc[0][i][n]);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      if (!FULL && kk >= kt) break;
      float ai[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(arow + i * kRowGap + kk);
        ai[i][0] = v.x, ai[i][1] = v.y, ai[i][2] = v.z, ai[i][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!FULL && kk + j >= kt) break;
        float bj[TN];
        load_b_frag<BN, TN>(bcol, kk + j, bj);
        const int c = j % CH;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int n = 0; n < TN; ++n)
            acc[c][i][n] = __fmaf_rn(ai[i][j], bj[n], acc[c][i][n]);
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, int CH, bool SPLIT, bool KB, int ST>
__global__ void __launch_bounds__(
    Tile<BM, BN, TM, TN, CH, SPLIT, KB, ST>::kThreads)
fma_gemm_kernel(const Args p) {
  using T = Tile<BM, BN, TM, TN, CH, SPLIT, KB, ST>;
  constexpr int kCols = BN / TN;       // threads along n
  constexpr int kRowThreads = BM / TM; // threads along m
  constexpr int kRuns = TN / 4;        // a thread's runs of 4 columns
  constexpr int kRunGap = BN / kRuns;
  constexpr int kCI = T::kChains;
  extern __shared__ __align__(16) float smem[];
  float* a_ring = smem;
  float* b_ring = smem + ST * T::kASlab;
  float* red = b_ring + ST * T::kBSlab;   // the split groups' sums
  const int lt = threadIdx.x % T::kGroupThreads;
  const int g = SPLIT ? threadIdx.x / T::kGroupThreads : 0;
  const int tx = lt % kCols, ty = lt / kCols;

  // this block's (tile, K step) sequence: tiles blockIdx.x + i * gridDim.x;
  // `load` runs ST - 1 steps ahead of `use`
  const int steps =
      (p.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x *
      p.k_steps;
  Cursor load, use;
  load.at(p, blockIdx.x, BM, BN);
  use = load;
  auto issue = [&](int s) {
    if (s < steps) {
      const int slot = s % ST;
      load_step<BM, BN>(p, a_ring + slot * T::kASlab,
                        b_ring + slot * T::kBSlab, load,
                        !p.b_const || s < ST);
      load.next(p, BM, BN);
    }
    cp_async_commit();   // a group every step, empty or not
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) issue(s);

  float acc[kCI][TM][TN];
  float tot[KB ? TM : 1][KB ? TN : 1];   // the finished K blocks' sum
#pragma unroll
  for (int c = 0; c < kCI; ++c)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[c][i][j] = 0.f;

  for (int s = 0, slot = 0; s < steps; ++s, slot = slot + 1 == ST ? 0 : slot + 1) {
    cp_async_wait<ST - 2>();
    __syncthreads();   // step s landed; every thread is done with s - 1
    issue(s + ST - 1);
    const float* arow = a_ring + slot * T::kASlab + ty * T::kAPitch;
    const float* bcol = b_ring + slot * T::kBSlab + tx * 4;
    const int ks = use.ks;
    const int k0 = ks * kBK;
    const int kt = min(kBK, p.k_len - k0);
    if constexpr (KB) {
      if (k0 > 0 && k0 % p.kblock == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            tot[i][j] = k0 == p.kblock ? acc[0][i][j]
                                       : __fadd_rn(tot[i][j], acc[0][i][j]);
            acc[0][i][j] = 0.f;
          }
      }
    }
    if (kt == kBK)
      run_slab<BM, BN, TM, TN, CH, SPLIT, true>(arow, bcol, acc, g, kt);
    else
      run_slab<BM, BN, TM, TN, CH, SPLIT, false>(arow, bcol, acc, g, kt);
    if (ks != p.k_steps - 1) {
      use.next(p, BM, BN);
      continue;
    }

    // the tile's last step: the chains' sum, pairwise, then out
    const int m0 = use.m0, n0 = use.n0;
    use.next(p, BM, BN);
    if constexpr (SPLIT) {   // groups 1.. hand their chains to group 0
      if (g > 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q)
            red[(g - 1) * BM * BN + (ty + i * kRowThreads) * BN +
                (q / 4) * kRunGap + tx * 4 + q % 4] = acc[0][i][q];
      }
      __syncthreads();
    }
    if (g == 0) {
      const bool blocks = KB && p.k_len > p.kblock;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + i * kRowThreads;
        const int m = m0 + r;
#pragma unroll
        for (int gg = 0; gg < kRuns; ++gg) {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int n = 4 * gg + q;
            float c[CH];
            if constexpr (SPLIT) {
              c[0] = acc[0][i][n];
#pragma unroll
              for (int h = 1; h < CH; ++h)
                c[h] = red[(h - 1) * BM * BN + r * BN + gg * kRunGap +
                           tx * 4 + q];
            } else {
#pragma unroll
              for (int h = 0; h < CH; ++h) c[h] = acc[h][i][n];
            }
            if constexpr (CH == 1) {
              if constexpr (KB)
                v[q] = blocks ? __fadd_rn(tot[i][n], c[0]) : c[0];
              else
                v[q] = c[0];
            } else if constexpr (CH == 2) {
              v[q] = __fadd_rn(c[0], c[1]);
            } else {
              v[q] = __fadd_rn(__fadd_rn(c[0], c[1]), __fadd_rn(c[2], c[3]));
            }
          }
          if (m >= p.m_rows) continue;
          const int n = n0 + gg * kRunGap + tx * 4;
          float* o = p.out + static_cast<long long>(m) * p.n_cols + n;
          if (p.out_vec && n + 4 <= p.n_cols) {
            *reinterpret_cast<float4*>(o) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (n + q < p.n_cols) o[q] = v[q];
          }
        }
      }
    }
    if constexpr (SPLIT) __syncthreads();   // red is free for the next tile
#pragma unroll
    for (int c = 0; c < kCI; ++c)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[c][i][j] = 0.f;
  }
  cp_async_wait<0>();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// a tile shape: its launch and its measure
struct Config {
  int bm, bn, tm, tn, ch;
  bool split, kb;
  int stages, threads;
  cudaError_t (*launch)(Args, int, cudaStream_t);
  int (*resident)(void);   // blocks an SM holds (0: refused)
};

template <int BM, int BN, int TM, int TN, int CH, bool SPLIT, bool KB, int ST>
int resident_blocks() {
  using T = Tile<BM, BN, TM, TN, CH, SPLIT, KB, ST>;
  static int n = -1;   // the card's answer, asked once
  if (n < 0) {
    auto* k = fma_gemm_kernel<BM, BN, TM, TN, CH, SPLIT, KB, ST>;
    int r = 0;
    if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmemBytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &r, k, T::kThreads, T::kSmemBytes) != cudaSuccess)
      r = 0;
    n = r;
  }
  return n;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <int BM, int BN, int TM, int TN, int CH, bool SPLIT, bool KB, int ST>
cudaError_t launch_tile(Args p, int grid, cudaStream_t stream) {
  using T = Tile<BM, BN, TM, TN, CH, SPLIT, KB, ST>;
  fma_gemm_kernel<BM, BN, TM, TN, CH, SPLIT, KB, ST>
      <<<grid, T::kThreads, T::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

#define NNS_TILE(BM, BN, TM, TN, CH, SPLIT, KB, ST)                         \
  Config {                                                                  \
    BM, BN, TM, TN, CH, SPLIT, KB, ST,                                      \
        Tile<BM, BN, TM, TN, CH, SPLIT, KB, ST>::kThreads,                  \
        launch_tile<BM, BN, TM, TN, CH, SPLIT, KB, ST>,                     \
        resident_blocks<BM, BN, TM, TN, CH, SPLIT, KB, ST>                  \
  }

// TM x TN x (chains a thread holds) accumulators a thread: at most 64.
// Each tile is the fastest at some shape of a batch-64 fake-quant forward
// (TUNED below) or covers an N width the others would pad.
const Config kConfigs[] = {
    // one chain
    NNS_TILE(128, 128, 8, 8, 1, false, false, 3),
    NNS_TILE(128, 96, 8, 8, 1, false, false, 3),
    NNS_TILE(128, 96, 4, 8, 1, false, false, 3),
    NNS_TILE(128, 64, 4, 8, 1, false, false, 3),
    NNS_TILE(64, 64, 4, 8, 1, false, false, 4),
    NNS_TILE(128, 32, 4, 4, 1, false, false, 3),
    NNS_TILE(64, 32, 4, 4, 1, false, false, 4),
    NNS_TILE(128, 24, 8, 4, 1, false, false, 3),
    NNS_TILE(128, 16, 8, 4, 1, false, false, 3),
    // one chain in K blocks
    NNS_TILE(128, 64, 4, 8, 1, false, true, 3),
    NNS_TILE(64, 32, 4, 4, 1, false, true, 4),
    // two chains: each thread both, or a group of threads each
    NNS_TILE(128, 96, 8, 4, 2, false, false, 3),
    NNS_TILE(128, 64, 8, 4, 2, false, false, 3),
    NNS_TILE(128, 48, 8, 4, 2, false, false, 3),
    NNS_TILE(128, 32, 8, 4, 2, false, false, 3),
    NNS_TILE(256, 24, 8, 4, 2, false, false, 3),
    NNS_TILE(128, 16, 8, 4, 2, false, false, 3),
    NNS_TILE(128, 32, 4, 8, 2, true, false, 3),
    // four chains: each thread all four, or a group of threads each
    NNS_TILE(128, 48, 4, 4, 4, false, false, 3),
    NNS_TILE(128, 32, 4, 4, 4, false, false, 3),
    NNS_TILE(128, 24, 4, 4, 4, false, false, 3),
    NNS_TILE(128, 16, 4, 4, 4, false, false, 3),
    NNS_TILE(64, 64, 4, 4, 4, false, false, 4),
    NNS_TILE(64, 16, 4, 4, 4, true, false, 6),
    NNS_TILE(32, 16, 4, 4, 4, true, false, 8),
};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

// A model of a config's time on this shape, in cycles: the busiest SM
// runs its tiles one after another, each the longer of its FMAs and its
// bytes, and every block pays a latency for each K step of its tiles.
// FMAs (padded rows and columns included) run at the SM's 128 lanes a
// cycle, slowed where it holds fewer than kWarps0 warps and by the shared
// memory reads a thread's tile needs per FMA; bytes (A and out, and B
// where it is not one slab for the whole run) at kBytesPerCycle. The
// constants were fitted to this kernel's times on an H100 SXM (700 W) at
// the fake-quant forward's shapes, every tile of the table at each. The
// smallest wins; ties go to the earlier config.
constexpr double kWarps0 = 4.909, kLoadCost = 7.940, kBytesPerCycle = 11.495,
                 kStepCycles = 924.1, kLaunchCycles = 14844.0;

// The tile measured fastest (ops/tune_fake_quant.py on an H100 SXM, 700
// W) at each shape of a batch-64 fake-quant forward of the int8
// MobileNet-v2 fixture, its operands in the importer's layout: M, K, N,
// chains, kblock, then the tile's BM, BN, TM, TN and whether its chains
// are split between groups of threads.
struct Tuned {
  int m, k, n, chains, kblock, bm, bn, tm, tn;
  bool split;
};
const Tuned kTuned[] = {
    {64, 1280, 1001, 4, 0, 32, 16, 4, 4, true},
    {3136, 160, 960, 1, 0, 128, 96, 4, 8, false},
    {3136, 320, 1280, 1, 0, 128, 128, 8, 8, false},
    {3136, 576, 160, 2, 0, 128, 32, 4, 8, true},
    {3136, 960, 160, 2, 0, 128, 32, 4, 8, true},
    {3136, 960, 320, 1, 512, 128, 64, 4, 8, false},
    {12544, 64, 384, 1, 0, 64, 64, 4, 8, false},
    {12544, 96, 576, 1, 0, 128, 128, 8, 8, false},
    {12544, 192, 64, 1, 0, 64, 32, 4, 4, false},
    {12544, 384, 64, 1, 0, 64, 32, 4, 4, false},
    {12544, 384, 96, 2, 0, 128, 96, 8, 4, false},
    {12544, 576, 96, 2, 0, 128, 96, 8, 4, false},
    {50176, 32, 192, 1, 0, 64, 64, 4, 8, false},
    {50176, 144, 32, 2, 0, 128, 32, 8, 4, false},
    {50176, 192, 32, 2, 0, 128, 32, 8, 4, false},
    {81920, 49, 1, 1, 0, 128, 16, 8, 4, false},
    {200704, 24, 144, 4, 0, 128, 48, 4, 4, false},
    {200704, 96, 24, 4, 0, 128, 24, 4, 4, false},
    {200704, 144, 24, 4, 0, 128, 24, 4, 4, false},
    {802816, 16, 96, 2, 0, 128, 96, 8, 4, false},
    {802816, 27, 32, 1, 0, 64, 32, 4, 4, false},
    {802816, 32, 16, 4, 0, 128, 16, 4, 4, false},
};

double model_cost(const Config& c, long long m, int k, int n, int sms) {
  const int res = c.resident();
  if (res <= 0) return 1e300;
  const long long n_tiles = (n + c.bn - 1) / c.bn;
  const long long tiles = ((m + c.bm - 1) / c.bm) * n_tiles;
  const long long per_sm = (tiles + sms - 1) / sms;
  const long long slots = static_cast<long long>(sms) * res;
  const long long per_block = (tiles + slots - 1) / slots;
  const double live =
      static_cast<double>(per_sm < res ? per_sm : res) * c.threads / 32.0;
  const int steps = k > 0 ? (k + 31) / 32 : 1;
  // FMAs per shared-memory read of a thread's tile
  const double per_load =
      c.split ? c.tm * c.tn / (c.tm + c.tn / 4.0)
              : c.tm * c.tn / ((c.tm + c.tn) / 4.0);
  const double use =
      (live < kWarps0 ? live / kWarps0 : 1.0) / (1.0 + kLoadCost / per_load);
  const double fma = static_cast<double>(c.bm) * c.bn * k / (128.0 * use);
  const bool b_once = steps == 1 && n_tiles == 1;
  const double bytes = (static_cast<double>(c.bm) * k +
                        (b_once ? 0.0 : static_cast<double>(k) * c.bn) +
                        static_cast<double>(c.bm) * c.bn) * 4.0 /
                       kBytesPerCycle;
  return static_cast<double>(per_sm) * (fma > bytes ? fma : bytes) +
         static_cast<double>(per_block) * steps * kStepCycles + kLaunchCycles;
}

}  // namespace

// Whether config c runs this order: its chains, and K blocks exactly where
// the order has more than one.
bool runs_order(const Config& c, int k_len, int chains, int kblock) {
  return c.ch == chains && c.kb == (kblock > 0 && k_len > kblock);
}

// The index of the config TUNED names for this shape and order, else the
// one the model picks (-1: none fits), or `force` if it is a valid index
// that runs the order.
extern "C" int nns_fma_gemm_config(int m_rows, int k_len, int n_cols,
                                   int chains, int kblock, int force) {
  if (force >= 0)
    return force < kNumConfigs &&
                   runs_order(kConfigs[force], k_len, chains, kblock)
               ? force
               : -1;
  for (const Tuned& t : kTuned) {
    if (t.m != m_rows || t.k != k_len || t.n != n_cols ||
        t.chains != chains || t.kblock != kblock)
      continue;
    for (int i = 0; i < kNumConfigs; ++i) {
      const Config& c = kConfigs[i];
      if (c.bm == t.bm && c.bn == t.bn && c.tm == t.tm && c.tn == t.tn &&
          c.split == t.split && runs_order(c, k_len, chains, kblock))
        return i;
    }
  }
  const int sms = sm_count();
  int best = -1;
  double best_cost = 0;
  for (int i = 0; i < kNumConfigs; ++i) {
    if (!runs_order(kConfigs[i], k_len, chains, kblock)) continue;
    const double c = model_cost(kConfigs[i], m_rows, k_len, n_cols, sms);
    if (best < 0 || c < best_cost) best = i, best_cost = c;
  }
  return best;
}

// The config's tile: writes bm, bn, tm, tn, chains, split, kblocks,
// stages, threads; returns the number of configs, or -1 for an index out
// of range.
extern "C" int nns_fma_gemm_describe(int index, int* shape) {
  if (index < 0 || index >= kNumConfigs) return -1;
  const Config& c = kConfigs[index];
  shape[0] = c.bm, shape[1] = c.bn, shape[2] = c.tm, shape[3] = c.tn;
  shape[4] = c.ch, shape[5] = c.split, shape[6] = c.kb;
  shape[7] = c.stages, shape[8] = c.threads;
  return kNumConfigs;
}

// a (m_rows, k_len) and b (k_len, n_cols) float32 with rows lda and ldb
// floats apart, out (m_rows, n_cols) dense row-major float32. A pitch that
// is a multiple of 4 lets 16-byte copies take rows of any K or N: a copy
// then reads up to the row's next multiple of 4, which the pitch holds,
// and those floats are never a step or an output. config: an index of
// nns_fma_gemm_config's table, or -1 for its pick.
extern "C" int nns_fma_gemm(const void* a, const void* b, void* out,
                            int m_rows, int k_len, int n_cols, long long lda,
                            long long ldb, int chains, int kblock,
                            int config, void* stream) {
  if (m_rows < 0 || k_len < 0 || n_cols <= 0 || lda < k_len ||
      ldb < n_cols ||
      (chains != 1 && chains != 2 && chains != 4) || kblock < 0 ||
      kblock % kBK != 0 || (kblock > 0 && chains != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m_rows == 0) return 0;
  const int ci =
      nns_fma_gemm_config(m_rows, k_len, n_cols, chains, kblock, config);
  if (ci < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Config& c = kConfigs[ci];
  const int res = c.resident();
  if (res <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Args p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.out = static_cast<float*>(out);
  p.m_rows = m_rows;
  p.k_len = k_len;
  p.n_cols = n_cols;
  p.kblock = kblock;
  p.lda = lda;
  p.ldb = ldb;
  p.n_tiles = (n_cols + c.bn - 1) / c.bn;
  p.k_steps = k_len > 0 ? (k_len + kBK - 1) / kBK : 1;
  const long long tiles =
      ((static_cast<long long>(m_rows) + c.bm - 1) / c.bm) * p.n_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  p.a_vec = lda % 4 == 0 && aligned16(a);
  p.b_vec = ldb % 4 == 0 && aligned16(b);
  p.out_vec = n_cols % 4 == 0 && aligned16(out);
  p.b_const = p.k_steps == 1 && p.n_tiles == 1;
  const long long slots = static_cast<long long>(sm_count()) * res;
  const int grid = static_cast<int>(p.tiles < slots ? p.tiles : slots);
  return static_cast<int>(c.launch(p, grid, static_cast<cudaStream_t>(stream)));
}
