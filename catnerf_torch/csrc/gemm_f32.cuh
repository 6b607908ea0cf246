// The tiled float32 GEMM block shared by the GEMM chains of the background
// (occupancy.cu, 128-wide layers) and the CodeNeRF backward
// (codenerf_bwd.cu, 32-wide layers), for Hopper (sm_90a).
//
//   C = epilogue(A B) in true f32 FFMA (no TF32: the tensor cores are out).
//   A block computes a kBM x BN tile of C: BN = 128 with 256 threads, each
//   an 8 x 8 register tile, or BN = 32 with 128 threads, each 8 x 4 (a
//   128 x 128 tile on a 32-wide output would idle three quarters of its
//   threads). K is staged 8 at a time through shared memory, double-
//   buffered with cp.async. Leading dimensions are parameters, so the
//   concatenated layer inputs ([r1 | emb1], [g1 | emb1], ...) need no
//   copies, and every edge (rows, columns, K) is masked. The 32-wide tile
//   is batched: blockIdx.z is a batch index (the CodeNeRF category), with a
//   batch stride per operand. The 128-wide tile takes one product: its
//   8 x 8 register tile leaves no room for the offsets (with them, ptxas
//   spilled 16 bytes in two instantiations).
//
// Three operand layouts: NN (X W, the forward layers), NT (D W^T, the input
// gradients; W is stored [in, out]) and TN (X^T D, the weight gradients over
// a chunk of rows). Six epilogues, listed at Epilogue.
//
// Every sum runs in a fixed order, so two runs are bitwise equal.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBM = 128;  // rows of a block tile
constexpr int kBK = 8;    // K staged at a time
constexpr int kPad = 4;   // shared rows of BN + 4 floats: float4-aligned, and
                          // the transposing stores of a warp hit 32 banks

// The block of a BN-wide tile: 16 thread rows of 8 output rows each
// (ty*4 + {0..3}, 64 + ty*4 + {0..3}), kTX thread columns of 4 columns in
// each of kGroups column groups (g*kGW + tx*4 + {0..3}).
template <int BN>
struct GemmShape {
  static_assert(BN == 32 || BN == 128, "tile width");
  static constexpr int kGroups = BN == 128 ? 2 : 1;
  static constexpr int kGW = BN / kGroups;
  static constexpr int kTX = kGW / 4;
  static constexpr int kThreads = 16 * kTX;
  static constexpr int kTN = 4 * kGroups;  // columns a thread
  static constexpr int kMinBlocks = 512 / kThreads;
  static constexpr bool kBatched = BN == 32;
};

enum Layout { kNN = 0, kNT = 1, kTN = 2 };
// kBiasRelu: max(. + bias[n], 0);
// kMask: for n < mask_cols, (. + u[m] v[n]) [mask[m, n] > 0] (u, v
//   optional), other columns as they are; mask_cols = 0 (no mask): a plain
//   store;
// kAccumulate: C + .;
// kBias: . + bias[n];
// kBiasReluAdd: C = max(. + bias[n], 0) and C2 = C + Z[m, n] (a layer
//   followed by an injection: C is the ReLU mask, C2 the next input);
// kGradMask: C = ., and for n < mask_cols C2 = . [mask[m, n] > 0] (an
//   injection's gradient, and the delta of the layer below it).
enum Epilogue {
  kBiasRelu = 0,
  kMask = 1,
  kAccumulate = 2,
  kBias = 3,
  kBiasReluAdd = 4,
  kGradMask = 5
};

// C[m, n] = epilogue(sum_k A(m, k) B(k, n)) for m < M, n < N, with
//   A(m, k) = A[m * lda + k] (NN, NT) or A[k * lda + m] (TN),
//   B(k, n) = B[k * ldb + n] (NN, TN) or B[n * ldb + k] (NT);
// batch z reads and writes every operand at its pointer + z * its stride.
struct Gemm {
  const float* A;
  int lda;
  const float* B;
  int ldb;
  float* C;
  int ldc;
  int M, N, K;
  const float* bias;
  const float* mask;
  int ldm;
  int mask_cols;
  const float* u;
  const float* v;
  const float* Z;
  int ldz;
  float* C2;
  int ldc2;
  size_t sA, sB, sC, sbias, smask, su, sv, sZ, sC2;  // batch strides
};

// The product alone; a caller sets the epilogue's fields it needs.
__host__ __device__ inline Gemm make_gemm(const float* A, int lda,
                                          const float* B, int ldb, float* C,
                                          int ldc, int M, int N, int K) {
  Gemm g = {};
  g.A = A;
  g.lda = lda;
  g.B = B;
  g.ldb = ldb;
  g.C = C;
  g.ldc = ldc;
  g.M = M;
  g.N = N;
  g.K = K;
  return g;
}

// The product of batch z.
__device__ __forceinline__ Gemm batch_of(Gemm g, int z) {
  const size_t b = z;
  g.A += b * g.sA;
  g.B += b * g.sB;
  g.C += b * g.sC;
  if (g.bias != nullptr) g.bias += b * g.sbias;
  if (g.mask != nullptr) g.mask += b * g.smask;
  if (g.u != nullptr) g.u += b * g.su;
  if (g.v != nullptr) g.v += b * g.sv;
  if (g.Z != nullptr) g.Z += b * g.sZ;
  if (g.C2 != nullptr) g.C2 += b * g.sC2;
  return g;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the slot with zero and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// One kBM x BN tile of C at (m0, n0), by the whole block of
// GemmShape<BN>::kThreads; thread (tx, ty) = (tid % kTX, tid / kTX).
template <int BN, int L, int E>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int m0, int n0) {
  using S = GemmShape<BN>;
  constexpr int T = S::kThreads;
  constexpr int TN = S::kTN;
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][BN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % S::kTX;
  const int ty = tid / S::kTX;

  // neighbouring threads on neighbouring addresses of each operand's
  // contiguous dimension
  auto load = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < kBM * kBK / T; ++i) {
      const int e = tid + i * T;
      const int mm = L == kTN ? e % kBM : e / kBK;
      const int ka = L == kTN ? e / kBM : e % kBK;
      const int gm = m0 + mm;
      const int gka = k0 + ka;
      const bool oka = gm < g.M && gka < g.K;
      const size_t ia = L == kTN
                            ? static_cast<size_t>(gka) * g.lda + gm
                            : static_cast<size_t>(gm) * g.lda + gka;
      cp_async4(&As[buf][ka][mm], oka ? g.A + ia : g.A, oka);
    }
#pragma unroll
    for (int i = 0; i < BN * kBK / T; ++i) {
      const int e = tid + i * T;
      const int nn = L == kNT ? e / kBK : e % BN;
      const int kb = L == kNT ? e % kBK : e / BN;
      const int gn = n0 + nn;
      const int gkb = k0 + kb;
      const bool okb = gn < g.N && gkb < g.K;
      const size_t ib = L == kNT
                            ? static_cast<size_t>(gn) * g.ldb + gkb
                            : static_cast<size_t>(gkb) * g.ldb + gn;
      cp_async4(&Bs[buf][kb][nn], okb ? g.B + ib : g.B, okb);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (g.K + kBK - 1) / kBK;
  if (nk > 0) load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, (kt + 1) * kBK);
    cp_async_commit();
    cp_async_wait_prev();  // tile kt has landed
    __syncthreads();
    const int b = kt & 1;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[b][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[b][k][64 + ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bb[TN];
#pragma unroll
      for (int q = 0; q < S::kGroups; ++q) {
        const float4 b4 = *reinterpret_cast<const float4*>(
            &Bs[b][k][q * S::kGW + tx * 4]);
        bb[4 * q] = b4.x;
        bb[4 * q + 1] = b4.y;
        bb[4 * q + 2] = b4.z;
        bb[4 * q + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();  // the next load overwrites this buffer
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= g.M) continue;
    float* crow = g.C + static_cast<size_t>(m) * g.ldc;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * S::kGW + tx * 4 + j % 4;
      if (n >= g.N) continue;
      float v = acc[i][j];
      if constexpr (E == kBiasRelu) {
        v = fmaxf(v + g.bias[n], 0.f);
      } else if constexpr (E == kBias) {
        v = v + g.bias[n];
      } else if constexpr (E == kBiasReluAdd) {
        v = fmaxf(v + g.bias[n], 0.f);
        g.C2[static_cast<size_t>(m) * g.ldc2 + n] =
            v + g.Z[static_cast<size_t>(m) * g.ldz + n];
      } else if constexpr (E == kMask) {
        if (n < g.mask_cols) {
          if (g.u != nullptr) v = v + g.u[m] * g.v[n];
          v = g.mask[static_cast<size_t>(m) * g.ldm + n] > 0.f ? v : 0.f;
        }
      } else if constexpr (E == kGradMask) {
        if (n < g.mask_cols)
          g.C2[static_cast<size_t>(m) * g.ldc2 + n] =
              g.mask[static_cast<size_t>(m) * g.ldm + n] > 0.f ? v : 0.f;
      } else {
        v = crow[n] + v;
      }
      crow[n] = v;
    }
  }
}

template <int BN, int L, int E>
__global__ void __launch_bounds__(GemmShape<BN>::kThreads,
                                  GemmShape<BN>::kMinBlocks)
    gemm_kernel(Gemm g) {
  if constexpr (GemmShape<BN>::kBatched)
    gemm_tile<BN, L, E>(batch_of(g, blockIdx.z), blockIdx.x * kBM,
                        blockIdx.y * BN);
  else
    gemm_tile<BN, L, E>(g, blockIdx.x * kBM, blockIdx.y * BN);
}

// One launch over `batches` products (one for an unbatched tile); returns
// cudaGetLastError().
template <int BN, int L, int E>
int launch_gemm(const Gemm& g, cudaStream_t s, int batches = 1) {
  if (!GemmShape<BN>::kBatched && batches != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g.M <= 0 || g.N <= 0 || batches <= 0) return 0;
  const dim3 grid((g.M + kBM - 1) / kBM, (g.N + BN - 1) / BN, batches);
  gemm_kernel<BN, L, E><<<grid, GemmShape<BN>::kThreads, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// The rows [r0, r1) of chunk s: every chunk holds `rows` rows, the last
// ones fewer or none (the weight gradients' per-chunk partials).
__device__ __forceinline__ void chunk_rows(int N, int rows, int s, int& r0,
                                           int& r1) {
  r0 = min(N, s * rows);
  r1 = min(N, r0 + rows);
}

}  // namespace
