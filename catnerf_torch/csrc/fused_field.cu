// The CodeNeRF chain alone on a precomputed embedding, for Hopper
// (sm_90a), float32 throughout.
//
// Replaces the Pallas TPU kernel
//   mlp_fwd_kernel <- scripts/exp_kernel2.py mlp_kernel (:73), the CodeNeRF
//                     chain alone, on an embedding computed outside.
// (The CodeNeRF forward is codenerf_fwd.cu, its backward codenerf_bwd.cu,
// the OccupancyMap forward and backward occupancy.cu, the packed
// backward codenerf_packed.cu; the building blocks are in
// field_common.cuh.)
//
// What bounds it on an H100 is the operations: per sample point the
// chain does 13,648 multiply-adds against 55.6 KB of weights shared by
// every point of a category. So:
//   * one thread per sample point runs the whole layer chain; its
//     activations stay in registers and local memory, never device memory;
//   * every lane of a warp reads the same weight at the same time (a
//     broadcast), four at a time (float4), from shared memory (13,892
//     floats, dynamic shared memory).
// Ragged rows are masked: a row past N reads nothing and writes nothing.
// No fast math: expf is the accurate version.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "field_common.cuh"

namespace {

// The chain alone over a precomputed embedding (kernel 7): emb1 [C,N,87],
// emb2 [C,N,42], z* [C,N,32] -> out [C,N,4]; grid (row tiles, C), one
// thread a row, the category's weights in shared memory.
template <int T>
__global__ void __launch_bounds__(T)
    mlp_fwd_kernel(const float* __restrict__ e1, const float* __restrict__ e2,
                   const float* __restrict__ zs0, const float* __restrict__ zc,
                   const float* __restrict__ zs1,
                   const float* __restrict__ zt0,
                   const float* __restrict__ params, float* __restrict__ out,
                   int N) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  const int c = blockIdx.y;
  block_copy(sW, params + static_cast<size_t>(c) * cn::P, cn::P);
  __syncthreads();
  const int row = blockIdx.x * T + threadIdx.x;
  if (row >= N) return;
  const size_t g = static_cast<size_t>(c) * N + row;
  constexpr int W = cn::W;

  float emb1[kE1], emb2[kE2];
  load_row<kE1>(e1 + g * kE1, true, emb1);
  load_row<kE2>(e2 + g * kE2, true, emb2);
  float sg, a7[3];
  cn_chain(sW, emb1, emb2, zs0 + g * W, zc + g * W, zs1 + g * W, zt0 + g * W,
           sg, a7);
  float4 o;
  o.x = sg * 10.f;
  o.y = sigmoidf(a7[0]);
  o.z = sigmoidf(a7[1]);
  o.w = sigmoidf(a7[2]);
  reinterpret_cast<float4*>(out)[g] = o;
}

constexpr size_t kSmemCnFwd = cn::P * sizeof(float);

}  // namespace

extern "C" {

// [CodeNeRF P, rows a block]
int catnerf_layout(int* out) {
  out[0] = cn::P;
  out[1] = cn::kFwdT;
  return 0;
}

// emb1 [C,N,87], emb2 [C,N,42], z* [C,N,32], params [C,P] -> out [C,N,4]
int cn_mlp_fwd(const float* emb1, const float* emb2, const float* zs0,
               const float* zc, const float* zs1, const float* zt0,
               const float* params, float* out, int C, int N, void* stream) {
  constexpr int T = cn::kFwdT;
  cudaError_t e = cudaFuncSetAttribute(
      mlp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemCnFwd));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + T - 1) / T, C);
  mlp_fwd_kernel<T><<<grid, T, kSmemCnFwd, static_cast<cudaStream_t>(stream)>>>(
      emb1, emb2, zs0, zc, zs1, zt0, params, out, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
