// Fused positional encoding + field MLP, forward and backward, for Hopper
// (sm_90a), float32 throughout.
//
// Replaces the Pallas TPU kernels of catnerf_tpu/experimental/fused_field.py:
//   cn_fwd_kernel  <- _codenerf_fwd_kernel (:124)  CodeNeRF ensemble forward
//   cn_bwd_kernel  <- _codenerf_bwd_kernel (:135)  its backward
//   oc_fwd_kernel  <- _occ_fwd_kernel (:435)       OccupancyMap forward
//   mlp_fwd_kernel <- scripts/exp_kernel2.py mlp_kernel (:73)  the CodeNeRF
//                     chain alone, on an embedding computed outside
// (the OccupancyMap backward, _occ_bwd_kernel :445, is occupancy_bwd.cu).
// reduce_tiles (field_common.cuh) sums the backward's per-block
// weight-gradient partials; the building blocks are in field_common.cuh.
//
// What bounds them on an H100 is the operations: per sample point the
// CodeNeRF forward does 13,648 multiply-adds against 55.6 KB of weights
// shared by every point, the background 93,696 against 377 KB. So:
//   * one thread per sample point runs the whole layer chain; its
//     activations stay in registers and local memory, never device memory;
//   * every lane of a warp reads the same weight at the same time (a
//     broadcast), four at a time (float4): from shared memory for CodeNeRF
//     (13,892 floats, dynamic shared memory), through L1 for the
//     background, whose weights do not fit in shared memory;
//   * the backward recomputes the forward (as the TPU kernel does), stages
//     each layer's inputs and deltas for the block's rows in shared memory,
//     and sums x^T d over the rows into one partial per block; reduce_tiles
//     then adds the partials in a fixed order, so the result is bitwise
//     repeatable (no atomics).
// Ragged rows are masked: a row past N reads zeros and writes nothing.
// No fast math: sinf/cosf/expf are the accurate versions (the arguments
// reach 32*pi*|proj|), and the PE projection is rounded as written.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "field_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// CodeNeRF ensemble: grid (row tiles, C), one thread per row
// ---------------------------------------------------------------------------

template <int T>
__global__ void __launch_bounds__(T)
    cn_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ zs0,
                  const float* __restrict__ zc, const float* __restrict__ zs1,
                  const float* __restrict__ zt0,
                  const float* __restrict__ params,
                  const float* __restrict__ Bg, float* __restrict__ out, int N,
                  float inv_scale) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  float* sB = sW + cn::P;
  const int c = blockIdx.y;
  block_copy(sW, params + static_cast<size_t>(c) * cn::P, cn::P);
  for (int k = threadIdx.x; k < kBSize; k += T) sB[k] = Bg[c * kBSize + k];
  __syncthreads();
  const int row = blockIdx.x * T + threadIdx.x;
  if (row >= N) return;
  const size_t g = static_cast<size_t>(c) * N + row;
  constexpr int W = cn::W;

  float p[3], t[3], proj[kDirs], emb1[kE1], emb2[kE2];
  load_row<3>(pts + g * 3, true, p);
  embed(p, sB, inv_scale, t, proj, emb1, emb2);
  float sg, a7[3];
  cn_chain<false>(sW, emb1, emb2, zs0 + g * W, zc + g * W, zs1 + g * W,
                  zt0 + g * W, sg, a7);
  float4 o;
  o.x = sg * 10.f;
  o.y = sigmoidf(a7[0]);
  o.z = sigmoidf(a7[1]);
  o.w = sigmoidf(a7[2]);
  reinterpret_cast<float4*>(out)[g] = o;
}

// The chain alone over a precomputed embedding (kernel 7): emb1 [C,N,87],
// emb2 [C,N,42], z* [C,N,32] -> out [C,N,4]; the same grid and weights as
// cn_fwd_kernel.
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
  cn_chain<false>(sW, emb1, emb2, zs0 + g * W, zc + g * W, zs1 + g * W,
                  zt0 + g * W, sg, a7);
  float4 o;
  o.x = sg * 10.f;
  o.y = sigmoidf(a7[0]);
  o.z = sigmoidf(a7[1]);
  o.w = sigmoidf(a7[2]);
  reinterpret_cast<float4*>(out)[g] = o;
}

template <int T>
__global__ void __launch_bounds__(T)
    cn_bwd_kernel(const float* __restrict__ pts, const float* __restrict__ zs0,
                  const float* __restrict__ zc, const float* __restrict__ zs1,
                  const float* __restrict__ zt0,
                  const float* __restrict__ params,
                  const float* __restrict__ Bg,
                  const float* __restrict__ dout, float* __restrict__ dpts,
                  float* __restrict__ dzs0, float* __restrict__ dzc,
                  float* __restrict__ dzs1, float* __restrict__ dzt0,
                  float* __restrict__ partial, int N, float inv_scale) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  float* sB = sW + cn::P;
  float* stage = sB + 64;
  const int c = blockIdx.y;
  block_copy(sW, params + static_cast<size_t>(c) * cn::P, cn::P);
  for (int k = threadIdx.x; k < kBSize; k += T) sB[k] = Bg[c * kBSize + k];
  __syncthreads();
  const int row = blockIdx.x * T + threadIdx.x;
  const bool valid = row < N;
  const size_t g = static_cast<size_t>(c) * N + (valid ? row : 0);
  float* part = partial + (static_cast<size_t>(c) * gridDim.x + blockIdx.x) *
                              static_cast<size_t>(cn::PP);
  constexpr int W = cn::W;

  // recompute the forward, keeping what the backward reads
  float p[3], t[3], proj[kDirs], emb1[kE1], emb2[kE2];
  load_row<3>(pts + g * 3, valid, p);
  embed(p, sB, inv_scale, t, proj, emb1, emb2);
  float r0[W], g0[W], r1[W], g1[W], r2[W], g2[W], r3[W], h[W], r4[W], g4[W],
      r5[W], r6[W / 2], a7[3];
  float z[W];
  dense<kE1, 0, W, true>(sW + cn::e_w, sW + cn::e_b, emb1, nullptr, r0);
  load_row<W>(zs0 + g * W, valid, z);
  for (int k = 0; k < W; ++k) g0[k] = r0[k] + z[k];
  dense<W, 0, W, true>(sW + cn::s0_w, sW + cn::s0_b, g0, nullptr, r1);
  load_row<W>(zc + g * W, valid, z);
  for (int k = 0; k < W; ++k) g1[k] = r1[k] + z[k];
  dense<W, kE1, W, true>(sW + cn::c_w, sW + cn::c_b, g1, emb1, r2);
  load_row<W>(zs1 + g * W, valid, z);
  for (int k = 0; k < W; ++k) g2[k] = r2[k] + z[k];
  dense<W, 0, W, true>(sW + cn::s1_w, sW + cn::s1_b, g2, nullptr, r3);
  dense<W, 0, W, false>(sW + cn::en_w, sW + cn::en_b, r3, nullptr, h);
  dense<W, kE2, W, true>(sW + cn::vd_w, sW + cn::vd_b, h, emb2, r4);
  load_row<W>(zt0 + g * W, valid, z);
  for (int k = 0; k < W; ++k) g4[k] = r4[k] + z[k];
  dense<W, 0, W, true>(sW + cn::t0_w, sW + cn::t0_b, g4, nullptr, r5);
  dense<W, 0, W / 2, true>(sW + cn::r0_w, sW + cn::r0_b, r5, nullptr, r6);
  dense<W / 2, 0, 3, false>(sW + cn::r1_w, sW + cn::r1_b, r6, nullptr, a7);

  // backward; a row past N has dout = 0, so it adds nothing
  float dd[4];
  load_row<4>(dout + g * 4, valid, dd);
  float dsg = dd[0] * 10.f;
  float da7[3];
  for (int k = 0; k < 3; ++k) {
    const float col = sigmoidf(a7[k]);
    da7[k] = dd[1 + k] * col * (1.f - col);
  }
  float da[W], dx[W], demb1[kE1], demb2[kE2], tmp1[kE1];
  layer_grad<T, W / 2, 0, 3>(stage, r6, nullptr, da7, part + cn::r1_w,
                             part + cn::r1_b);
  dense_dx<W / 2, 3>(sW + cn::r1_w, da7, dx);
  for (int k = 0; k < W / 2; ++k) da[k] = r6[k] > 0.f ? dx[k] : 0.f;
  layer_grad<T, W, 0, W / 2>(stage, r5, nullptr, da, part + cn::r0_w,
                             part + cn::r0_b);
  dense_dx<W, W / 2>(sW + cn::r0_w, da, dx);
  for (int k = 0; k < W; ++k) da[k] = r5[k] > 0.f ? dx[k] : 0.f;
  layer_grad<T, W, 0, W>(stage, g4, nullptr, da, part + cn::t0_w,
                         part + cn::t0_b);
  dense_dx<W, W>(sW + cn::t0_w, da, dx);  // dg4
  if (valid)
    for (int k = 0; k < W; ++k) dzt0[g * W + k] = dx[k];
  for (int k = 0; k < W; ++k) da[k] = r4[k] > 0.f ? dx[k] : 0.f;  // da4
  layer_grad<T, W, kE2, W>(stage, h, emb2, da, part + cn::vd_w,
                           part + cn::vd_b);
  dense_dx<W, W>(sW + cn::vd_w, da, dx);  // dh
  dense_dx<kE2, W>(sW + cn::vd_w + W * W, da, demb2);
  layer_grad<T, W, 0, 1>(stage, h, nullptr, &dsg, part + cn::sg_w,
                         part + cn::sg_b);
  for (int k = 0; k < W; ++k) dx[k] = dx[k] + dsg * sW[cn::sg_w + k];
  layer_grad<T, W, 0, W>(stage, r3, nullptr, dx, part + cn::en_w,
                         part + cn::en_b);
  dense_dx<W, W>(sW + cn::en_w, dx, da);
  for (int k = 0; k < W; ++k) da[k] = r3[k] > 0.f ? da[k] : 0.f;  // da3
  layer_grad<T, W, 0, W>(stage, g2, nullptr, da, part + cn::s1_w,
                         part + cn::s1_b);
  dense_dx<W, W>(sW + cn::s1_w, da, dx);  // dg2
  if (valid)
    for (int k = 0; k < W; ++k) dzs1[g * W + k] = dx[k];
  for (int k = 0; k < W; ++k) da[k] = r2[k] > 0.f ? dx[k] : 0.f;  // da2
  layer_grad<T, W, kE1, W>(stage, g1, emb1, da, part + cn::c_w,
                           part + cn::c_b);
  dense_dx<W, W>(sW + cn::c_w, da, dx);  // dg1
  dense_dx<kE1, W>(sW + cn::c_w + W * W, da, demb1);
  if (valid)
    for (int k = 0; k < W; ++k) dzc[g * W + k] = dx[k];
  for (int k = 0; k < W; ++k) da[k] = r1[k] > 0.f ? dx[k] : 0.f;  // da1
  layer_grad<T, W, 0, W>(stage, g0, nullptr, da, part + cn::s0_w,
                         part + cn::s0_b);
  dense_dx<W, W>(sW + cn::s0_w, da, dx);  // dg0
  if (valid)
    for (int k = 0; k < W; ++k) dzs0[g * W + k] = dx[k];
  for (int k = 0; k < W; ++k) da[k] = r0[k] > 0.f ? dx[k] : 0.f;  // da0
  layer_grad<T, kE1, 0, W>(stage, emb1, nullptr, da, part + cn::e_w,
                           part + cn::e_b);
  dense_dx<kE1, W>(sW + cn::e_w, da, tmp1);
  for (int k = 0; k < kE1; ++k) demb1[k] = demb1[k] + tmp1[k];

  float dproj[kDirs], dt[3];
  embed_bwd(demb1, demb2, proj, sB, dproj, dt);
  layer_grad<T, kDirs, 0, 3>(stage, dproj, nullptr, t, part + cn::P,
                             nullptr);
  if (valid)
    for (int j = 0; j < 3; ++j) dpts[g * 3 + j] = dt[j] * inv_scale;
}

// ---------------------------------------------------------------------------
// OccupancyMap background (hidden 128): grid (row tiles), one thread per row;
// weights through L1 (377 KB do not fit in shared memory)
// ---------------------------------------------------------------------------

template <int T>
__global__ void __launch_bounds__(T)
    oc_fwd_kernel(const float* __restrict__ pts,
                  const float* __restrict__ prm, const float* __restrict__ B,
                  float* __restrict__ out, int N, float inv_scale) {
  const int row = blockIdx.x * T + threadIdx.x;
  if (row >= N) return;
  constexpr int H = oc::H;
  float p[3], t[3], proj[kDirs], emb1[kE1], emb2[kE2];
  load_row<3>(pts + static_cast<size_t>(row) * 3, true, p);
  embed(p, B, inv_scale, t, proj, emb1, emb2);
  float x[H], y[H];
  dense<kE1, 0, H, true>(prm + oc::in_w, prm + oc::in_b, emb1, nullptr, x);
  dense<H, 0, H, true>(prm + oc::m1_w, prm + oc::m1_b, x, nullptr, y);
  dense<H, kE1, H, true>(prm + oc::c_w, prm + oc::c_b, y, emb1, x);
  dense<H, 0, H, true>(prm + oc::m2_w, prm + oc::m2_b, x, nullptr, y);
  float alpha;
  dense<H, 0, 1, false>(prm + oc::oa_w, prm + oc::oa_b, y, nullptr, &alpha);
  dense<H, kE2, H, true>(prm + oc::cl_w, prm + oc::cl_b, y, emb2, x);
  float a5[3];
  dense<H, 0, 3, false>(prm + oc::oc_w, prm + oc::oc_b, x, nullptr, a5);
  float4 o;
  o.x = alpha * 10.f;
  o.y = sigmoidf(a5[0]);
  o.z = sigmoidf(a5[1]);
  o.w = sigmoidf(a5[2]);
  reinterpret_cast<float4*>(out)[row] = o;
}

constexpr int kStageCn = (((cn::W + kE1) | 1) + (cn::W | 1)) * cn::kBwdT;
constexpr size_t kSmemCnFwd = (cn::P + 64) * sizeof(float);
constexpr size_t kSmemCnBwd = (cn::P + 64 + kStageCn) * sizeof(float);
static_assert(kSmemCnBwd <= 232448, "smem");

}  // namespace

extern "C" {

// [CodeNeRF P, OccupancyMap P, cn fwd T, cn bwd T, oc fwd T]
int catnerf_layout(int* out) {
  out[0] = cn::P;
  out[1] = oc::P;
  out[2] = cn::kFwdT;
  out[3] = cn::kBwdT;
  out[4] = oc::kFwdT;
  return 0;
}

// pts [C,N,3], z* [C,N,32], params [C,P], B [C,21,3] -> out [C,N,4]
int cn_fwd(const float* pts, const float* zs0, const float* zc,
           const float* zs1, const float* zt0, const float* params,
           const float* B, float* out, int C, int N, float inv_scale,
           void* stream) {
  constexpr int T = cn::kFwdT;
  cudaError_t e = cudaFuncSetAttribute(
      cn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemCnFwd));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + T - 1) / T, C);
  cn_fwd_kernel<T><<<grid, T, kSmemCnFwd, static_cast<cudaStream_t>(stream)>>>(
      pts, zs0, zc, zs1, zt0, params, B, out, N, inv_scale);
  return static_cast<int>(cudaGetLastError());
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

// + dout [C,N,4] -> dpts, dz*, grads [C, P + 63] (via partial [C, nt, P + 63])
int cn_bwd(const float* pts, const float* zs0, const float* zc,
           const float* zs1, const float* zt0, const float* params,
           const float* B, const float* dout, float* dpts, float* dzs0,
           float* dzc, float* dzs1, float* dzt0, float* partial, float* grads,
           int C, int N, float inv_scale, void* stream) {
  constexpr int T = cn::kBwdT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      cn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemCnBwd));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = (N + T - 1) / T;
  cn_bwd_kernel<T><<<dim3(nt, C), T, kSmemCnBwd, s>>>(
      pts, zs0, zc, zs1, zt0, params, B, dout, dpts, dzs0, dzc, dzs1, dzt0,
      partial, N, inv_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(partial, grads, C, nt, cn::PP, s);
}

// pts [N,3], params [P], B [21,3] -> out [N,4]
int oc_fwd(const float* pts, const float* params, const float* B, float* out,
           int N, float inv_scale, void* stream) {
  constexpr int T = oc::kFwdT;
  oc_fwd_kernel<T><<<(N + T - 1) / T, T, 0,
                     static_cast<cudaStream_t>(stream)>>>(pts, params, B, out,
                                                          N, inv_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
