// Building blocks shared by the field kernels (codenerf_fwd.cu,
// codenerf_packed.cu, codenerf_bwd.cu, occupancy.cu): the flat parameter
// layouts, the per-thread positional encoding and its backward, the packed
// kernels' folded basis and the fixed-order reduction of the per-block
// partials. The chain kernels' shared-memory tile body is cn_tile.cuh.
// Float32 throughout, no fast math; the GEMM block of the chains is
// gemm_f32.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr int kDirs = 21;
constexpr int kE1 = 87;  // [t (3), sin f0..f3 (4 x 21)]
constexpr int kE2 = 42;  // [sin f4, f5]
constexpr int kBSize = kDirs * 3;

// Flat parameter layout: every weight [in, out] row-major in kernel order,
// then every bias (kernels/fused_field.py CN_LAYERS / OC_LAYERS).
namespace cn {
constexpr int W = 32;
constexpr int e_w = 0;
constexpr int s0_w = e_w + kE1 * W;
constexpr int c_w = s0_w + W * W;
constexpr int s1_w = c_w + (W + kE1) * W;
constexpr int en_w = s1_w + W * W;
constexpr int sg_w = en_w + W * W;
constexpr int vd_w = sg_w + W;
constexpr int t0_w = vd_w + (W + kE2) * W;
constexpr int r0_w = t0_w + W * W;
constexpr int r1_w = r0_w + W * (W / 2);
constexpr int e_b = r1_w + (W / 2) * 3;
constexpr int s0_b = e_b + W;
constexpr int c_b = s0_b + W;
constexpr int s1_b = c_b + W;
constexpr int en_b = s1_b + W;
constexpr int sg_b = en_b + W;
constexpr int vd_b = sg_b + 1;
constexpr int t0_b = vd_b + W;
constexpr int r0_b = t0_b + W;
constexpr int r1_b = r0_b + W / 2;
constexpr int P = r1_b + 3;  // 13,892
constexpr int PP = P + kBSize;  // partial row: params then dB
}  // namespace cn

// The OccupancyMap's at hidden width H (occupancy.cu instantiates 32, 64,
// 128 and 256).
template <int H>
struct OcLayout {
  static constexpr int in_w = 0;
  static constexpr int m1_w = in_w + kE1 * H;
  static constexpr int c_w = m1_w + H * H;
  static constexpr int m2_w = c_w + (H + kE1) * H;
  static constexpr int oa_w = m2_w + H * H;
  static constexpr int cl_w = oa_w + H;
  static constexpr int oc_w = cl_w + (H + kE2) * H;
  static constexpr int in_b = oc_w + H * 3;
  static constexpr int m1_b = in_b + H;
  static constexpr int c_b = m1_b + H;
  static constexpr int m2_b = c_b + H;
  static constexpr int oa_b = m2_b + H;
  static constexpr int cl_b = oa_b + 1;
  static constexpr int oc_b = cl_b + H;
  static constexpr int P = oc_b + 3;  // 94,340 at H = 128
  static constexpr int PP = P + kBSize;
};

static_assert(cn::P == 13892 && OcLayout<128>::P == 94340, "layout");

// ---------------------------------------------------------------------------
// Per-thread building blocks
// ---------------------------------------------------------------------------

// t = p * inv_scale; proj = t @ B^T; emb1 = [t, sin(pi 2^f proj), f<4];
// emb2 = [sin(pi 2^f proj), f=4,5].
__device__ __forceinline__ void embed(const float p[3], const float* B,
                                      float inv_scale, float t[3],
                                      float proj[kDirs], float* emb1,
                                      float* emb2) {
#pragma unroll
  for (int j = 0; j < 3; ++j) t[j] = p[j] * inv_scale;
#pragma unroll
  for (int k = 0; k < kDirs; ++k) {
    proj[k] = __fadd_rn(__fadd_rn(__fmul_rn(t[0], B[3 * k]),
                                  __fmul_rn(t[1], B[3 * k + 1])),
                        __fmul_rn(t[2], B[3 * k + 2]));
  }
  emb1[0] = t[0];
  emb1[1] = t[1];
  emb1[2] = t[2];
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const float w = kPi * static_cast<float>(1 << f);
    float* dst = f < 4 ? emb1 + 3 + kDirs * f : emb2 + kDirs * (f - 4);
    for (int k = 0; k < kDirs; ++k) dst[k] = sinf(w * proj[k]);
  }
}

// dproj = sum_f ds_f * (w_f cos(w_f proj)); dt = demb1[:3] + dproj @ B.
__device__ __forceinline__ void embed_bwd(const float* demb1,
                                          const float* demb2,
                                          const float proj[kDirs],
                                          const float* B, float dproj[kDirs],
                                          float dt[3]) {
  for (int k = 0; k < kDirs; ++k) dproj[k] = 0.f;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const float w = kPi * static_cast<float>(1 << f);
    const float* ds = f < 4 ? demb1 + 3 + kDirs * f : demb2 + kDirs * (f - 4);
    for (int k = 0; k < kDirs; ++k)
      dproj[k] = dproj[k] + ds[k] * (w * cosf(w * proj[k]));
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float acc = 0.f;
    for (int k = 0; k < kDirs; ++k) acc = fmaf(dproj[k], B[3 * k + j], acc);
    dt[j] = demb1[j] + acc;
  }
}

// The packed kernels' folded basis (codenerf_fwd.cu cn2_fwd,
// codenerf_packed.cu cn2_bwd): B2[j][f*21+d] = B[d][j] * f32(pi 2^f), the
// category's PE as one K = 3 product, S = sin(t @ B2) (_cn2_chain :739).
constexpr int kS = 6 * kDirs;  // 126 folded PE slots
constexpr int kB2 = 3 * kS;    // 378

// B2 of one category from its B [21, 3], with the whole block.
__device__ __forceinline__ void fold_b2(const float* __restrict__ B,
                                        float* B2) {
  for (int e = threadIdx.x; e < kB2; e += blockDim.x) {
    const int j = e / kS;
    const int s = e - j * kS;
    const int f = s / kDirs;
    const int d = s - f * kDirs;
    B2[e] = B[3 * d + j] * (kPi * static_cast<float>(1 << f));
  }
}

// sinarg[s] = (t @ B2)[s], an FMA chain over k = 0, 1, 2 (as a K=3 matmul).
__device__ __forceinline__ float sinarg(const float t[3], const float* B2,
                                        int s) {
  return fmaf(t[2], B2[2 * kS + s], fmaf(t[1], B2[kS + s], t[0] * B2[s]));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         bool valid, float* dst) {
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = valid ? src[k] : 0.f;
}

// out[c][p] = sum over tiles k (in order) of partial[c][k][p].
__global__ void reduce_tiles(const float* __restrict__ partial,
                             float* __restrict__ out, int nt, int pp) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pp) return;
  const size_t c = blockIdx.y;
  const float* src = partial + c * nt * static_cast<size_t>(pp) + p;
  float acc = 0.f;
  for (int k = 0; k < nt; ++k) acc += src[static_cast<size_t>(k) * pp];
  out[c * pp + p] = acc;
}

inline int launch_reduce(const float* partial, float* out, int C, int nt,
                         int pp, cudaStream_t s) {
  dim3 grid((pp + 255) / 256, C);
  reduce_tiles<<<grid, 256, 0, s>>>(partial, out, nt, pp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
