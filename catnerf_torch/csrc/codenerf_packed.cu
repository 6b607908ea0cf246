// The packed-ensemble CodeNeRF ("categories in lanes") backward for Hopper
// (sm_90a), float32 throughout.
//
// Replaces the Pallas TPU kernel of catnerf_tpu/experimental/fused_field.py:
//   cn2_bwd_kernel <- _cn2_bwd_kernel (:786), called at :929
// reduce_tiles (field_common.cuh) then sums its partials. (The packed
// forward, _cn2_fwd_kernel :773, is cn2_fwd in codenerf_fwd.cu.)
//
// The contract is the TPU kernel's: point-major rows with the C categories
// side by side, pts [N, 3C], z* [N, 32C], dsigma [N, C], drgb [N, 3C]; the
// PE is one product with the folded basis B2[k, f*21+d] = B[d,k] *
// f32(pi 2^f) (slots f0..f3 | f4..f5, fold_b2), S = sin(t @ B2); the concat
// layers are split products over [y | t | S] (_cn2_chain :739). On the TPU
// every layer is one block-diagonal matmul over all categories in lanes.
// Here the categories' weights (55.6 KB each, 445 KB for eight) do not fit
// one block's 227 KB of shared memory, and the zeros of a block diagonal
// would be work for nothing; so the grid is (row tiles, C), one thread
// runs one point of one category through the recompute and the backward,
// that category's weights and B2 sit in shared memory, and the point-major
// rows are read at strides 3C and 32C. What bounds the work is the
// operations (3 x 13,648 + 2 x 378 multiply-adds per point and category).
//
// The block size is the caller's `tile` (rows per block, a multiple of 32,
// at most kMaxT). The backward stages each layer's inputs and deltas 32
// rows at a time, carries the block's sums in shared memory, and writes one
// partial per block; reduce_tiles adds the partials in a fixed order, so
// two runs are bitwise equal (no atomics), the counterpart of the revisited
// output blocks at :860-874. The weight gradients are per category only:
// the off-diagonal blocks of the TPU kernel's dense cotangents are dropped
// by its caller's autodiff anyway. dB2 is returned as it is, and the
// wrapper folds it back to dB. Ragged rows are masked, not padded.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "field_common.cuh"

namespace {

constexpr int kB2Pad = 384;        // keeps what follows 16-byte aligned
constexpr int kMaxT = 384;         // rows per block at most
constexpr int kRows = 32;          // rows staged at a time in the backward
constexpr int PP2 = cn::P + kB2;   // partial row: params then dB2
// staging: the widest layer's [x | d] rows (cat_layer: 119 + 32)
constexpr int kStage = (((cn::W + kE1) | 1) + (cn::W | 1)) * kRows;
constexpr int kAcc = (cn::W + kE1) * cn::W + cn::W;
constexpr size_t kSmemBwd = (cn::P + kB2Pad + kStage + kAcc) * sizeof(float);
static_assert(kSmemBwd <= 232448, "smem");

// emb1 = [t, S[0:84]], emb2 = S[84:126], S = sin(t @ B2).
__device__ __forceinline__ void packed_embed(const float t[3],
                                             const float* B2, float* emb1,
                                             float* emb2) {
  emb1[0] = t[0];
  emb1[1] = t[1];
  emb1[2] = t[2];
  for (int s = 0; s < kE1 - 3; ++s) emb1[3 + s] = sinf(sinarg(t, B2, s));
  for (int s = 0; s < kE2; ++s)
    emb2[s] = sinf(sinarg(t, B2, kE1 - 3 + s));
}

// + dsg [N, C], dcol [N, 3C] -> dpts [N, 3C], dz* [N, 32C], and one partial
// row [params | dB2] per block: partial [C, gridDim.x, PP2].
__global__ void __launch_bounds__(kMaxT)
    cn2_bwd_kernel(const float* __restrict__ pts,
                   const float* __restrict__ zs0, const float* __restrict__ zc,
                   const float* __restrict__ zs1,
                   const float* __restrict__ zt0,
                   const float* __restrict__ params,
                   const float* __restrict__ Bg,
                   const float* __restrict__ dsg_in,
                   const float* __restrict__ dcol_in,
                   float* __restrict__ dpts, float* __restrict__ dzs0,
                   float* __restrict__ dzc, float* __restrict__ dzs1,
                   float* __restrict__ dzt0, float* __restrict__ partial,
                   int N, int C, float inv_scale) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  float* sB2 = sW + cn::P;
  float* stage = sB2 + kB2Pad;
  float* acc = stage + kStage;
  const int c = blockIdx.y;
  block_copy(sW, params + static_cast<size_t>(c) * cn::P, cn::P);
  fold_b2(Bg + c * kBSize, sB2);
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = row < N;
  const size_t r = valid ? row : 0;
  float* part = partial + (static_cast<size_t>(c) * gridDim.x + blockIdx.x) *
                              static_cast<size_t>(PP2);
  constexpr int W = cn::W;
  const size_t zoff = r * W * C + static_cast<size_t>(W) * c;

  // recompute the forward (_cn2_chain), keeping what the backward reads
  float t[3], emb1[kE1], emb2[kE2];
  for (int j = 0; j < 3; ++j)
    t[j] = (valid ? pts[r * 3 * C + 3 * c + j] : 0.f) * inv_scale;
  packed_embed(t, sB2, emb1, emb2);
  float r0[W], g0[W], r1[W], g1[W], r2[W], g2[W], r3[W], h[W], r4[W], g4[W],
      r5[W], r6[W / 2], a7[3];
  float z[W];
  dense<3, kE1 - 3, W, true>(sW + cn::e_w, sW + cn::e_b, emb1, emb1 + 3, r0);
  load_row<W>(zs0 + zoff, valid, z);
  for (int k = 0; k < W; ++k) g0[k] = r0[k] + z[k];
  dense<W, 0, W, true>(sW + cn::s0_w, sW + cn::s0_b, g0, nullptr, r1);
  load_row<W>(zc + zoff, valid, z);
  for (int k = 0; k < W; ++k) g1[k] = r1[k] + z[k];
  dense3<W, 3, kE1 - 3, W, true>(sW + cn::c_w, sW + cn::c_b, g1, emb1,
                                 emb1 + 3, r2);
  load_row<W>(zs1 + zoff, valid, z);
  for (int k = 0; k < W; ++k) g2[k] = r2[k] + z[k];
  dense<W, 0, W, true>(sW + cn::s1_w, sW + cn::s1_b, g2, nullptr, r3);
  dense<W, 0, W, false>(sW + cn::en_w, sW + cn::en_b, r3, nullptr, h);
  dense<W, kE2, W, true>(sW + cn::vd_w, sW + cn::vd_b, h, emb2, r4);
  load_row<W>(zt0 + zoff, valid, z);
  for (int k = 0; k < W; ++k) g4[k] = r4[k] + z[k];
  dense<W, 0, W, true>(sW + cn::t0_w, sW + cn::t0_b, g4, nullptr, r5);
  dense<W, 0, W / 2, true>(sW + cn::r0_w, sW + cn::r0_b, r5, nullptr, r6);
  dense<W / 2, 0, 3, false>(sW + cn::r1_w, sW + cn::r1_b, r6, nullptr, a7);

  // backward (_cn2_bwd_kernel :800-858); a row past N has zero cotangents,
  // so it adds nothing to the sums
  const float dsg = (valid ? dsg_in[r * C + c] : 0.f) * 10.f;
  float da7[3];
  for (int k = 0; k < 3; ++k) {
    const float col = sigmoidf(a7[k]);
    const float dcol = valid ? dcol_in[r * 3 * C + 3 * c + k] : 0.f;
    da7[k] = dcol * col * (1.f - col);
  }
  float da[W], dx[W], dS[kS], dt_e[3], dt_c[3], tmp[kE1 - 3];
  layer_grad_rows<kRows, W / 2, 0, 3>(stage, acc, r6, nullptr, da7,
                                      part + cn::r1_w, part + cn::r1_b);
  dense_dx<W / 2, 3>(sW + cn::r1_w, da7, dx);
  for (int k = 0; k < W / 2; ++k) da[k] = r6[k] > 0.f ? dx[k] : 0.f;  // da6
  layer_grad_rows<kRows, W, 0, W / 2>(stage, acc, r5, nullptr, da,
                                      part + cn::r0_w, part + cn::r0_b);
  dense_dx<W, W / 2>(sW + cn::r0_w, da, dx);
  for (int k = 0; k < W; ++k) da[k] = r5[k] > 0.f ? dx[k] : 0.f;  // da5
  layer_grad_rows<kRows, W, 0, W>(stage, acc, g4, nullptr, da,
                                  part + cn::t0_w, part + cn::t0_b);
  dense_dx<W, W>(sW + cn::t0_w, da, dx);  // dg4
  if (valid)
    for (int k = 0; k < W; ++k) dzt0[zoff + k] = dx[k];
  for (int k = 0; k < W; ++k) da[k] = r4[k] > 0.f ? dx[k] : 0.f;  // da4
  // [Wvd_h | Wvd_s] grads: [h | S[84:126]]^T da4
  layer_grad_rows<kRows, W, kE2, W>(stage, acc, h, emb2, da,
                                    part + cn::vd_w, part + cn::vd_b);
  dense_dx<W, W>(sW + cn::vd_w, da, dx);               // da4 @ Wvd_h^T
  dense_dx<kE2, W>(sW + cn::vd_w + W * W, da, dS + kE1 - 3);  // dS high
  layer_grad_rows<kRows, W, 0, 1>(stage, acc, h, nullptr, &dsg,
                                  part + cn::sg_w, part + cn::sg_b);
  for (int k = 0; k < W; ++k) dx[k] = dx[k] + dsg * sW[cn::sg_w + k];  // dh
  layer_grad_rows<kRows, W, 0, W>(stage, acc, r3, nullptr, dx,
                                  part + cn::en_w, part + cn::en_b);
  dense_dx<W, W>(sW + cn::en_w, dx, da);
  for (int k = 0; k < W; ++k) da[k] = r3[k] > 0.f ? da[k] : 0.f;  // da3
  layer_grad_rows<kRows, W, 0, W>(stage, acc, g2, nullptr, da,
                                  part + cn::s1_w, part + cn::s1_b);
  dense_dx<W, W>(sW + cn::s1_w, da, dx);  // dg2
  if (valid)
    for (int k = 0; k < W; ++k) dzs1[zoff + k] = dx[k];
  for (int k = 0; k < W; ++k) da[k] = r2[k] > 0.f ? dx[k] : 0.f;  // da2
  // [Wc_y | Wc_t | Wc_s] grads: [g1 | t | S[0:84]]^T da2
  layer_grad_rows<kRows, W, kE1, W>(stage, acc, g1, emb1, da,
                                    part + cn::c_w, part + cn::c_b);
  dense_dx<W, W>(sW + cn::c_w, da, dx);                      // dg1
  dense_dx<3, W>(sW + cn::c_w + W * W, da, dt_c);            // da2 @ Wc_t^T
  dense_dx<kE1 - 3, W>(sW + cn::c_w + (W + 3) * W, da, tmp);  // da2 @ Wc_s^T
  if (valid)
    for (int k = 0; k < W; ++k) dzc[zoff + k] = dx[k];
  for (int k = 0; k < W; ++k) da[k] = r1[k] > 0.f ? dx[k] : 0.f;  // da1
  layer_grad_rows<kRows, W, 0, W>(stage, acc, g0, nullptr, da,
                                  part + cn::s0_w, part + cn::s0_b);
  dense_dx<W, W>(sW + cn::s0_w, da, dx);  // dg0
  if (valid)
    for (int k = 0; k < W; ++k) dzs0[zoff + k] = dx[k];
  for (int k = 0; k < W; ++k) da[k] = r0[k] > 0.f ? dx[k] : 0.f;  // da0
  // [We_t | We_s] grads: [t | S[0:84]]^T da0
  layer_grad_rows<kRows, kE1, 0, W>(stage, acc, emb1, nullptr, da,
                                    part + cn::e_w, part + cn::e_b);
  dense_dx<3, W>(sW + cn::e_w, da, dt_e);                    // da0 @ We_t^T
  dense_dx<kE1 - 3, W>(sW + cn::e_w + 3 * W, da, dS);         // da0 @ We_s^T
  for (int s = 0; s < kE1 - 3; ++s) dS[s] = dS[s] + tmp[s];   // dS low

  // dsinarg = dS * cos(sinarg); dB2 = t^T dsinarg; dt = dsinarg @ B2^T + ...
  float* dsa = dS;
  for (int s = 0; s < kS; ++s) dsa[s] = dS[s] * cosf(sinarg(t, sB2, s));
  layer_grad_rows<kRows, 3, 0, kS>(stage, acc, t, nullptr, dsa,
                                   part + cn::P, nullptr);
  if (valid) {
    for (int j = 0; j < 3; ++j) {
      float a = 0.f;
      for (int s = 0; s < kS; ++s) a = fmaf(dsa[s], sB2[j * kS + s], a);
      dpts[r * 3 * C + 3 * c + j] = ((a + dt_e[j]) + dt_c[j]) * inv_scale;
    }
  }
}

}  // namespace

extern "C" {

// [P, B2 size, max rows per block, rows staged at a time]
int packed_layout(int* out) {
  out[0] = cn::P;
  out[1] = kB2;
  out[2] = kMaxT;
  out[3] = kRows;
  return 0;
}

// + dsg [N,C], dcol [N,3C] -> dpts [N,3C], dz* [N,32C], grads [C, P + 378]
// (via partial [C, ceil(N / tile), P + 378])
int cn2_bwd(const float* pts, const float* zs0, const float* zc,
            const float* zs1, const float* zt0, const float* params,
            const float* B, const float* dsg, const float* dcol, float* dpts,
            float* dzs0, float* dzc, float* dzs1, float* dzt0, float* partial,
            float* grads, int C, int N, int tile, float inv_scale,
            void* stream) {
  if (tile <= 0 || tile > kMaxT || tile % kRows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      cn2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBwd));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = (N + tile - 1) / tile;
  cn2_bwd_kernel<<<dim3(nt, C), tile, kSmemBwd, s>>>(
      pts, zs0, zc, zs1, zt0, params, B, dsg, dcol, dpts, dzs0, dzc, dzs1,
      dzt0, partial, N, C, inv_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(partial, grads, C, nt, PP2, s);
}

}  // extern "C"
