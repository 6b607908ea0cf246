// The shared-memory tile body of the CodeNeRF chain kernels for Hopper
// (sm_90a), float32 throughout: the forward chain kernel of
// codenerf_fwd.cu (kernels 1 and 5) and the packed backward of
// codenerf_packed.cu (kernel 6), which recomputes kernel 5's forward with it.
//
// A block owns one category and kR = 64 rows with kT = 128 threads; every
// activation lies k-major in shared memory ([k][row], kR floats a k), the
// layer's weights row-major [K][OUT] beside it. tile_layer is one layer
// (register-tiled product, bias, epilogue); sigma_head and rgb_head the
// heads, a thread a row; block_embed the PE into shared memory, with
// sin_f32 (and cos_f32 for the backward), accurate over all floats and kept
// in registers; stage_async/wait_async the cp.async copies of the weights
// (and of kernel 7's embedding rows) into shared memory.

#pragma once

#include "field_common.cuh"

namespace {

constexpr int W = cn::W;     // 32
constexpr int kR = 64;       // rows a block
constexpr int kT = 128;      // threads a block
constexpr int kSLo = kE1 - 3;  // 84: the PE slots of emb1
constexpr int kBPad = 384;   // B [21, 3] or B2 [3, 126], padded to 16 bytes

// the PE: sin(pi 2^f (t B^T)) / sin(t B2) / read from device memory
enum Pe { kProj = 0, kFolded = 1, kLoaded = 2 };
// tile_layer's epilogues; the *Mask forms also keep the ReLU's derivative
// [a > 0] (a the pre-activation) for the backward, one byte a (row, column
// group of 4), bit j for column 4 g + j: mask [OUT / 4][kR] bytes, laid out
// as the layer's Tile, so that the thread that wrote a byte in the forward
// reads it in the backward (tile_dx).
enum Epi {
  kBiasOnly = 0, kRelu = 1, kReluAdd = 2, kReluAddMask = 3, kReluMask = 4
};

// The thread tile of an OUT-wide layer over the block's kR rows: OUT / 4
// column groups of 4 columns; quarter warp g (8 lanes) takes column group
// g % kCG and 8 consecutive row groups of kTM rows, so that the 8 lanes'
// loads of one k and their stores of one column cover 8 kTM consecutive
// floats (no bank conflicts), and a warp reads at most 4 distinct weight
// float4s a k.
template <int OUT>
struct Tile {
  static constexpr int kCG = OUT / 4;
  static constexpr int kRG = kT / kCG;
  static constexpr int kTM = kR / kRG;
  static_assert(kRG % 8 == 0 && kTM * kRG == kR && (kTM == 4 || kTM == 2),
                "tile");
  int r0, c0;
  __device__ __forceinline__ Tile() {
    const int g = threadIdx.x >> 3;
    const int u = threadIdx.x & 7;
    c0 = 4 * (g % kCG);
    r0 = kTM * ((g / kCG) * 8 + u);
  }
};

template <int TM>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[TM]) {
  if constexpr (TM == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  }
}

template <int TM>
__device__ __forceinline__ void store_rows(float* p, const float (&x)[TM]) {
  if constexpr (TM == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

// acc[i][j] = sum over k < K, in order, of xT[k][r0 + i] w[k][c0 + j]: one
// FMA chain per output.
template <int K, int OUT, int TM>
__device__ __forceinline__ void tile_mac(const float* xT, const float* w,
                                         int r0, int c0, float (&acc)[TM][4]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 wv = *reinterpret_cast<const float4*>(w + k * OUT + c0);
    float x[TM];
    load_rows<TM>(xT + k * kR + r0, x);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      acc[i][0] = fmaf(x[i], wv.x, acc[i][0]);
      acc[i][1] = fmaf(x[i], wv.y, acc[i][1]);
      acc[i][2] = fmaf(x[i], wv.z, acc[i][2]);
      acc[i][3] = fmaf(x[i], wv.w, acc[i][3]);
    }
  }
}

// One layer over the block's kR rows (the whole block):
//   yT = epi(((x1 W1 + x2 W2) + x3 W3) + b)
// with the pieces x_p k-major in shared memory (K_p rows each, K2 or K3 0
// when absent), W = [W1; W2; W3] row-major [K1+K2+K3, OUT] and b in shared
// memory; kReluAdd adds z after the ReLU, z's row r (r < nvalid) at
// z + r * zld in device memory. yT k-major [OUT][kR] in shared memory.
// kReluAddMask and kReluMask are kReluAdd and kRelu that also write the
// ReLU's mask bytes (enum Epi) to `mask` in shared memory.
template <int OUT, Epi E, int K1, int K2 = 0, int K3 = 0>
__device__ __forceinline__ void tile_layer(
    const float* x1, const float* x2, const float* x3, const float* w,
    const float* bias, const float* __restrict__ z, size_t zld, int nvalid,
    float* yT, unsigned char* mask = nullptr) {
  using S = Tile<OUT>;
  constexpr int TM = S::kTM;
  constexpr bool kAdd = E == kReluAdd || E == kReluAddMask;
  constexpr bool kKeep = E == kReluAddMask || E == kReluMask;
  const S ts;
  float zr[TM][4];
  if constexpr (kAdd) {
    // a row past N reads the block's first row and takes zeros (a
    // conditional load gave one instantiation a 16-byte stack frame)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const bool ok = ts.r0 + i < nvalid;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          z + (ok ? (ts.r0 + i) * zld + ts.c0 : 0)));
      zr[i][0] = ok ? v.x : 0.f;
      zr[i][1] = ok ? v.y : 0.f;
      zr[i][2] = ok ? v.z : 0.f;
      zr[i][3] = ok ? v.w : 0.f;
    }
  }
  float acc[TM][4];
  tile_mac<K1, OUT, TM>(x1, w, ts.r0, ts.c0, acc);
  if constexpr (K2 > 0) {
    float part[TM][4];
    tile_mac<K2, OUT, TM>(x2, w + K1 * OUT, ts.r0, ts.c0, part);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + part[i][j];
  }
  if constexpr (K3 > 0) {
    float part[TM][4];
    tile_mac<K3, OUT, TM>(x3, w + (K1 + K2) * OUT, ts.r0, ts.c0, part);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + part[i][j];
  }
  unsigned bits[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) bits[i] = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float b = bias[ts.c0 + j];
    float col[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = acc[i][j] + b;
      if constexpr (kKeep) bits[i] |= (v > 0.f ? 1u : 0u) << j;
      if constexpr (E != kBiasOnly) v = fmaxf(v, 0.f);
      if constexpr (kAdd) v = v + zr[i][j];
      col[i] = v;
    }
    store_rows<TM>(yT + (ts.c0 + j) * kR + ts.r0, col);
  }
  if constexpr (kKeep) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
      mask[(ts.c0 / 4) * kR + ts.r0 + i] = static_cast<unsigned char>(bits[i]);
  }
}

// The sigma head of one row, before the x10: h w_sg + b_sg (hT k-major).
__device__ __forceinline__ float sigma_head(const float* hT, const float* w,
                                            const float* b, int row) {
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < W; ++k) acc = fmaf(hT[k * kR + row], w[k], acc);
  return acc + b[0];
}

// The rgb head of one row, before the sigmoid: r6 W_1 + b_1 (r6T k-major,
// 16 wide; W_1 [16, 3]).
__device__ __forceinline__ void rgb_head(const float* r6T, const float* w,
                                         const float* b, int row,
                                         float a7[3]) {
  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < W / 2; ++k) {
    const float x = r6T[k * kR + row];
#pragma unroll
    for (int o = 0; o < 3; ++o) acc[o] = fmaf(x, w[3 * k + o], acc[o]);
  }
#pragma unroll
  for (int o = 0; o < 3; ++o) a7[o] = acc[o] + b[o];
}

// 2/pi, 32 bits a word from the most significant, behind a zero word: bit
// j >= 1 of its fraction is bit 31 + j of this string (from the top).
__constant__ unsigned kTwoOverPi[8] = {0u,          0xA2F9836Eu, 0x4E441529u,
                                       0xFC2757D1u, 0xF534DDC0u, 0xDB629599u,
                                       0x3C439041u, 0xFE5163ABu};

// sin(a) (or cos(a)), accurate to 2 ulp over all floats, with nothing in
// local memory
// (CUDA's sinf keeps the words of its Payne-Hanek reduction in a 28-byte
// local array: a stack frame in a kernel that calls it six times a loop).
// a = q pi/2 + r with |r| <= pi/4 (about): for |a| <= 105615 by Cody-Waite
// (three FMAs with pi/2 = c1 + c2 + c3, the first exact); beyond, by
// Payne-Hanek in registers: with |a| = m 2^(e-23) (m the 24-bit
// significand), a 2/pi mod 4 = m G mod 4, G the 96 bits of 2/pi from bit
// e - 24 on (top bit of weight 2), funnel-shifted out of kTwoOverPi; of the
// 120-bit product m G, bits 94-95 are q and bits 30-93 the fraction, then
// rounded to the nearest quadrant and scaled by pi/2 in double. Then sin
// or cos of r by its Taylor polynomial (to r^9, r^10: truncation below
// 0.05 ulp on |r| <= pi/4).
// kCos: cos(a) = cos(|a|) = sin(|a| + pi/2), the same reduction with the
// quadrant moved by one and no sign from a (cos_f32; CUDA's cosf keeps the
// same local array as sinf).
template <bool kCos>
__device__ __forceinline__ float sincos_f32(float a) {
  const float x = fabsf(a);
  float r;
  unsigned q;
  if (x <= 105615.f) {
    const float j = rintf(x * 0x1.45f306p-1f);  // 2/pi
    r = fmaf(-j, 0x1.921fb6p+0f, x);
    r = fmaf(-j, -0x1.777a5cp-25f, r);
    r = fmaf(-j, -0x1.ee59dap-50f, r);
    q = static_cast<unsigned>(j);
  } else {
    if (!isfinite(x)) return a - a;  // NaN for inf and NaN
    const unsigned ix = __float_as_uint(x);
    const unsigned m = (ix & 0x7fffffu) | 0x800000u;
    const int pos = static_cast<int>(ix >> 23) - 127 + 7;  // e + 7
    const int w = pos >> 5;
    const int sh = pos & 31;
    const unsigned w2 = __funnelshift_l(kTwoOverPi[w + 1], kTwoOverPi[w], sh);
    const unsigned w1 =
        __funnelshift_l(kTwoOverPi[w + 2], kTwoOverPi[w + 1], sh);
    const unsigned w0 =
        __funnelshift_l(kTwoOverPi[w + 3], kTwoOverPi[w + 2], sh);
    const unsigned long long p0 = static_cast<unsigned long long>(m) * w0;
    const unsigned long long p1 =
        static_cast<unsigned long long>(m) * w1 + (p0 >> 32);
    const unsigned long long p2 =
        static_cast<unsigned long long>(m) * w2 + (p1 >> 32);
    const unsigned hi = static_cast<unsigned>(p2);
    const unsigned long long f =
        (static_cast<unsigned long long>(hi & 0x3fffffffu) << 34) |
        (static_cast<unsigned long long>(static_cast<unsigned>(p1)) << 2) |
        (static_cast<unsigned>(p0) >> 30);
    q = (hi >> 30) + static_cast<unsigned>(f >> 63);
    r = static_cast<float>(static_cast<double>(static_cast<long long>(f)) *
                           0x1.921fb54442d18p-64);
  }
  if constexpr (kCos) q += 1u;
  const float r2 = r * r;
  float v;
  if (q & 1u) {
    float p = fmaf(r2, -0x1.27e4fcp-22f, 0x1.a01a02p-16f);  // -1/10!, 1/8!
    p = fmaf(r2, p, -0x1.6c16c2p-10f);                     // -1/6!
    p = fmaf(r2, p, 0x1.555556p-5f);                       // 1/4!
    p = fmaf(r2, p, -0.5f);
    v = fmaf(p, r2, 1.f);
  } else {
    float p = fmaf(r2, 0x1.71de3ap-19f, -0x1.a01a02p-13f);  // 1/9!, -1/7!
    p = fmaf(r2, p, 0x1.111112p-7f);                        // 1/5!
    p = fmaf(r2, p, -0x1.555556p-3f);                       // -1/3!
    v = fmaf(p * r2, r, r);
  }
  if (q & 2u) v = -v;
  if constexpr (kCos) return v;
  return a < 0.f ? -v : v;
}

__device__ __forceinline__ float sin_f32(float a) {
  return sincos_f32<false>(a);
}

__device__ __forceinline__ float cos_f32(float a) {
  return sincos_f32<true>(a);
}

// Copies n floats into shared memory (dst 16-byte aligned) with the whole
// block, one commit group: 16 bytes a cp.async where src is 16-byte aligned
// too (the 4-float tail 4 bytes a copy), else 4 bytes a copy.
__device__ __forceinline__ void stage_async(float* dst,
                                            const float* __restrict__ src,
                                            int n) {
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int k0 = 0;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    for (int k = threadIdx.x; k < n / 4; k += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       base + 16u * k),
                   "l"(src + 4 * k)
                   : "memory");
    k0 = n & ~3;
  }
  for (int k = k0 + threadIdx.x; k < n; k += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     base + 4u * k),
                 "l"(src + k)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `Pending` of this thread's newest commit groups are
// still in flight.
template <int Pending = 0>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// The PE of the block's rows into emb1T / emb2T (k-major), one thread a
// (row, direction): t is already in emb1T's first three rows and the
// basis in sB. kProj: sin(f32(pi 2^f) proj), proj = t B^T rounded as
// written (field_common's embed); kFolded: S = sin(t B2) with B2 folded
// (fold_b2, sinarg), slots f * 21 + d, [0, 84) into emb1 and the rest into
// emb2.
template <Pe PE>
__device__ __forceinline__ void block_embed(const float* sB, float* e1,
                                            float* e2) {
  for (int e = threadIdx.x; e < kR * kDirs; e += blockDim.x) {
    const int r = e % kR;
    const int d = e / kR;
    const float t[3] = {e1[r], e1[kR + r], e1[2 * kR + r]};
    float proj = 0.f;
    if constexpr (PE == kProj)
      proj = __fadd_rn(__fadd_rn(__fmul_rn(t[0], sB[3 * d]),
                                 __fmul_rn(t[1], sB[3 * d + 1])),
                       __fmul_rn(t[2], sB[3 * d + 2]));
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      const int s = f * kDirs + d;
      float arg;
      if constexpr (PE == kProj)
        arg = (kPi * static_cast<float>(1 << f)) * proj;
      else
        arg = sinarg(t, sB, s);
      float* dst = s < kSLo ? e1 + (3 + s) * kR : e2 + (s - kSLo) * kR;
      dst[r] = sin_f32(arg);
    }
  }
}

}  // namespace
