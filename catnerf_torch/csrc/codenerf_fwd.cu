// The CodeNeRF ensemble forwards for Hopper (sm_90a), float32 throughout,
// as one shared-memory tiled chain kernel.
//
// Replaces the Pallas TPU kernels of catnerf_tpu/experimental/fused_field.py:
//   cn_fwd  <- _codenerf_fwd_kernel (:124), called at :310: the fused
//              ensemble, category-major pts [C,N,3], z* [C,N,32]
//              -> out [C,N,4] = [sigma x10 | sigmoid rgb];
//   cn2_fwd <- _cn2_fwd_kernel (:773), called at :900: the packed ensemble
//              ("categories in lanes"), point-major pts [N,3C], z* [N,32C]
//              -> sg [N,C], col [N,3C].
// Both are chain_kernel<PE, IO>: one body, templated on the positional
// encoding (each keeps its TPU original's association) and on the I/O
// layout. cn_tile_layer runs one layer of that body alone, and cn_sin its
// sine (test entries).
//
// What bounds the work on an H100 is the operations: 13,648 multiply-adds
// a row (+378 for the packed PE) against 55.6 KB of weights that every row
// of a category shares; 0.79 GFLOP at C = 8 x 3,600 rows. The design:
//   * a block owns one category and kR = 64 rows (128 threads); its
//     category's 13,892 parameters are staged into shared memory once,
//     16 bytes a cp.async, in flight while the PE is computed;
//   * the PE is computed cooperatively, one thread a (row, direction), six
//     accurate sines each, into shared memory, where emb1 [87] and emb2
//     [42] stay until the cat and viewdir layers read them;
//   * each of the eight 32- or 16-wide layers is a register-tiled product
//     out of shared memory: every activation is stored k-major ([k][row],
//     kR floats a k), so a thread's 4 (or 2) rows of one k are one float4
//     (float2) load and its 4 columns of W one more, for 16 (8) FMAs; the
//     concat layers are split products over their pieces where they lie
//     (the cat layer [g1 | emb1], the viewdir layer [h | emb2]); the
//     epilogue (bias, ReLU, + the injection z, whose rows are read 16
//     bytes a thread while the product runs) writes the next layer's input
//     back to shared memory, ping-ponging two 32-wide buffers;
//   * the sigma and rgb heads and the sigmoid are a thread a row, then one
//     coalesced store a row.
// Nothing goes to device memory between layers, and a call is one launch.
// Shared memory: 106,512 bytes a block, two blocks an SM.
//
// Each output's sum runs in one fixed order (an FMA chain over k, the
// pieces of a concat added in order, then the bias), that of field_common's
// dense/dense3, so the results do not depend on the grid. No fast math: the
// sine is sin_f32, accurate over all floats and kept in registers, expf the
// accurate version, and the PE projection of cn_fwd is rounded as written.
// Ragged rows are masked, not padded: a row past N reads zeros and writes
// nothing.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "field_common.cuh"

namespace {

constexpr int W = cn::W;     // 32
constexpr int kR = 64;       // rows a block
constexpr int kT = 128;      // threads a block
constexpr int kSLo = kE1 - 3;  // 84: the PE slots of emb1
constexpr int kBPad = 384;   // B [21, 3] or B2 [3, 126], padded to 16 bytes

// Shared memory, in floats: the category's parameters and basis, then the
// activations, each k-major: emb1 [87][kR], emb2 [42][kR] and two 32-wide
// buffers [32][kR].
constexpr int kSmW = 0;
constexpr int kSmB = kSmW + cn::P;
constexpr int kSmE1 = kSmB + kBPad;
constexpr int kSmE2 = kSmE1 + kE1 * kR;
constexpr int kSmX = kSmE2 + kE2 * kR;
constexpr int kSmY = kSmX + W * kR;
constexpr int kSmFloats = kSmY + W * kR;
constexpr size_t kSmemBytes = kSmFloats * sizeof(float);
static_assert(cn::P % 4 == 0 && kSmE1 % 4 == 0 && kSmE2 % 4 == 0 &&
                  kSmX % 4 == 0 && kSmY % 4 == 0,
              "16-byte aligned");
static_assert(kB2 <= kBPad && 2 * (kSmemBytes + 1024) <= 233472,
              "two blocks an SM");

enum Pe { kProj = 0, kFolded = 1 };       // sin(pi 2^f (t B^T)) / sin(t B2)
enum Io { kCatMajor = 0, kPointMajor = 1 };
enum Epi { kBiasOnly = 0, kRelu = 1, kReluAdd = 2 };

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
// FMA chain per output, as field_common's accumulate.
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
template <int OUT, Epi E, int K1, int K2 = 0, int K3 = 0>
__device__ __forceinline__ void tile_layer(
    const float* x1, const float* x2, const float* x3, const float* w,
    const float* bias, const float* __restrict__ z, size_t zld, int nvalid,
    float* yT) {
  using S = Tile<OUT>;
  constexpr int TM = S::kTM;
  const S ts;
  float zr[TM][4];
  if constexpr (E == kReluAdd) {
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
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float b = bias[ts.c0 + j];
    float col[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = acc[i][j] + b;
      if constexpr (E != kBiasOnly) v = fmaxf(v, 0.f);
      if constexpr (E == kReluAdd) v = v + zr[i][j];
      col[i] = v;
    }
    store_rows<TM>(yT + (ts.c0 + j) * kR + ts.r0, col);
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

// sin(a), accurate to 2 ulp over all floats, with nothing in local memory
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
__device__ __forceinline__ float sin_f32(float a) {
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
  return a < 0.f ? -v : v;
}

// Copies n floats (n % 4 == 0, both 16-byte aligned) into shared memory,
// 16 bytes a cp.async, with the whole block; one commit group.
__device__ __forceinline__ void stage_async(float* dst,
                                            const float* __restrict__ src,
                                            int n) {
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int k = threadIdx.x; k < n / 4; k += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + 16u * k),
                 "l"(src + 4 * k)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// grid (ceil(N / kR), C), kT threads, kSmemBytes of dynamic shared memory.
// kCatMajor: pts [C,N,3], z* [C,N,32] -> out0 [C,N,4] (out1 unused);
// kPointMajor: pts [N,3C], z* [N,32C] -> out0 = sg [N,C], out1 = col [N,3C].
template <Pe PE, Io IO>
__global__ void __launch_bounds__(kT, 2)
    chain_kernel(const float* __restrict__ pts, const float* __restrict__ zs0,
                 const float* __restrict__ zc, const float* __restrict__ zs1,
                 const float* __restrict__ zt0,
                 const float* __restrict__ params,
                 const float* __restrict__ Bg, float* __restrict__ out0,
                 float* __restrict__ out1, int N, int C, float inv_scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sW = sm + kSmW;
  float* sB = sm + kSmB;
  float* e1 = sm + kSmE1;
  float* e2 = sm + kSmE2;
  float* X = sm + kSmX;
  float* Y = sm + kSmY;
  const int c = blockIdx.y;
  const int row0 = blockIdx.x * kR;
  const int nvalid = min(kR, N - row0);
  const int tid = threadIdx.x;

  stage_async(sW, params + static_cast<size_t>(c) * cn::P, cn::P);
  if constexpr (PE == kProj) {
    for (int k = tid; k < kBSize; k += kT) sB[k] = Bg[c * kBSize + k];
  } else {
    fold_b2(Bg + c * kBSize, sB);
  }
  // t = pts * inv_scale into emb1's first three rows
  for (int e = tid; e < 3 * kR; e += kT) {
    const int r = e / 3;
    const int j = e - 3 * r;
    float p = 0.f;
    if (r < nvalid)
      p = IO == kCatMajor
              ? pts[(static_cast<size_t>(c) * N + row0) * 3 + e]
              : pts[static_cast<size_t>(row0 + r) * 3 * C + 3 * c + j];
    e1[j * kR + r] = p * inv_scale;
  }
  __syncthreads();
  block_embed<PE>(sB, e1, e2);
  wait_async();
  __syncthreads();

  // the injections' rows of this block
  const size_t zoff = IO == kCatMajor
                          ? (static_cast<size_t>(c) * N + row0) * W
                          : static_cast<size_t>(row0) * W * C + W * c;
  const size_t zld = IO == kCatMajor ? W : static_cast<size_t>(W) * C;
  if constexpr (PE == kProj)  // g0 = relu(emb1 We + be) + zs0
    tile_layer<W, kReluAdd, kE1>(e1, nullptr, nullptr, sW + cn::e_w,
                                 sW + cn::e_b, zs0 + zoff, zld, nvalid, X);
  else  // t and S apart, as _cn2_chain
    tile_layer<W, kReluAdd, 3, kSLo>(e1, e1 + 3 * kR, nullptr, sW + cn::e_w,
                                     sW + cn::e_b, zs0 + zoff, zld, nvalid,
                                     X);
  __syncthreads();
  // g1 = relu(g0 Ws0 + bs0) + zc
  tile_layer<W, kReluAdd, W>(X, nullptr, nullptr, sW + cn::s0_w, sW + cn::s0_b,
                             zc + zoff, zld, nvalid, Y);
  __syncthreads();
  // g2 = relu([g1 | emb1] Wc + bc) + zs1
  if constexpr (PE == kProj)
    tile_layer<W, kReluAdd, W, kE1>(Y, e1, nullptr, sW + cn::c_w,
                                    sW + cn::c_b, zs1 + zoff, zld, nvalid, X);
  else
    tile_layer<W, kReluAdd, W, 3, kSLo>(Y, e1, e1 + 3 * kR, sW + cn::c_w,
                                        sW + cn::c_b, zs1 + zoff, zld, nvalid,
                                        X);
  __syncthreads();
  // r3 = relu(g2 Ws1 + bs1)
  tile_layer<W, kRelu, W>(X, nullptr, nullptr, sW + cn::s1_w, sW + cn::s1_b,
                          nullptr, 0, nvalid, Y);
  __syncthreads();
  // h = r3 Wen + ben
  tile_layer<W, kBiasOnly, W>(Y, nullptr, nullptr, sW + cn::en_w,
                              sW + cn::en_b, nullptr, 0, nvalid, X);
  __syncthreads();
  float sg = 0.f;
  if (tid < kR) sg = sigma_head(X, sW + cn::sg_w, sW + cn::sg_b, tid);
  // g4 = relu([h | emb2] Wvd + bvd) + zt0
  tile_layer<W, kReluAdd, W, kE2>(X, e2, nullptr, sW + cn::vd_w, sW + cn::vd_b,
                                  zt0 + zoff, zld, nvalid, Y);
  __syncthreads();
  // r5 = relu(g4 Wt0 + bt0)
  tile_layer<W, kRelu, W>(Y, nullptr, nullptr, sW + cn::t0_w, sW + cn::t0_b,
                          nullptr, 0, nvalid, X);
  __syncthreads();
  // r6 = relu(r5 W0 + b0), 16 wide
  tile_layer<W / 2, kRelu, W>(X, nullptr, nullptr, sW + cn::r0_w,
                              sW + cn::r0_b, nullptr, 0, nvalid, Y);
  __syncthreads();
  if (tid >= nvalid) return;
  float a7[3];
  rgb_head(Y, sW + cn::r1_w, sW + cn::r1_b, tid, a7);
  const size_t row = row0 + tid;
  if constexpr (IO == kCatMajor) {
    reinterpret_cast<float4*>(out0)[static_cast<size_t>(c) * N + row] =
        make_float4(sg * 10.f, sigmoidf(a7[0]), sigmoidf(a7[1]),
                    sigmoidf(a7[2]));
  } else {
    out0[row * C + c] = sg * 10.f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out1[row * 3 * C + 3 * c + j] = sigmoidf(a7[j]);
  }
}

// ---------------------------------------------------------------------------
// One layer of the chain alone (the test entry cn_tile_layer)
// ---------------------------------------------------------------------------

// The chain's layers in kernel order (kernels/fused_field.py TILE_LAYERS);
// kLeSplit and kLcSplit are the packed kernel's forms of the encoding and
// cat layers, whose t rows are a piece of their own.
enum Layer {
  kLe = 0, kLs0, kLc, kLs1, kLen, kLsg, kLvd, kLt0, kLr0, kLr1,
  kLeSplit, kLcSplit
};

// Shared memory of the test kernel, in floats: x k-major [119][kR], the
// layer's weights [119 * 32] and bias, and its output [32][kR].
constexpr int kTestX = 0;
constexpr int kTestW = kTestX + (W + kE1) * kR;
constexpr int kTestB = kTestW + (W + kE1) * W;
constexpr int kTestY = kTestB + W;
constexpr size_t kTestSmemBytes = (kTestY + W * kR) * sizeof(float);

// x [N, K] row-major (the layer's pieces side by side), w [K, OUT], bias
// [OUT], z [N, OUT] (the layers followed by an injection) -> y [N, OUT]
// row-major; grid ceil(N / kR), kT threads, kTestSmemBytes. The layer runs
// the chain kernel's own code: tile_layer for the eight products, and for
// the two heads sigma_head then the x10, rgb_head then the sigmoid.
template <int L>
__global__ void __launch_bounds__(kT)
    tile_layer_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ z, float* __restrict__ y,
                      int N) {
  constexpr int K = L == kLe || L == kLeSplit   ? kE1
                    : L == kLc || L == kLcSplit ? W + kE1
                    : L == kLvd                 ? W + kE2
                    : L == kLr1                 ? W / 2
                                                : W;
  constexpr int OUT = L == kLsg ? 1 : L == kLr1 ? 3 : L == kLr0 ? W / 2 : W;
  constexpr Epi E = L == kLs1 || L == kLt0 || L == kLr0  ? kRelu
                    : L == kLen || L == kLsg || L == kLr1 ? kBiasOnly
                                                          : kReluAdd;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sx = sm + kTestX;
  float* sW = sm + kTestW;
  float* sb = sm + kTestB;
  float* sy = sm + kTestY;
  const int row0 = blockIdx.x * kR;
  const int nvalid = min(kR, N - row0);
  const int tid = threadIdx.x;
  for (int e = tid; e < kR * K; e += kT) {
    const int r = e / K;
    const int k = e - r * K;
    sx[k * kR + r] = r < nvalid ? x[static_cast<size_t>(row0) * K + e] : 0.f;
  }
  for (int e = tid; e < K * OUT; e += kT) sW[e] = w[e];
  for (int e = tid; e < OUT; e += kT) sb[e] = bias[e];
  __syncthreads();
  float* yb = y + static_cast<size_t>(row0) * OUT;
  if constexpr (L == kLsg) {
    if (tid < nvalid) yb[tid] = sigma_head(sx, sW, sb, tid) * 10.f;
    return;
  } else if constexpr (L == kLr1) {
    if (tid < nvalid) {
      float a7[3];
      rgb_head(sx, sW, sb, tid, a7);
#pragma unroll
      for (int j = 0; j < 3; ++j) yb[3 * tid + j] = sigmoidf(a7[j]);
    }
    return;
  } else {
    const float* zb =
        E == kReluAdd ? z + static_cast<size_t>(row0) * OUT : nullptr;
    if constexpr (L == kLe)
      tile_layer<OUT, E, kE1>(sx, nullptr, nullptr, sW, sb, zb, OUT, nvalid,
                              sy);
    else if constexpr (L == kLeSplit)
      tile_layer<OUT, E, 3, kSLo>(sx, sx + 3 * kR, nullptr, sW, sb, zb, OUT,
                                  nvalid, sy);
    else if constexpr (L == kLc)
      tile_layer<OUT, E, W, kE1>(sx, sx + W * kR, nullptr, sW, sb, zb, OUT,
                                 nvalid, sy);
    else if constexpr (L == kLcSplit)
      tile_layer<OUT, E, W, 3, kSLo>(sx, sx + W * kR, sx + (W + 3) * kR, sW,
                                     sb, zb, OUT, nvalid, sy);
    else if constexpr (L == kLvd)
      tile_layer<OUT, E, W, kE2>(sx, sx + W * kR, nullptr, sW, sb, zb, OUT,
                                 nvalid, sy);
    else
      tile_layer<OUT, E, W>(sx, nullptr, nullptr, sW, sb, zb, OUT, nvalid,
                            sy);
    __syncthreads();
    for (int e = tid; e < nvalid * OUT; e += kT) {
      const int r = e / OUT;
      const int o = e - r * OUT;
      yb[e] = sy[o * kR + r];
    }
  }
}

// y = sin_f32(x), one thread an element (the test entry cn_sin).
__global__ void sin_kernel(const float* __restrict__ x, float* __restrict__ y,
                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = sin_f32(x[i]);
}

template <int L>
int launch_tile_layer(const float* x, const float* w, const float* bias,
                      const float* z, float* y, int N, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      tile_layer_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTestSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  tile_layer_kernel<L><<<(N + kR - 1) / kR, kT, kTestSmemBytes, s>>>(
      x, w, bias, z, y, N);
  return static_cast<int>(cudaGetLastError());
}

template <Pe PE, Io IO>
int launch_chain(const float* pts, const float* zs0, const float* zc,
                 const float* zs1, const float* zt0, const float* params,
                 const float* B, float* out0, float* out1, int C, int N,
                 float inv_scale, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      chain_kernel<PE, IO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  chain_kernel<PE, IO><<<dim3((N + kR - 1) / kR, C), kT, kSmemBytes, s>>>(
      pts, zs0, zc, zs1, zt0, params, B, out0, out1, N, C, inv_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// [CodeNeRF P, rows a block, threads a block, dynamic shared memory bytes
// of the chain kernel]
int codenerf_fwd_layout(int* out) {
  out[0] = cn::P;
  out[1] = kR;
  out[2] = kT;
  out[3] = static_cast<int>(kSmemBytes);
  return 0;
}

// kernel 1: pts [C,N,3], z* [C,N,32], params [C,P], B [C,21,3]
// -> out [C,N,4]
int cn_fwd(const float* pts, const float* zs0, const float* zc,
           const float* zs1, const float* zt0, const float* params,
           const float* B, float* out, int C, int N, float inv_scale,
           void* stream) {
  return launch_chain<kProj, kCatMajor>(pts, zs0, zc, zs1, zt0, params, B,
                                        out, nullptr, C, N, inv_scale,
                                        static_cast<cudaStream_t>(stream));
}

// kernel 5: pts [N,3C], z* [N,32C], params [C,P], B [C,21,3]
// -> sg [N,C], col [N,3C]
int cn2_fwd(const float* pts, const float* zs0, const float* zc,
            const float* zs1, const float* zt0, const float* params,
            const float* B, float* sg, float* col, int C, int N,
            float inv_scale, void* stream) {
  return launch_chain<kFolded, kPointMajor>(
      pts, zs0, zc, zs1, zt0, params, B, sg, col, C, N, inv_scale,
      static_cast<cudaStream_t>(stream));
}

// One layer of the chain alone (enum Layer, kernels/fused_field.py
// TILE_LAYERS): x [N, K], w [K, OUT], bias [OUT], z [N, OUT] or null
// -> y [N, OUT], all row-major. Any other layer is cudaErrorInvalidValue.
int cn_tile_layer(int layer, const float* x, const float* w,
                  const float* bias, const float* z, float* y, int N,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layer) {
    case kLe: return launch_tile_layer<kLe>(x, w, bias, z, y, N, s);
    case kLs0: return launch_tile_layer<kLs0>(x, w, bias, z, y, N, s);
    case kLc: return launch_tile_layer<kLc>(x, w, bias, z, y, N, s);
    case kLs1: return launch_tile_layer<kLs1>(x, w, bias, z, y, N, s);
    case kLen: return launch_tile_layer<kLen>(x, w, bias, z, y, N, s);
    case kLsg: return launch_tile_layer<kLsg>(x, w, bias, z, y, N, s);
    case kLvd: return launch_tile_layer<kLvd>(x, w, bias, z, y, N, s);
    case kLt0: return launch_tile_layer<kLt0>(x, w, bias, z, y, N, s);
    case kLr0: return launch_tile_layer<kLr0>(x, w, bias, z, y, N, s);
    case kLr1: return launch_tile_layer<kLr1>(x, w, bias, z, y, N, s);
    case kLeSplit: return launch_tile_layer<kLeSplit>(x, w, bias, z, y, N, s);
    case kLcSplit: return launch_tile_layer<kLcSplit>(x, w, bias, z, y, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The chain kernel's sine alone: y[i] = sin(x[i]), i < n.
int cn_sin(const float* x, float* y, int n, void* stream) {
  sin_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
