// The CodeNeRF ensemble forwards for Hopper (sm_90a), float32 throughout,
// as one shared-memory tiled chain kernel.
//
// Replaces the Pallas TPU kernels of catnerf_tpu/experimental/fused_field.py:
//   cn_fwd  <- _codenerf_fwd_kernel (:124), called at :310: the fused
//              ensemble, category-major pts [C,N,3], z* [C,N,32]
//              -> out [C,N,4] = [sigma x10 | sigmoid rgb];
//   cn2_fwd <- _cn2_fwd_kernel (:773), called at :900: the packed ensemble
//              ("categories in lanes"), point-major pts [N,3C], z* [N,32C]
//              -> sg [N,C], col [N,3C];
// and of scripts/exp_kernel2.py:
//   cn_mlp_fwd <- mlp_kernel (:73), called at :103: the chain alone on a
//              precomputed embedding, emb1 [C,N,87], emb2 [C,N,42] (the
//              script pads it to 48 only for the TPU's lanes), z*
//              [C,N,32] -> out [C,N,4].
// All three are chain_kernel<PE, IO>: one body, templated on the positional
// encoding (computed, each in its TPU original's association, or read from
// device memory) and on the I/O layout. cn_tile_layer runs one layer of
// that body alone, cn_sin its sine and cn_emb_load kernel 7's load of the
// embedding (test entries). The tile body itself (Tile, tile_layer, the
// heads, sin_f32, block_embed) is cn_tile.cuh, shared with the packed
// backward of codenerf_packed.cu.
//
// What bounds the work on an H100 is the operations: 13,648 multiply-adds
// a row (+378 for the packed PE) against 55.6 KB of weights that every row
// of a category shares; 0.79 GFLOP at C = 8 x 3,600 rows. Kernel 7 also
// reads 516 bytes of embedding a row, so its bytes come close behind (18.0
// MB at C = 8 x 2,100: 0.0054 ms against 0.0068 of operations). The design:
//   * a block owns one category and kR = 64 rows (128 threads); its
//     category's 13,892 parameters are staged into shared memory once,
//     16 bytes a cp.async, in flight while the PE is computed (kernel 7:
//     through its embedding's first transpose and second copy);
//   * the PE is computed cooperatively, one thread a (row, direction), six
//     accurate sines each, into shared memory, where emb1 [87] and emb2
//     [42] stay until the cat and viewdir layers read them. Kernel 7 loads
//     them instead (load_emb): the block's rows lie contiguous in device
//     memory, row-major, but the tile body reads them k-major, and a copy
//     with lanes on a row's consecutive elements would put a warp's 32
//     shared stores in one bank (kR is a multiple of 32). So the rows are
//     copied as they lie (cp.async, 16 bytes where the block's first row
//     is 16-byte aligned) into the shared memory that the activations take
//     later, and then transposed there with lanes on rows: a read stride of
//     87 floats is odd (no conflict), one of 42 a 2-way conflict;
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
// pieces of a concat added in order, then the bias, the order in which
// tile_layer_plain adds them), so the results do not depend on the grid.
// No fast math: the sine is sin_f32, accurate over all floats and kept in
// registers, expf the accurate version, and the PE projection of cn_fwd is
// rounded as written.
// Ragged rows are masked, not padded: a row past N reads zeros and writes
// nothing.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "cn_tile.cuh"

namespace {

enum Io { kCatMajor = 0, kPointMajor = 1 };

// Shared memory, in floats: the category's parameters and basis, then the
// activations, each k-major: emb1 [87][kR], emb2 [42][kR] and two 32-wide
// buffers [32][kR]. Before the first layer, emb2 and the two buffers also
// take kernel 7's embedding rows as they lie in device memory (load_emb).
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
static_assert(kSmY + W * kR - kSmE2 >= kE1 * kR && 2 * W * kR >= kE2 * kR,
              "load_emb's staging");

// eT [K][kR] (k-major) <- st [nvalid][K] (row-major) in shared memory, lanes
// on rows; rows past nvalid zero.
template <int K>
__device__ __forceinline__ void transpose_rows(const float* st, int nvalid,
                                               float* eT) {
  for (int e = threadIdx.x; e < K * kR; e += kT) {
    const int k = e / kR;
    const int r = e - k * kR;
    eT[e] = r < nvalid ? st[r * K + k] : 0.f;
  }
}

// The block's nvalid rows of emb1 [*, 87] and emb2 [*, 42], from row `row`
// on, into e1 [87][kR] and e2 [42][kR] (k-major, rows past nvalid zero),
// with the whole block, while the nw floats of w are staged into sW. e1
// and e2 lie at kSmE1 and kSmE2 of the chain kernel's shared memory; emb2
// and the two buffers behind it take the rows as they lie first. emb1's
// copy is committed before the weights', so the weights stay in flight
// through emb1's transpose and emb2's copy; on return every cp.async group
// has landed.
__device__ __forceinline__ void load_emb(const float* __restrict__ emb1,
                                         const float* __restrict__ emb2,
                                         size_t row, int nvalid, float* e1,
                                         float* e2, const float* __restrict__ w,
                                         float* sW, int nw) {
  float* st = e2;  // emb2 and X, Y behind it
  stage_async(st, emb1 + row * kE1, nvalid * kE1);
  stage_async(sW, w, nw);
  wait_async<1>();  // emb1's rows
  __syncthreads();
  transpose_rows<kE1>(st, nvalid, e1);
  __syncthreads();
  st = e2 + kE2 * kR;  // X, Y
  stage_async(st, emb2 + row * kE2, nvalid * kE2);
  wait_async();
  __syncthreads();
  transpose_rows<kE2>(st, nvalid, e2);
}

// grid (ceil(N / kR), C), kT threads, kSmemBytes of dynamic shared memory.
// kCatMajor: pts [C,N,3] (kLoaded: emb1 [C,N,87], emb2 [C,N,42]), z*
// [C,N,32] -> out0 [C,N,4] (out1 unused); kPointMajor: pts [N,3C], z*
// [N,32C] -> out0 = sg [N,C], out1 = col [N,3C]. pts and Bg are unused by
// kLoaded, emb1 and emb2 by the others.
template <Pe PE, Io IO>
__global__ void __launch_bounds__(kT, 2)
    chain_kernel(const float* __restrict__ pts,
                 const float* __restrict__ emb1,
                 const float* __restrict__ emb2,
                 const float* __restrict__ zs0,
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

  const float* w = params + static_cast<size_t>(c) * cn::P;
  if constexpr (PE == kLoaded) {
    load_emb(emb1, emb2, static_cast<size_t>(c) * N + row0, nvalid, e1, e2, w,
             sW, cn::P);
  } else {
    stage_async(sW, w, cn::P);
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
  }
  wait_async();
  __syncthreads();

  // the injections' rows of this block
  const size_t zoff = IO == kCatMajor
                          ? (static_cast<size_t>(c) * N + row0) * W
                          : static_cast<size_t>(row0) * W * C + W * c;
  const size_t zld = IO == kCatMajor ? W : static_cast<size_t>(W) * C;
  if constexpr (PE != kFolded)  // g0 = relu(emb1 We + be) + zs0
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
  if constexpr (PE != kFolded)
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

// kernel 7's load alone (the test entry cn_emb_load): the block's rows of
// emb1 [N,87] and emb2 [N,42] through load_emb into the chain kernel's
// shared memory, then written out as they lie there, k-major: out1
// [ceil(N / kR)][87][kR], out2 [ceil(N / kR)][42][kR], rows past N zero.
// No weights are staged. grid ceil(N / kR), kT threads, kSmemBytes (two
// blocks an SM, as the chain kernel).
__global__ void __launch_bounds__(kT, 2)
    emb_load_kernel(const float* __restrict__ emb1,
                    const float* __restrict__ emb2, float* __restrict__ out1,
                    float* __restrict__ out2, int N) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int row0 = blockIdx.x * kR;
  load_emb(emb1, emb2, row0, min(kR, N - row0), sm + kSmE1, sm + kSmE2,
           nullptr, sm + kSmW, 0);
  __syncthreads();
  float4* o1 = reinterpret_cast<float4*>(out1) +
               static_cast<size_t>(blockIdx.x) * (kE1 * kR / 4);
  float4* o2 = reinterpret_cast<float4*>(out2) +
               static_cast<size_t>(blockIdx.x) * (kE2 * kR / 4);
  for (int k = threadIdx.x; k < kE1 * kR / 4; k += kT)
    o1[k] = smem4[kSmE1 / 4 + k];
  for (int k = threadIdx.x; k < kE2 * kR / 4; k += kT)
    o2[k] = smem4[kSmE2 / 4 + k];
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
int launch_chain(const float* pts, const float* emb1, const float* emb2,
                 const float* zs0, const float* zc, const float* zs1,
                 const float* zt0, const float* params, const float* B,
                 float* out0, float* out1, int C, int N, float inv_scale,
                 cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      chain_kernel<PE, IO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  chain_kernel<PE, IO><<<dim3((N + kR - 1) / kR, C), kT, kSmemBytes, s>>>(
      pts, emb1, emb2, zs0, zc, zs1, zt0, params, B, out0, out1, N, C,
      inv_scale);
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
  return launch_chain<kProj, kCatMajor>(
      pts, nullptr, nullptr, zs0, zc, zs1, zt0, params, B, out, nullptr, C,
      N, inv_scale, static_cast<cudaStream_t>(stream));
}

// kernel 5: pts [N,3C], z* [N,32C], params [C,P], B [C,21,3]
// -> sg [N,C], col [N,3C]
int cn2_fwd(const float* pts, const float* zs0, const float* zc,
            const float* zs1, const float* zt0, const float* params,
            const float* B, float* sg, float* col, int C, int N,
            float inv_scale, void* stream) {
  return launch_chain<kFolded, kPointMajor>(
      pts, nullptr, nullptr, zs0, zc, zs1, zt0, params, B, sg, col, C, N,
      inv_scale, static_cast<cudaStream_t>(stream));
}

// kernel 7: emb1 [C,N,87], emb2 [C,N,42], z* [C,N,32], params [C,P]
// -> out [C,N,4]
int cn_mlp_fwd(const float* emb1, const float* emb2, const float* zs0,
               const float* zc, const float* zs1, const float* zt0,
               const float* params, float* out, int C, int N, void* stream) {
  return launch_chain<kLoaded, kCatMajor>(
      nullptr, emb1, emb2, zs0, zc, zs1, zt0, params, nullptr, out, nullptr,
      C, N, 1.f, static_cast<cudaStream_t>(stream));
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

// Kernel 7's load of the embedding alone: emb1 [N,87], emb2 [N,42]
// -> out1 [ceil(N / 64),87,64], out2 [ceil(N / 64),42,64], each block's
// rows k-major as the chain kernel holds them, rows past N zero.
int cn_emb_load(const float* emb1, const float* emb2, float* out1,
                float* out2, int N, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      emb_load_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  emb_load_kernel<<<(N + kR - 1) / kR, kT, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(emb1, emb2, out1,
                                                         out2, N);
  return static_cast<int>(cudaGetLastError());
}

// The chain kernel's sine alone: y[i] = sin(x[i]), i < n.
int cn_sin(const float* x, float* y, int n, void* stream) {
  sin_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
