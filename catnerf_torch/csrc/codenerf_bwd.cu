// The CodeNeRF ensemble backward for Hopper (sm_90a), float32 throughout,
// as a chain of tiled GEMMs (gemm_f32.cuh) and row and column kernels.
//
// Replaces the Pallas TPU kernel _codenerf_bwd_kernel (:135) of
// catnerf_tpu/experimental/fused_field.py (_make_codenerf_fused.f_bwd
// :328): recompute the chain (_codenerf_chain :81) from the PE, then the
// hand-derived backward, per category c < C over its N rows: dpts, the
// injection gradients dzs0 = dg0, dzc = dg1, dzs1 = dg2, dzt0 = dg4, and
// grads [C, P + 63] (dW, db of the ten layers, then dB).
//
// What bounds it on an H100 is the operations: 3 x 13,648 multiply-adds a
// row (forward recompute, input gradients, weight gradients), 2.4 GFLOP at
// C = 8 x 3,600 rows, against 55.6 KB of weights a category. The layers
// are 32 wide, so every product is [rows, 16..119] by [16..119, 32] or a
// transpose, and each is tiny (~60 MFLOP over the 8 categories):
//   * the GEMM block at its 128 x 32 tile (128 threads, an 8 x 4 register
//     tile each), the category on blockIdx.z; every operand is
//     category-major [C, rows, cols], the weights [C, P];
//   * the PE writes emb1 once, into the tail of [g1 | emb1] (119 wide),
//     and emb2 into the tail of [h | emb2] (74 wide); the encoding layer
//     reads emb1 there at stride 119, and the products of the cat and
//     viewdir layers read the concatenations whole;
//   * the ReLU mask of a layer followed by an injection is its own output
//     r (a > 0 exactly when relu(a) > 0), not the next layer's input
//     g = r + z: the forward's bias + ReLU + add epilogue stores both, and
//     the input gradient's grad-mask epilogue stores dg unmasked (the
//     injection's gradient, straight into the dz output) and dg [r > 0]
//     (the delta of the layer below);
//   * the heads (sigma 32 -> 1, rgb 16 -> 3 and the sigmoid), the PE's
//     backward and the narrow gradients (every bias, the sigma and rgb
//     heads' weights, dB) are row or column kernels; the sigma head's term
//     of dh, dsg w_sg^T, is a K = 1 product accumulated onto dh.
// Every sum runs in a fixed order and no atomics are used: the weight
// gradients are per-chunk partials (kChunks row chunks a category) that
// reduce_tiles adds in order, so two runs are bitwise equal. The
// activations and deltas live in a workspace the caller allocates (kWsCols
// floats a row and category, rows rounded up to 4).
//
// cn_bwd launches everything on the caller's stream, allocates nothing and
// returns the first non-zero cudaGetLastError(); cn_gemm launches the GEMM
// block alone, at the layouts and epilogues the chain uses.

#include "field_common.cuh"
#include "gemm_f32.cuh"

namespace {

constexpr int W = cn::W;        // 32
constexpr int kW2 = W / 2;      // 16: rgb_0's output
constexpr int kXc = W + kE1;    // 119: [g1 | emb1], the cat layer's input
constexpr int kXv = W + kE2;    // 74: [h | emb2], the viewdir layer's input
constexpr int kChunks = 16;     // row chunks of the weight gradients
constexpr int kThreads = GemmShape<W>::kThreads;

// One [C, Np, ld] buffer of the workspace, or an input or output [C, N, ld]
// tensor: row r of category c at p + c * s + r * ld.
struct Mat {
  float* p;
  int ld;
  size_t s;
  __host__ __device__ float* row(int c, int r) const {
    return p + c * s + static_cast<size_t>(r) * ld;
  }
  __host__ __device__ Mat cols(int off) const { return {p + off, ld, s}; }
};

Mat tensor(const float* p, int ld, int N) {
  return {const_cast<float*>(p), ld, static_cast<size_t>(N) * ld};
}

// The workspace's buffers, in order.
enum Slot {
  kXcS,    // [g1 | emb1]
  kXvS,    // [h | emb2]
  kProj,   // proj, then dproj [21]
  kR0, kG0, kR1, kR2, kG2, kR3, kR4, kG4, kR5,
  kR6,     // [16]
  kDsg,    // [1] dout[0] x 10
  kDa7,    // [3]
  kDa6,    // [16]
  kDa5, kDa4,
  kDxv,    // [dh | demb2]
  kDa3, kDa2, kDa1,
  kDemb1,  // [87]
  kDa0,
  kSlots
};
constexpr int kCols[kSlots] = {kXc, kXv, kDirs, W, W, W, W, W, W, W, W, W,
                               kW2, 1, 3, kW2, W, W, kXv, W, W, W, kE1, W};

constexpr int ws_cols() {
  int n = 0;
  for (int i = 0; i < kSlots; ++i) n += kCols[i];
  return n;
}
constexpr int kWsCols = ws_cols();
static_assert(kWsCols == 891, "workspace");

struct Buffers {
  Mat m[kSlots];
};

// Buffers [C, Np, cols] one after another, Np = N rounded up to 4 (so each
// starts 16-byte aligned).
Buffers carve(float* ws, int C, int Np) {
  Buffers w;
  size_t off = 0;
  for (int i = 0; i < kSlots; ++i) {
    const size_t s = static_cast<size_t>(Np) * kCols[i];
    w.m[i] = {ws + off, kCols[i], s};
    off += C * s;
  }
  return w;
}

// One thread a (row, category): the PE into the tails of [g1 | emb1] and
// [h | emb2], and proj.
__global__ void embed_rows(const float* __restrict__ pts,
                           const float* __restrict__ B, Buffers w, int N,
                           float inv_scale) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (row >= N) return;
  float p[3], t[3], proj[kDirs];
  load_row<3>(pts + (static_cast<size_t>(c) * N + row) * 3, true, p);
  embed(p, B + c * kBSize, inv_scale, t, proj, w.m[kXcS].row(c, row) + W,
        w.m[kXvS].row(c, row) + W);
  float* dst = w.m[kProj].row(c, row);
  for (int k = 0; k < kDirs; ++k) dst[k] = proj[k];
}

// One thread a (row, category): the rgb head a7 = r6 W_r1 + b_r1,
// da7 = dout[1:4] s (1 - s) with s = sigmoid(a7), dsg = 10 dout[0], and
// da6 = (da7 W_r1^T) [r6 > 0]. (sigma itself is not needed: its gradient
// is dsg whatever its value.)
__global__ void head_rows(const float* __restrict__ params,
                          const float* __restrict__ dout, Buffers w, int N) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (row >= N) return;
  const float* prm = params + static_cast<size_t>(c) * cn::P;
  const float* Wr1 = prm + cn::r1_w;  // [16, 3]
  float r6[kW2];
  load_row<kW2>(w.m[kR6].row(c, row), true, r6);
  float a[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kW2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) a[j] = fmaf(r6[i], Wr1[i * 3 + j], a[j]);
  float dd[4];
  load_row<4>(dout + (static_cast<size_t>(c) * N + row) * 4, true, dd);
  float da7[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float col = sigmoidf(a[j] + prm[cn::r1_b + j]);
    da7[j] = dd[1 + j] * col * (1.f - col);
    w.m[kDa7].row(c, row)[j] = da7[j];
  }
  *w.m[kDsg].row(c, row) = dd[0] * 10.f;
  float* da6 = w.m[kDa6].row(c, row);
#pragma unroll
  for (int i = 0; i < kW2; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) s = fmaf(da7[j], Wr1[i * 3 + j], s);
    da6[i] = r6[i] > 0.f ? s : 0.f;
  }
}

// One thread a (row, category): embed_bwd from demb1 and demb2 (the tail
// of [dh | demb2]); dproj replaces proj, dpts = dt * inv_scale.
__global__ void embed_bwd_rows(const float* __restrict__ B, Buffers w,
                               float* __restrict__ dpts, int N,
                               float inv_scale) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (row >= N) return;
  float* pr = w.m[kProj].row(c, row);
  float proj[kDirs], dproj[kDirs], dt[3];
  for (int k = 0; k < kDirs; ++k) proj[k] = pr[k];
  embed_bwd(w.m[kDemb1].row(c, row), w.m[kDxv].row(c, row) + W, proj,
            B + c * kBSize, dproj, dt);
  for (int k = 0; k < kDirs; ++k) pr[k] = dproj[k];
  float* d = dpts + (static_cast<size_t>(c) * N + row) * 3;
#pragma unroll
  for (int j = 0; j < 3; ++j) d[j] = dt[j] * inv_scale;
}

// The weight gradients of the eight wide layers, grouped: blockIdx.x picks
// the layer, blockIdx.y the row chunk s, blockIdx.z the category c; the
// block writes X[r0:r1]^T D[r0:r1] (at most 119 x 32, one tile) into
// partial[c][s] at the layer's offset.
__global__ void __launch_bounds__(kThreads, GemmShape<W>::kMinBlocks)
    wgrad_kernel(Buffers w, float* __restrict__ partial, int N, int rows) {
  const int s = blockIdx.y;
  const int c = blockIdx.z;
  int r0, r1;
  chunk_rows(N, rows, s, r0, r1);
  Mat x, d;
  int in = W, out = W, off;
  switch (blockIdx.x) {
    case 0: x = w.m[kXcS].cols(W); in = kE1; d = w.m[kDa0]; off = cn::e_w;
            break;
    case 1: x = w.m[kG0]; d = w.m[kDa1]; off = cn::s0_w; break;
    case 2: x = w.m[kXcS]; in = kXc; d = w.m[kDa2]; off = cn::c_w; break;
    case 3: x = w.m[kG2]; d = w.m[kDa3]; off = cn::s1_w; break;
    case 4: x = w.m[kR3]; d = w.m[kDxv]; off = cn::en_w; break;
    case 5: x = w.m[kXvS]; in = kXv; d = w.m[kDa4]; off = cn::vd_w; break;
    case 6: x = w.m[kG4]; d = w.m[kDa5]; off = cn::t0_w; break;
    default: x = w.m[kR5]; d = w.m[kDa6]; out = kW2; off = cn::r0_w;
  }
  float* part = partial + (static_cast<size_t>(c) * kChunks + s) * cn::PP;
  const Gemm g = make_gemm(x.row(c, r0), x.ld, d.row(c, r0), d.ld,
                           part + off, out, in, out, r1 - r0);
  gemm_tile<W, kTN, kMask>(g, 0, 0);  // no mask: a plain store
}
constexpr int kWgradJobs = 8;

// The narrow gradients of chunk s (blockIdx.y) and category c (blockIdx.z),
// one job a block (blockIdx.x), thread e on element e, the chunk's rows in
// order: jobs 0-7 the biases of e, s0, c, s1, en, vd, t0, r0 (column sums of
// their deltas), 8 the sigma head (h dsg, sum dsg), 9 the rgb head
// (r6^T da7, sum da7), 10 dB = dproj^T t.
__global__ void __launch_bounds__(64)
    narrow_kernel(const float* __restrict__ pts, Buffers w,
                  float* __restrict__ partial, int N, int rows,
                  float inv_scale) {
  const int job = blockIdx.x;
  const int s = blockIdx.y;
  const int c = blockIdx.z;
  const int e = threadIdx.x;
  int r0, r1;
  chunk_rows(N, rows, s, r0, r1);
  float* part = partial + (static_cast<size_t>(c) * kChunks + s) * cn::PP;
  float acc = 0.f;
  if (job < 8) {
    Mat d;
    int off, width = W;
    switch (job) {
      case 0: d = w.m[kDa0]; off = cn::e_b; break;
      case 1: d = w.m[kDa1]; off = cn::s0_b; break;
      case 2: d = w.m[kDa2]; off = cn::c_b; break;
      case 3: d = w.m[kDa3]; off = cn::s1_b; break;
      case 4: d = w.m[kDxv]; off = cn::en_b; break;  // dh
      case 5: d = w.m[kDa4]; off = cn::vd_b; break;
      case 6: d = w.m[kDa5]; off = cn::t0_b; break;
      default: d = w.m[kDa6]; off = cn::r0_b; width = kW2;
    }
    if (e >= width) return;
    for (int r = r0; r < r1; ++r) acc += d.row(c, r)[e];
    part[off + e] = acc;
  } else if (job == 8) {
    if (e > W) return;
    for (int r = r0; r < r1; ++r) {
      const float ds = *w.m[kDsg].row(c, r);
      acc = e < W ? fmaf(w.m[kXvS].row(c, r)[e], ds, acc) : acc + ds;
    }
    part[e < W ? cn::sg_w + e : cn::sg_b] = acc;
  } else if (job == 9) {
    if (e >= kW2 * 3 + 3) return;
    const int i = e / 3;
    const int j = e % 3;
    for (int r = r0; r < r1; ++r) {
      const float da = w.m[kDa7].row(c, r)[j];
      acc = i < kW2 ? fmaf(w.m[kR6].row(c, r)[i], da, acc) : acc + da;
    }
    part[i < kW2 ? cn::r1_w + e : cn::r1_b + j] = acc;
  } else {
    if (e >= kBSize) return;
    const int k = e / 3;
    const int j = e % 3;
    const float* p = pts + static_cast<size_t>(c) * N * 3;
    for (int r = r0; r < r1; ++r)
      acc = fmaf(w.m[kProj].row(c, r)[k],
                 p[static_cast<size_t>(r) * 3 + j] * inv_scale, acc);
    part[cn::P + e] = acc;
  }
}
constexpr int kNarrowJobs = 11;

// A layer's weights [C][in, out] at `off` of the flat parameters (row
// stride out, batch stride P).
Mat weights(const float* params, int off, int out) {
  return {const_cast<float*>(params) + off, out, cn::P};
}

Gemm batched(Mat A, Mat B, Mat C, int M, int N, int K) {
  Gemm g = make_gemm(A.p, A.ld, B.p, B.ld, C.p, C.ld, M, N, K);
  g.sA = A.s;
  g.sB = B.s;
  g.sC = C.s;
  return g;
}

// C = relu(X W + b), and with Z: C2 = C + Z (the next layer's input);
// without relu: C = X W + b. X [N, K], W [K, n].
int forward_layer(Mat X, int K, const float* prm, int woff, int boff, int n,
                  Mat C, const Mat* Z, const Mat* C2, bool relu, int N,
                  int batches, cudaStream_t s) {
  Gemm g = batched(X, weights(prm, woff, n), C, N, n, K);
  g.bias = prm + boff;
  g.sbias = cn::P;
  if (Z != nullptr) {
    g.Z = Z->p;
    g.ldz = Z->ld;
    g.sZ = Z->s;
    g.C2 = C2->p;
    g.ldc2 = C2->ld;
    g.sC2 = C2->s;
    return launch_gemm<W, kNN, kBiasReluAdd>(g, s, batches);
  }
  return relu ? launch_gemm<W, kNN, kBiasRelu>(g, s, batches)
              : launch_gemm<W, kNN, kBias>(g, s, batches);
}

// The input gradient D W^T of a layer whose weights are [n, k] at woff
// (row stride k): D [N, k] -> C [N, n]. With Dm: C = dg, the injection's
// gradient, and Dm = dg [mask > 0] (grad-mask); otherwise C = dg [mask >
// 0] on the first n columns, or a plain store with no mask.
int input_grad(Mat D, const float* prm, int woff, int k, int n, Mat C,
               const Mat* mask, const Mat* Dm, int N, int batches,
               cudaStream_t s) {
  Gemm g = batched(D, weights(prm, woff, k), C, N, n, k);
  if (mask != nullptr) {
    g.mask = mask->p;
    g.ldm = mask->ld;
    g.smask = mask->s;
    g.mask_cols = n;
  }
  if (Dm != nullptr) {
    g.C2 = Dm->p;
    g.ldc2 = Dm->ld;
    g.sC2 = Dm->s;
    return launch_gemm<W, kNT, kGradMask>(g, s, batches);
  }
  return launch_gemm<W, kNT, kMask>(g, s, batches);
}

#define CN_TRY(call)       \
  if ((e = (call)) != 0) { \
    return e;              \
  }

}  // namespace

extern "C" {

// [CodeNeRF P, partial row, row chunks, workspace floats a row and category]
int codenerf_bwd_layout(int* out) {
  out[0] = cn::P;
  out[1] = cn::PP;
  out[2] = kChunks;
  out[3] = kWsCols;
  return 0;
}

// The 32-wide GEMM block alone over `batch` products, with the arguments of
// struct Gemm (gemm_f32.cuh), strides in floats; layout 0 NN, 1 NT, 2 TN;
// epilogue 0 bias + ReLU, 1 mask, 2 accumulate, 3 bias, 4 bias + ReLU +
// add, 5 grad-mask. Only the pairs the chain uses are built: NN with 0, 3
// and 4; NT with 1, 2 and 5; TN with 1. Any other is cudaErrorInvalidValue.
int cn_gemm(int layout, int epilogue, int batch, const float* A, int lda,
            int sA, const float* B, int ldb, int sB, float* C, int ldc,
            int sC, int M, int N, int K, const float* bias, int sbias,
            const float* mask, int ldm, int smask, int mask_cols,
            const float* Z, int ldz, int sZ, float* C2, int ldc2, int sC2,
            void* stream) {
  Gemm g = make_gemm(A, lda, B, ldb, C, ldc, M, N, K);
  g.sA = sA;
  g.sB = sB;
  g.sC = sC;
  g.bias = bias;
  g.sbias = sbias;
  g.mask = mask;
  g.ldm = ldm;
  g.smask = smask;
  g.mask_cols = mask_cols;
  g.Z = Z;
  g.ldz = ldz;
  g.sZ = sZ;
  g.C2 = C2;
  g.ldc2 = ldc2;
  g.sC2 = sC2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout * 8 + epilogue) {
    case kNN * 8 + kBiasRelu: return launch_gemm<W, kNN, kBiasRelu>(g, s, batch);
    case kNN * 8 + kBias: return launch_gemm<W, kNN, kBias>(g, s, batch);
    case kNN * 8 + kBiasReluAdd:
      return launch_gemm<W, kNN, kBiasReluAdd>(g, s, batch);
    case kNT * 8 + kMask: return launch_gemm<W, kNT, kMask>(g, s, batch);
    case kNT * 8 + kAccumulate:
      return launch_gemm<W, kNT, kAccumulate>(g, s, batch);
    case kNT * 8 + kGradMask: return launch_gemm<W, kNT, kGradMask>(g, s, batch);
    case kTN * 8 + kMask: return launch_gemm<W, kTN, kMask>(g, s, batch);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// pts [C,N,3], z* [C,N,32], params [C,P], B [C,21,3], dout [C,N,4] ->
// dpts [C,N,3], dz* [C,N,32] (dzs0 = dg0, dzc = dg1, dzs1 = dg2,
// dzt0 = dg4), grads [C, P + 63] (via partial [C, kChunks, P + 63]);
// workspace [C * ceil4(N) * kWsCols]
int cn_bwd(const float* pts, const float* zs0, const float* zc,
           const float* zs1, const float* zt0, const float* params,
           const float* B, const float* dout, float* dpts, float* dzs0,
           float* dzc, float* dzs1, float* dzt0, float* partial,
           float* grads, float* workspace, int C, int N, float inv_scale,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* prm = params;
  const Buffers w = carve(workspace, C, (N + 3) / 4 * 4);
  const Mat* m = w.m;
  const Mat z0 = tensor(zs0, W, N), z1 = tensor(zc, W, N),
            z2 = tensor(zs1, W, N), z4 = tensor(zt0, W, N);
  const Mat dz0 = tensor(dzs0, W, N), dz1 = tensor(dzc, W, N),
            dz2 = tensor(dzs1, W, N), dz4 = tensor(dzt0, W, N);
  const dim3 rows_grid((N + 127) / 128, C);
  const int rows = (N + kChunks - 1) / kChunks;
  int e;
  embed_rows<<<rows_grid, 128, 0, s>>>(pts, B, w, N, inv_scale);
  CN_TRY(static_cast<int>(cudaGetLastError()));
  // the forward recompute (_codenerf_chain :81); r_k the ReLU outputs (the
  // masks), g_k = r_k + z_k the next layers' inputs
  const Mat xc = m[kXcS], xv = m[kXvS];
  const Mat g1 = xc.cols(0), h = xv.cols(0);
  CN_TRY(forward_layer(xc.cols(W), kE1, prm, cn::e_w, cn::e_b, W, m[kR0],
                       &z0, &m[kG0], true, N, C, s));
  CN_TRY(forward_layer(m[kG0], W, prm, cn::s0_w, cn::s0_b, W, m[kR1], &z1,
                       &g1, true, N, C, s));
  CN_TRY(forward_layer(xc, kXc, prm, cn::c_w, cn::c_b, W, m[kR2], &z2,
                       &m[kG2], true, N, C, s));
  CN_TRY(forward_layer(m[kG2], W, prm, cn::s1_w, cn::s1_b, W, m[kR3],
                       nullptr, nullptr, true, N, C, s));
  CN_TRY(forward_layer(m[kR3], W, prm, cn::en_w, cn::en_b, W, h, nullptr,
                       nullptr, false, N, C, s));
  CN_TRY(forward_layer(xv, kXv, prm, cn::vd_w, cn::vd_b, W, m[kR4], &z4,
                       &m[kG4], true, N, C, s));
  CN_TRY(forward_layer(m[kG4], W, prm, cn::t0_w, cn::t0_b, W, m[kR5],
                       nullptr, nullptr, true, N, C, s));
  CN_TRY(forward_layer(m[kR5], W, prm, cn::r0_w, cn::r0_b, kW2, m[kR6],
                       nullptr, nullptr, true, N, C, s));
  head_rows<<<rows_grid, 128, 0, s>>>(prm, dout, w, N);
  CN_TRY(static_cast<int>(cudaGetLastError()));
  // the input gradients, output to input
  CN_TRY(input_grad(m[kDa6], prm, cn::r0_w, kW2, W, m[kDa5], &m[kR5],
                    nullptr, N, C, s));  // da5
  CN_TRY(input_grad(m[kDa5], prm, cn::t0_w, W, W, dz4, &m[kR4], &m[kDa4], N,
                    C, s));  // dg4, da4
  CN_TRY(input_grad(m[kDa4], prm, cn::vd_w, W, kXv, m[kDxv], nullptr,
                    nullptr, N, C, s));  // [dh | demb2] = da4 W_vd^T
  {  // dh += dsg w_sg^T (w_sg [32, 1])
    Gemm g = batched(m[kDsg], weights(prm, cn::sg_w, 1), m[kDxv], N, W, 1);
    CN_TRY((launch_gemm<W, kNT, kAccumulate>(g, s, C)));
  }
  CN_TRY(input_grad(m[kDxv], prm, cn::en_w, W, W, m[kDa3], &m[kR3], nullptr,
                    N, C, s));  // da3
  CN_TRY(input_grad(m[kDa3], prm, cn::s1_w, W, W, dz2, &m[kR2], &m[kDa2], N,
                    C, s));  // dg2, da2
  CN_TRY(input_grad(m[kDa2], prm, cn::c_w, W, W, dz1, &m[kR1], &m[kDa1], N,
                    C, s));  // dg1, da1 (W_c's first 32 rows)
  CN_TRY(input_grad(m[kDa2], prm, cn::c_w + W * W, W, kE1, m[kDemb1],
                    nullptr, nullptr, N, C, s));  // demb1 (its other 87)
  CN_TRY(input_grad(m[kDa1], prm, cn::s0_w, W, W, dz0, &m[kR0], &m[kDa0], N,
                    C, s));  // dg0, da0
  {  // demb1 += da0 W_e^T
    Gemm g = batched(m[kDa0], weights(prm, cn::e_w, W), m[kDemb1], N, kE1, W);
    CN_TRY((launch_gemm<W, kNT, kAccumulate>(g, s, C)));
  }
  embed_bwd_rows<<<rows_grid, 128, 0, s>>>(B, w, dpts, N, inv_scale);
  CN_TRY(static_cast<int>(cudaGetLastError()));
  // the parameter gradients: per-chunk partials, then reduce_tiles
  wgrad_kernel<<<dim3(kWgradJobs, kChunks, C), kThreads, 0, s>>>(w, partial,
                                                                 N, rows);
  CN_TRY(static_cast<int>(cudaGetLastError()));
  narrow_kernel<<<dim3(kNarrowJobs, kChunks, C), 64, 0, s>>>(
      pts, w, partial, N, rows, inv_scale);
  CN_TRY(static_cast<int>(cudaGetLastError()));
  return launch_reduce(partial, grads, C, kChunks, cn::PP, s);
}

}  // extern "C"

#undef CN_TRY
