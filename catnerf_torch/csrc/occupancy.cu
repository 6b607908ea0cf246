// The OccupancyMap background, forward and backward, for Hopper (sm_90a),
// float32 throughout, as chains of tiled GEMMs (gemm_f32.cuh) and row
// kernels.
//
// Replaces the Pallas TPU kernels of catnerf_tpu/experimental/fused_field.py
//   oc_fwd <- _occ_fwd_kernel (:435, _make_occ_fused.fwd_call :568): the PE
//             and the seven layers, [alpha x10 | sigmoid rgb] [N,4];
//   oc_bwd <- _occ_bwd_kernel (:445, _make_occ_fused.f_bwd :596): recompute
//             the forward, then the hand-derived backward: dpts [N,3], the
//             basis gradient dB [21,3] and dW/db of the seven layers.
//
// What bounds them on an H100 is the operations: 93,696 multiply-adds a
// row forward, 3 x that backward (forward recompute, input gradients,
// weight gradients), ~9.4 GFLOP at 16,800 rows, against 377 KB of weights.
// Nearly all of it is five products of [rows, 87..215] by [87..215, 128]
// (forward), their five transposes and five weight-gradient products
// (backward), so:
//   * the GEMM block at its 128 x 128 tile (256 threads, an 8 x 8 register
//     tile each); leading dimensions are parameters, so the concatenated
//     layer inputs [r1 | emb1] and [r3 | emb2] need no copies;
//   * NN bias + ReLU for the forward layers; NT with the mask epilogue
//     (D [r > 0], the first after a rank-1 term u v^T) for the input
//     gradients; TN over kChunks row chunks for the weight gradients;
//   * the narrow parts (the PE and its backward, the sigmoid head, the
//     oa/oc layers, the bias and basis gradients) are row or column
//     kernels.
// Every sum runs in a fixed order and no atomics are used: the weight
// gradients are per-chunk partials that reduce_tiles adds in order, so two
// runs are bitwise equal. The activations and deltas live in a workspace
// the caller allocates (rows rounded up to 4; kWsCols floats a row for the
// backward, the first kFwdSlots buffers, kFwdWsCols floats, for the
// forward).
//
// oc_fwd and oc_bwd launch everything on the caller's stream, allocate
// nothing and return the first non-zero cudaGetLastError(); oc_gemm
// launches the GEMM block alone.

#include "field_common.cuh"
#include "gemm_f32.cuh"

namespace {

constexpr int kThreads = GemmShape<128>::kThreads;
constexpr int kChunks = 32;  // row chunks of the weight gradients (partials)

// ---------------------------------------------------------------------------
// The backward's workspace and its row kernels
// ---------------------------------------------------------------------------

constexpr int H = oc::H;
constexpr int kC = H + kE1;   // 215: [r1 | emb1], the cat layer's input
constexpr int kCl = H + kE2;  // 170: [r3 | emb2], the colour layer's input

// Every buffer [Np, cols] row-major, Np = N rounded up to 4 (so each
// buffer starts 16-byte aligned).
struct Buffers {
  float* xc;      // [r1 | emb1]; emb1 alone is xc + H at stride kC
  float* xcl;     // [r3 | emb2]
  float* r0;      // [N, H]
  float* r2;
  float* r4;
  float* d4;      // delta of the colour layer's output
  float* dcl;     // [delta3 | demb2]
  float* d2;
  float* dc;      // [delta1 | demb1]
  float* d0;
  float* proj;    // proj, then dproj [N, 21]
  float* da5;     // [N, 3]
  float* dalpha;  // [N]
};

constexpr int kWsCols = kC + kCl + 3 * H + H + kCl + H + kC + H + kDirs + 3 + 1;
static_assert(kWsCols == 1563, "workspace");
constexpr int kFwdSlots = 5;  // xc, xcl, r0, r2, r4
constexpr int kFwdWsCols = kC + kCl + 3 * H;
static_assert(kFwdWsCols == 769, "forward workspace");

// The first `slots` buffers of the workspace; the others are null.
Buffers carve(float* ws, int Np, int slots = 13) {
  Buffers w;
  float** ptrs[] = {&w.xc, &w.xcl, &w.r0, &w.r2, &w.r4, &w.d4, &w.dcl,
                    &w.d2, &w.dc, &w.d0, &w.proj, &w.da5, &w.dalpha};
  const int cols[] = {kC, kCl, H, H, H, H, kCl, H, kC, H, kDirs, 3, 1};
  size_t off = 0;
  for (int i = 0; i < 13; ++i) {
    *ptrs[i] = i < slots ? ws + off : nullptr;
    off += static_cast<size_t>(Np) * cols[i];
  }
  return w;
}

// One thread a row: the PE (embed) into the tails of xc and xcl, and proj
// (when the workspace has it: the backward's).
__global__ void embed_rows(const float* __restrict__ pts,
                           const float* __restrict__ B, Buffers w, int N,
                           float inv_scale) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t r = row;
  float p[3], t[3], proj[kDirs];
  load_row<3>(pts + r * 3, true, p);
  embed(p, B, inv_scale, t, proj, w.xc + r * kC + H, w.xcl + r * kCl + H);
  if (w.proj != nullptr)
    for (int k = 0; k < kDirs; ++k) w.proj[r * kDirs + k] = proj[k];
}

// The forward's head, one warp a row: alpha = 10 (r3 w_oa + b_oa), r3 the
// first H columns of xcl (lane l on columns l + 32q: the rows are 170
// floats, not 16-byte aligned), and rgb = sigmoid(r4 W_oc + b_oc) (lane l
// on columns 4l..4l+3); each sum a fixed butterfly, so every lane holds
// the same bits, and lane 0 writes out [N, 4].
__global__ void __launch_bounds__(256)
    fwd_head_rows(const float* __restrict__ prm, Buffers w,
                  float* __restrict__ out, int N) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;  // the whole warp
  const size_t r = row;
  const float* Woc = prm + oc::oc_w;  // [H, 3]
  const float* x3 = w.xcl + r * kCl;
  float al = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    al = fmaf(x3[lane + 32 * q], prm[oc::oa_w + lane + 32 * q], al);
  const float4 x4 = reinterpret_cast<const float4*>(w.r4 + r * H)[lane];
  const float x[4] = {x4.x, x4.y, x4.z, x4.w};
  float a[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[j] = fmaf(x[q], Woc[(lane * 4 + q) * 3 + j], a[j]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    al += __shfl_xor_sync(0xffffffffu, al, off);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
  }
  if (lane == 0)
    reinterpret_cast<float4*>(out)[r] =
        make_float4((al + prm[oc::oa_b]) * 10.f,
                    sigmoidf(a[0] + prm[oc::oc_b]),
                    sigmoidf(a[1] + prm[oc::oc_b + 1]),
                    sigmoidf(a[2] + prm[oc::oc_b + 2]));
}

// One warp a row, lane l on columns 4l..4l+3: a5 = r4 W_oc + b (a fixed
// butterfly, so every lane holds the same sum), da5 = dout[1:4] s(1 - s),
// dalpha = 10 dout[0], delta4 = (da5 W_oc^T) [r4 > 0].
__global__ void __launch_bounds__(256)
    head_rows(const float* __restrict__ prm, const float* __restrict__ dout,
              Buffers w, int N) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;  // the whole warp
  const size_t r = row;
  const float* Woc = prm + oc::oc_w;  // [H, 3]
  const float4 x4 = reinterpret_cast<const float4*>(w.r4 + r * H)[lane];
  const float x[4] = {x4.x, x4.y, x4.z, x4.w};
  float a[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[j] = fmaf(x[q], Woc[(lane * 4 + q) * 3 + j], a[j]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
  float dd[4];
  load_row<4>(dout + r * 4, true, dd);
  float da5[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float col = sigmoidf(a[j] + prm[oc::oc_b + j]);
    da5[j] = dd[1 + j] * col * (1.f - col);
  }
  float d[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* wr = Woc + (lane * 4 + q) * 3;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) s = fmaf(da5[j], wr[j], s);
    d[q] = x[q] > 0.f ? s : 0.f;
  }
  reinterpret_cast<float4*>(w.d4 + r * H)[lane] =
      make_float4(d[0], d[1], d[2], d[3]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) w.da5[r * 3 + j] = da5[j];
    w.dalpha[r] = dd[0] * 10.f;
  }
}

// One thread a row: embed_bwd from demb1 (dc tail) and demb2 (dcl tail);
// dproj replaces proj, dpts = dt * inv_scale.
__global__ void embed_bwd_rows(const float* __restrict__ B, Buffers w,
                               float* __restrict__ dpts, int N,
                               float inv_scale) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t r = row;
  float proj[kDirs], dproj[kDirs], dt[3];
  for (int k = 0; k < kDirs; ++k) proj[k] = w.proj[r * kDirs + k];
  embed_bwd(w.dc + r * kC + H, w.dcl + r * kCl + H, proj, B, dproj, dt);
  for (int k = 0; k < kDirs; ++k) w.proj[r * kDirs + k] = dproj[k];
#pragma unroll
  for (int j = 0; j < 3; ++j) dpts[r * 3 + j] = dt[j] * inv_scale;
}

// The weight gradients of the five wide layers, grouped: blockIdx.x picks
// (layer, row tile of dW) among 7, blockIdx.y the row chunk s; the block
// writes X[r0:r1]^T D[r0:r1] into partial[s] at the layer's offset.
__global__ void __launch_bounds__(kThreads, 2)
    wgrad_kernel(Buffers w, float* __restrict__ partial, int N, int rows) {
  const int s = blockIdx.y;
  int r0, r1;
  chunk_rows(N, rows, s, r0, r1);
  const float* x;
  const float* d;
  int ldx, ldd, m, off, m0 = 0;
  switch (blockIdx.x) {
    case 0: x = w.xc + H; ldx = kC; m = kE1; d = w.d0; ldd = H;
            off = oc::in_w; break;
    case 1: x = w.r0; ldx = H; m = H; d = w.dc; ldd = kC;
            off = oc::m1_w; break;
    case 2:
    case 3: x = w.xc; ldx = kC; m = kC; d = w.d2; ldd = H; off = oc::c_w;
            m0 = (blockIdx.x - 2) * kBM; break;
    case 4: x = w.r2; ldx = H; m = H; d = w.dcl; ldd = kCl;
            off = oc::m2_w; break;
    default: x = w.xcl; ldx = kCl; m = kCl; d = w.d4; ldd = H;
             off = oc::cl_w; m0 = (blockIdx.x - 5) * kBM; break;
  }
  const Gemm g = make_gemm(x + static_cast<size_t>(r0) * ldx, ldx,
                           d + static_cast<size_t>(r0) * ldd, ldd,
                           partial + static_cast<size_t>(s) * oc::PP + off,
                           H, m, H, r1 - r0);
  gemm_tile<H, kTN, kMask>(g, m0, 0);  // no mask: a plain store
}
constexpr int kWgradTiles = 7;

// The narrow gradients of chunk s (blockIdx.y), one job a block
// (blockIdx.x), thread c on column c, the chunk's rows in order:
// jobs 0-4 the biases of in, m1, c, m2, cl (column sums of their deltas),
// 5 the alpha layer (r3 dalpha, sum dalpha), 6 the colour head (r4 da5,
// sum da5), 7 dB = dproj^T t.
__global__ void __launch_bounds__(H)
    narrow_kernel(const float* __restrict__ pts, Buffers w,
                  float* __restrict__ partial, int N, int rows,
                  float inv_scale) {
  const int job = blockIdx.x;
  const int s = blockIdx.y;
  const int c = threadIdx.x;
  int r0, r1;
  chunk_rows(N, rows, s, r0, r1);
  float* part = partial + static_cast<size_t>(s) * oc::PP;
  if (job < 5) {
    const float* d;
    int ld, off;
    switch (job) {
      case 0: d = w.d0; ld = H; off = oc::in_b; break;
      case 1: d = w.dc; ld = kC; off = oc::m1_b; break;
      case 2: d = w.d2; ld = H; off = oc::c_b; break;
      case 3: d = w.dcl; ld = kCl; off = oc::m2_b; break;
      default: d = w.d4; ld = H; off = oc::cl_b; break;
    }
    float acc = 0.f;
    for (int r = r0; r < r1; ++r) acc += d[static_cast<size_t>(r) * ld + c];
    part[off + c] = acc;
  } else if (job == 5) {
    float acc = 0.f, sum = 0.f;
    for (int r = r0; r < r1; ++r) {
      const float da = w.dalpha[r];
      acc = fmaf(w.xcl[static_cast<size_t>(r) * kCl + c], da, acc);
      sum += da;
    }
    part[oc::oa_w + c] = acc;
    if (c == 0) part[oc::oa_b] = sum;
  } else if (job == 6) {
    float acc[3] = {0.f, 0.f, 0.f}, sum[3] = {0.f, 0.f, 0.f};
    for (int r = r0; r < r1; ++r) {
      const float x = w.r4[static_cast<size_t>(r) * H + c];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float da = w.da5[static_cast<size_t>(r) * 3 + j];
        acc[j] = fmaf(x, da, acc[j]);
        sum[j] += da;
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) part[oc::oc_w + c * 3 + j] = acc[j];
    if (c == 0)
#pragma unroll
      for (int j = 0; j < 3; ++j) part[oc::oc_b + j] = sum[j];
  } else if (c < kBSize) {
    const int k = c / 3;
    const int j = c % 3;
    float acc = 0.f;
    for (int r = r0; r < r1; ++r)
      acc = fmaf(w.proj[static_cast<size_t>(r) * kDirs + k],
                 pts[static_cast<size_t>(r) * 3 + j] * inv_scale, acc);
    part[oc::P + c] = acc;
  }
}
constexpr int kNarrowJobs = 8;

// relu(X W + b): X [N, K] at stride ldx, W [K, H], C [N, H] at stride ldc
int forward_layer(const float* X, int ldx, int K, const float* W,
                  const float* b, float* C, int ldc, int N, cudaStream_t s) {
  Gemm g = make_gemm(X, ldx, W, H, C, ldc, N, H, K);
  g.bias = b;
  return launch_gemm<H, kNN, kBiasRelu>(g, s);
}

// (D W^T + u v^T) [mask > 0] on the first H columns, W [n, H] ([in, out]),
// the other n - H columns as they are: D [N, H] at ldd, C [N, n] at ldc
int input_grad(const float* D, int ldd, const float* W, int n, float* C,
               int ldc, const float* mask, int ldm, const float* u,
               const float* v, int N, cudaStream_t s) {
  Gemm g = make_gemm(D, ldd, W, H, C, ldc, N, n, H);
  g.mask = mask;
  g.ldm = ldm;
  g.mask_cols = H;
  g.u = u;
  g.v = v;
  return launch_gemm<H, kNT, kMask>(g, s);
}

#define OC_TRY(call)       \
  if ((e = (call)) != 0) { \
    return e;              \
  }

// The PE and the five wide layers (_occ_chain :409) into the workspace's
// first five buffers: xc = [r1 | emb1], xcl = [r3 | emb2], r0, r2, r4.
int forward_chain(const float* pts, const float* prm, const float* B,
                  const Buffers& w, int N, float inv_scale, cudaStream_t s) {
  int e;
  embed_rows<<<(N + 127) / 128, 128, 0, s>>>(pts, B, w, N, inv_scale);
  OC_TRY(static_cast<int>(cudaGetLastError()));
  OC_TRY(forward_layer(w.xc + H, kC, kE1, prm + oc::in_w, prm + oc::in_b,
                       w.r0, H, N, s));
  OC_TRY(forward_layer(w.r0, H, H, prm + oc::m1_w, prm + oc::m1_b, w.xc, kC,
                       N, s));
  OC_TRY(forward_layer(w.xc, kC, kC, prm + oc::c_w, prm + oc::c_b, w.r2, H,
                       N, s));
  OC_TRY(forward_layer(w.r2, H, H, prm + oc::m2_w, prm + oc::m2_b, w.xcl,
                       kCl, N, s));
  return forward_layer(w.xcl, kCl, kCl, prm + oc::cl_w, prm + oc::cl_b, w.r4,
                       H, N, s);
}

}  // namespace

extern "C" {

// [OccupancyMap P, partial row, row chunks, workspace floats a row of the
// backward, of the forward]
int occupancy_layout(int* out) {
  out[0] = oc::P;
  out[1] = oc::PP;
  out[2] = kChunks;
  out[3] = kWsCols;
  out[4] = kFwdWsCols;
  return 0;
}

// The GEMM block alone (layout: 0 NN, 1 NT, 2 TN; epilogue: 0 bias + ReLU,
// 1 mask, 2 accumulate), with the arguments of struct Gemm above.
int oc_gemm(int layout, int epilogue, const float* A, int lda, const float* B,
            int ldb, float* C, int ldc, int M, int N, int K,
            const float* bias, const float* mask, int ldm, int mask_cols,
            const float* u, const float* v, void* stream) {
  Gemm g = make_gemm(A, lda, B, ldb, C, ldc, M, N, K);
  g.bias = bias;
  g.mask = mask;
  g.ldm = ldm;
  g.mask_cols = mask_cols;
  g.u = u;
  g.v = v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout * 3 + epilogue) {
    case 0: return launch_gemm<H, kNN, kBiasRelu>(g, s);
    case 1: return launch_gemm<H, kNN, kMask>(g, s);
    case 2: return launch_gemm<H, kNN, kAccumulate>(g, s);
    case 3: return launch_gemm<H, kNT, kBiasRelu>(g, s);
    case 4: return launch_gemm<H, kNT, kMask>(g, s);
    case 5: return launch_gemm<H, kNT, kAccumulate>(g, s);
    case 6: return launch_gemm<H, kTN, kBiasRelu>(g, s);
    case 7: return launch_gemm<H, kTN, kMask>(g, s);
    case 8: return launch_gemm<H, kTN, kAccumulate>(g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// pts [N,3], params [P], B [21,3] -> out [N,4]; workspace
// [ceil4(N) * kFwdWsCols]
int oc_fwd(const float* pts, const float* params, const float* B, float* out,
           float* workspace, int N, float inv_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Buffers w = carve(workspace, (N + 3) / 4 * 4, kFwdSlots);
  int e;
  OC_TRY(forward_chain(pts, params, B, w, N, inv_scale, s));
  fwd_head_rows<<<(N + 7) / 8, 256, 0, s>>>(params, w, out, N);
  return static_cast<int>(cudaGetLastError());
}

// pts [N,3], params [P], B [21,3], dout [N,4] -> dpts [N,3], grads [P + 63]
// (via partial [kChunks, P + 63]); workspace [ceil4(N) * kWsCols]
int oc_bwd(const float* pts, const float* params, const float* B,
           const float* dout, float* dpts, float* partial, float* grads,
           float* workspace, int N, float inv_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* prm = params;
  const Buffers w = carve(workspace, (N + 3) / 4 * 4);
  const int rows = (N + kChunks - 1) / kChunks;
  int e;
  OC_TRY(forward_chain(pts, prm, B, w, N, inv_scale, s));  // the recompute
  head_rows<<<(N + 7) / 8, 256, 0, s>>>(prm, dout, w, N);
  OC_TRY(static_cast<int>(cudaGetLastError()));
  // the input gradients, output to input; ReLU(a) > 0 exactly when a > 0,
  // so the stored activation is the mask
  OC_TRY(input_grad(w.d4, H, prm + oc::cl_w, kCl, w.dcl, kCl, w.xcl, kCl,
                    w.dalpha, prm + oc::oa_w, N, s));  // [delta3 | demb2]
  OC_TRY(input_grad(w.dcl, kCl, prm + oc::m2_w, H, w.d2, H, w.r2, H, nullptr,
                    nullptr, N, s));                    // delta2
  OC_TRY(input_grad(w.d2, H, prm + oc::c_w, kC, w.dc, kC, w.xc, kC, nullptr,
                    nullptr, N, s));                    // [delta1 | demb1]
  OC_TRY(input_grad(w.dc, kC, prm + oc::m1_w, H, w.d0, H, w.r0, H, nullptr,
                    nullptr, N, s));                    // delta0
  Gemm g = make_gemm(w.d0, H, prm + oc::in_w, H, w.dc + H, kC, N, kE1, H);
  OC_TRY((launch_gemm<H, kNT, kAccumulate>(g, s)));  // demb1 += delta0 W_in^T
  embed_bwd_rows<<<(N + 127) / 128, 128, 0, s>>>(B, w, dpts, N, inv_scale);
  OC_TRY(static_cast<int>(cudaGetLastError()));
  // the parameter gradients: per-chunk partials, then reduce_tiles
  wgrad_kernel<<<dim3(kWgradTiles, kChunks), kThreads, 0, s>>>(w, partial, N,
                                                               rows);
  OC_TRY(static_cast<int>(cudaGetLastError()));
  narrow_kernel<<<dim3(kNarrowJobs, kChunks), H, 0, s>>>(pts, w, partial, N,
                                                         rows, inv_scale);
  OC_TRY(static_cast<int>(cudaGetLastError()));
  return launch_reduce(partial, grads, 1, kChunks, oc::PP, s);
}

}  // extern "C"

#undef OC_TRY
