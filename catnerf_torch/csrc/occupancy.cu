// The OccupancyMap background, forward and backward, for Hopper (sm_90a),
// float32 throughout, as chains of tiled GEMMs (gemm_f32.cuh) and row
// kernels, instantiated at hidden width H = 32, 64, 128 or 256 (the
// Python wrapper runs any other width up to 256 through the next one, its
// extra units' weights and biases zero). A width past 256 (a multiple of
// 32, padded so by the wrapper) runs on Occ<0>: the same kernels with the
// width a run-time value, whose row kernels loop over a lane's columns and
// whose column kernel loops each thread over the columns of a
// 1,024-thread block. No width an instantiation takes reaches those loops.
//
// Replaces the Pallas TPU kernels of catnerf_tpu/experimental/fused_field.py
//   oc_fwd <- _occ_fwd_kernel (:435, _make_occ_fused.fwd_call :568): the PE
//             and the seven layers, [alpha x10 | sigmoid rgb] [N,4];
//   oc_bwd <- _occ_bwd_kernel (:445, _make_occ_fused.f_bwd :596): recompute
//             the forward, then the hand-derived backward: dpts [N,3], the
//             basis gradient dB [21,3] and dW/db of the seven layers.
//
// What bounds them on an H100 is the operations: at H = 128, 93,696
// multiply-adds a row forward, 3 x that backward (forward recompute, input
// gradients, weight gradients), ~9.4 GFLOP at 16,800 rows, against 377 KB
// of weights. Nearly all of it is five products of [rows, 87..H+87] by
// [87..H+87, H] (forward), their five transposes and five weight-gradient
// products (backward), so:
//   * the GEMM block at its 128 x 128 tile (256 threads, an 8 x 8 register
//     tile each), or at H = 32 its 128 x 32 tile (128 threads); leading
//     dimensions are parameters, so the concatenated layer inputs
//     [r1 | emb1] and [r3 | emb2] need no copies;
//   * NN bias + ReLU for the forward layers; NT with the mask epilogue
//     (D [r > 0], the first after a rank-1 term u v^T) for the input
//     gradients; TN over kChunks row chunks for the weight gradients;
//   * the narrow parts (the PE and its backward, the sigmoid head, the
//     oa/oc layers, the bias and basis gradients) are row or column
//     kernels.
// Every sum runs in a fixed order and no atomics are used: the weight
// gradients are per-chunk partials that reduce_tiles adds in order, so two
// runs are bitwise equal. The activations and deltas live in a workspace
// the caller allocates (rows rounded up to 4; Dims::ws_cols floats a row
// for the backward, the first kFwdSlots buffers, Dims::fwd_ws_cols floats,
// for the forward).
//
// oc_fwd and oc_bwd launch everything on the caller's stream, allocate
// nothing and return the first non-zero cudaGetLastError() (or
// cudaErrorInvalidValue for a width neither instantiated nor past 256 and a
// multiple of 32); oc_gemm launches the 128-wide GEMM block alone.

#include "field_common.cuh"
#include "gemm_f32.cuh"

namespace {

constexpr int kChunks = 32;  // row chunks of the weight gradients (partials)

constexpr int kMaxInst = 256;  // the widest instantiation

// The widths of a chain at hidden width H: its concatenated layer inputs,
// the offsets of OcLayout<H> (the flat parameters) and its workspace.
struct Dims {
  int H;
  int kPer;  // a head lane's columns
  int kC;    // [r1 | emb1], the cat layer's input
  int kCl;   // [r3 | emb2], the colour layer's
  int in_w, m1_w, c_w, m2_w, oa_w, cl_w, oc_w;
  int in_b, m1_b, c_b, m2_b, oa_b, cl_b, oc_b;
  int P, PP;
  int ws_cols, fwd_ws_cols;
};

__host__ __device__ constexpr Dims make_dims(int H) {
  Dims d{};
  d.H = H;
  d.kPer = H / 32;
  d.kC = H + kE1;
  d.kCl = H + kE2;
  d.in_w = 0;
  d.m1_w = d.in_w + kE1 * H;
  d.c_w = d.m1_w + H * H;
  d.m2_w = d.c_w + (H + kE1) * H;
  d.oa_w = d.m2_w + H * H;
  d.cl_w = d.oa_w + H;
  d.oc_w = d.cl_w + (H + kE2) * H;
  d.in_b = d.oc_w + H * 3;
  d.m1_b = d.in_b + H;
  d.c_b = d.m1_b + H;
  d.m2_b = d.c_b + H;
  d.oa_b = d.m2_b + H;
  d.cl_b = d.oa_b + 1;
  d.oc_b = d.cl_b + H;
  d.P = d.oc_b + 3;
  d.PP = d.P + kBSize;
  d.ws_cols = d.kC + d.kCl + 3 * H + H + d.kCl + H + d.kC + H + kDirs + 3 + 1;
  d.fwd_ws_cols = d.kC + d.kCl + 3 * H;
  return d;
}
static_assert(make_dims(128).P == OcLayout<128>::P &&
                  make_dims(256).PP == OcLayout<256>::PP &&
                  make_dims(512).oc_b == OcLayout<512>::oc_b,
              "layout");
static_assert(make_dims(128).ws_cols == 1563, "workspace");
static_assert(make_dims(128).fwd_ws_cols == 769, "forward workspace");

// An instantiation's widths, every one a constant (H > 0), or the run-time
// width's (H = 0).
template <int H>
__host__ __device__ __forceinline__ Dims dims_of(const Dims& rt) {
  if constexpr (H > 0) {
    constexpr Dims d = make_dims(H);
    return d;
  } else {
    return rt;
  }
}

// The launch shapes of an instantiation (H = 0: any width past kMaxInst).
template <int H>
struct Occ {
  static_assert(H % 32 == 0 && H <= kMaxInst, "hidden width");
  static constexpr int BN = H == 32 ? 32 : 128;  // the GEMM tile's width
  static constexpr int kThreads = GemmShape<BN>::kThreads;
  // the narrow kernel's block: a thread a column, at least the 63 of dB;
  // past the instantiations 1,024 threads, each looping over its columns
  static constexpr int kNarrowThreads = H == 0 ? 1024 : H < 64 ? 64 : H;
};
constexpr int kFwdSlots = 5;  // xc, xcl, r0, r2, r4

// ---------------------------------------------------------------------------
// The backward's workspace and its row kernels
// ---------------------------------------------------------------------------

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

// The first `slots` buffers of the workspace; the others are null.
Buffers carve(const Dims& d, float* ws, int Np, int slots = 13) {
  const int H = d.H;
  Buffers w;
  float** ptrs[] = {&w.xc, &w.xcl, &w.r0, &w.r2, &w.r4, &w.d4, &w.dcl,
                    &w.d2, &w.dc, &w.d0, &w.proj, &w.da5, &w.dalpha};
  const int cols[] = {d.kC, d.kCl, H, H, H, H, d.kCl, H, d.kC, H, kDirs,
                      3, 1};
  size_t off = 0;
  for (int i = 0; i < 13; ++i) {
    *ptrs[i] = i < slots ? ws + off : nullptr;
    off += static_cast<size_t>(Np) * cols[i];
  }
  return w;
}

// Columns lane * K .. lane * K + K - 1 of a row (float4 loads and stores
// where K allows).
template <int K>
__device__ __forceinline__ void load_cols(const float* row, int lane,
                                          float* x) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(row)[lane * (K / 4) +
                                                            q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) x[q] = row[lane * K + q];
  }
}

template <int K>
__device__ __forceinline__ void store_cols(float* row, int lane,
                                           const float* x) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      reinterpret_cast<float4*>(row)[lane * (K / 4) + q] = make_float4(
          x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) row[lane * K + q] = x[q];
  }
}

// One thread a row: the PE (embed) into the tails of xc and xcl, and proj
// (when the workspace has it: the backward's).
template <int H>
__global__ void embed_rows(const float* __restrict__ pts,
                           const float* __restrict__ B, Buffers w, int N,
                           float inv_scale, Dims rt) {
  const Dims d = dims_of<H>(rt);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t r = row;
  float p[3], t[3], proj[kDirs];
  load_row<3>(pts + r * 3, true, p);
  embed(p, B, inv_scale, t, proj, w.xc + r * d.kC + d.H,
        w.xcl + r * d.kCl + d.H);
  if (w.proj != nullptr)
    for (int k = 0; k < kDirs; ++k) w.proj[r * kDirs + k] = proj[k];
}

// The forward's head, one warp a row: alpha = 10 (r3 w_oa + b_oa), r3 the
// first H columns of xcl (lane l on columns l + 32q: the rows are H + 42
// floats, not 16-byte aligned), and rgb = sigmoid(r4 W_oc + b_oc) (lane l
// on columns kPer l .. kPer l + kPer - 1); each sum a fixed butterfly, so
// every lane holds the same bits, and lane 0 writes out [N, 4]. Past the
// instantiations (H = 0) a lane reads its columns one at a time, in the
// same order.
template <int H>
__global__ void __launch_bounds__(256)
    fwd_head_rows(const float* __restrict__ prm, Buffers w,
                  float* __restrict__ out, int N, Dims rt) {
  const Dims d = dims_of<H>(rt);
  const int K = d.kPer;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;  // the whole warp
  const size_t r = row;
  const float* Woc = prm + d.oc_w;  // [H, 3]
  const float* x3 = w.xcl + r * d.kCl;
  float al = 0.f;
#pragma unroll
  for (int q = 0; q < K; ++q)
    al = fmaf(x3[lane + 32 * q], prm[d.oa_w + lane + 32 * q], al);
  float a[3] = {0.f, 0.f, 0.f};
  if constexpr (H > 0) {
    float x[H / 32];
    load_cols<H / 32>(w.r4 + r * H, lane, x);
#pragma unroll
    for (int q = 0; q < K; ++q)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        a[j] = fmaf(x[q], Woc[(lane * K + q) * 3 + j], a[j]);
  } else {
    const float* x = w.r4 + r * d.H + lane * K;
    for (int q = 0; q < K; ++q)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        a[j] = fmaf(x[q], Woc[(lane * K + q) * 3 + j], a[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    al += __shfl_xor_sync(0xffffffffu, al, off);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
  }
  if (lane == 0)
    reinterpret_cast<float4*>(out)[r] =
        make_float4((al + prm[d.oa_b]) * 10.f,
                    sigmoidf(a[0] + prm[d.oc_b]),
                    sigmoidf(a[1] + prm[d.oc_b + 1]),
                    sigmoidf(a[2] + prm[d.oc_b + 2]));
}

// One warp a row, lane l on columns kPer l .. kPer l + kPer - 1: a5 = r4
// W_oc + b (a fixed butterfly, so every lane holds the same sum), da5 =
// dout[1:4] s(1 - s), dalpha = 10 dout[0], delta4 = (da5 W_oc^T) [r4 > 0].
// Past the instantiations (H = 0) a lane reads its columns one at a time,
// twice, in the same order.
template <int H>
__global__ void __launch_bounds__(256)
    head_rows(const float* __restrict__ prm, const float* __restrict__ dout,
              Buffers w, int N, Dims rt) {
  const Dims d = dims_of<H>(rt);
  const int K = d.kPer;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= N) return;  // the whole warp
  const size_t r = row;
  const float* Woc = prm + d.oc_w;  // [H, 3]
  float x[H > 0 ? H / 32 : 1];
  const float* xr = w.r4 + r * d.H + lane * K;
  if constexpr (H > 0) load_cols<H / 32>(w.r4 + r * H, lane, x);
  float a[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < K; ++q)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[j] = fmaf(H > 0 ? x[q] : xr[q], Woc[(lane * K + q) * 3 + j], a[j]);
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
    const float col = sigmoidf(a[j] + prm[d.oc_b + j]);
    da5[j] = dd[1 + j] * col * (1.f - col);
  }
  float dl[H > 0 ? H / 32 : 1];
  float* d4 = w.d4 + r * d.H + lane * K;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const float* wr = Woc + (lane * K + q) * 3;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) s = fmaf(da5[j], wr[j], s);
    if constexpr (H > 0)
      dl[q] = x[q] > 0.f ? s : 0.f;
    else
      d4[q] = xr[q] > 0.f ? s : 0.f;
  }
  if constexpr (H > 0) store_cols<H / 32>(w.d4 + r * H, lane, dl);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) w.da5[r * 3 + j] = da5[j];
    w.dalpha[r] = dd[0] * 10.f;
  }
}

// One thread a row: embed_bwd from demb1 (dc tail) and demb2 (dcl tail);
// dproj replaces proj, dpts = dt * inv_scale.
template <int H>
__global__ void embed_bwd_rows(const float* __restrict__ B, Buffers w,
                               float* __restrict__ dpts, int N,
                               float inv_scale, Dims rt) {
  const Dims d = dims_of<H>(rt);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t r = row;
  float proj[kDirs], dproj[kDirs], dt[3];
  for (int k = 0; k < kDirs; ++k) proj[k] = w.proj[r * kDirs + k];
  embed_bwd(w.dc + r * d.kC + d.H, w.dcl + r * d.kCl + d.H, proj, B, dproj,
            dt);
  for (int k = 0; k < kDirs; ++k) w.proj[r * kDirs + k] = dproj[k];
#pragma unroll
  for (int j = 0; j < 3; ++j) dpts[r * 3 + j] = dt[j] * inv_scale;
}

// The weight gradients of the five wide layers, grouped: blockIdx.x picks
// (layer, row tile of dW, column tile of dW) among wgrad_jobs<H>(),
// blockIdx.y the row chunk s; the block writes X[r0:r1]^T D[r0:r1] into
// partial[s] at the layer's offset. Layers in, m1, c, m2, cl; dW [m, H]
// with m = 87, H, H + 87, H, H + 42.
__host__ __device__ constexpr int wgrad_rows(int H, int layer) {
  return layer == 0 ? kE1 : layer == 2 ? H + kE1 : layer == 4 ? H + kE2 : H;
}

template <int BN>
__host__ __device__ constexpr int wgrad_col_tiles(int H) {
  return (H + BN - 1) / BN;
}

template <int BN>
__host__ __device__ constexpr int wgrad_jobs(int H) {
  int n = 0;
  for (int layer = 0; layer < 5; ++layer)
    n += (wgrad_rows(H, layer) + kBM - 1) / kBM * wgrad_col_tiles<BN>(H);
  return n;
}
static_assert(wgrad_jobs<128>(128) == 7, "wgrad jobs");

template <int H>
__global__ void __launch_bounds__(Occ<H>::kThreads, 2)
    wgrad_kernel(Buffers w, float* __restrict__ partial, int N, int rows,
                 Dims rt) {
  using O = Occ<H>;
  const Dims d = dims_of<H>(rt);
  const int kCols = wgrad_col_tiles<O::BN>(d.H);
  const int s = blockIdx.y;
  int r0, r1;
  chunk_rows(N, rows, s, r0, r1);
  int job = blockIdx.x;
  int layer = 0;
  for (; layer < 4; ++layer) {
    const int n = (wgrad_rows(d.H, layer) + kBM - 1) / kBM * kCols;
    if (job < n) break;
    job -= n;
  }
  const int m0 = job / kCols * kBM;
  const int n0 = job % kCols * O::BN;
  const int h = d.H;
  const float* x;
  const float* dl;
  int ldx, ldd, off;
  switch (layer) {
    case 0: x = w.xc + h; ldx = d.kC; dl = w.d0; ldd = h; off = d.in_w;
            break;
    case 1: x = w.r0; ldx = h; dl = w.dc; ldd = d.kC; off = d.m1_w; break;
    case 2: x = w.xc; ldx = d.kC; dl = w.d2; ldd = h; off = d.c_w; break;
    case 3: x = w.r2; ldx = h; dl = w.dcl; ldd = d.kCl; off = d.m2_w;
            break;
    default: x = w.xcl; ldx = d.kCl; dl = w.d4; ldd = h; off = d.cl_w;
             break;
  }
  const Gemm g = make_gemm(x + static_cast<size_t>(r0) * ldx, ldx,
                           dl + static_cast<size_t>(r0) * ldd, ldd,
                           partial + static_cast<size_t>(s) * d.PP + off,
                           h, wgrad_rows(h, layer), h, r1 - r0);
  gemm_tile<O::BN, kTN, kMask>(g, m0, n0);  // no mask: a plain store
}

// The narrow gradients of chunk s (blockIdx.y), one job a block
// (blockIdx.x), thread c on column c, the chunk's rows in order:
// jobs 0-4 the biases of in, m1, c, m2, cl (column sums of their deltas),
// 5 the alpha layer (r3 dalpha, sum dalpha), 6 the colour head (r4 da5,
// sum da5), 7 dB = dproj^T t. An instantiation's block has max(H, 64)
// threads: one column each, of H (jobs 0-6) or of dB's 63 (job 7); past
// the instantiations (H = 0) each of 1,024 threads loops over columns c,
// c + 1,024, ...
__device__ __forceinline__ void narrow_column(
    const Dims& d, int job, int c, const float* __restrict__ pts,
    const Buffers& w, float* __restrict__ part, int r0, int r1,
    float inv_scale) {
  if (job < 5) {
    const float* dl;
    int ld, off;
    switch (job) {
      case 0: dl = w.d0; ld = d.H; off = d.in_b; break;
      case 1: dl = w.dc; ld = d.kC; off = d.m1_b; break;
      case 2: dl = w.d2; ld = d.H; off = d.c_b; break;
      case 3: dl = w.dcl; ld = d.kCl; off = d.m2_b; break;
      default: dl = w.d4; ld = d.H; off = d.cl_b; break;
    }
    float acc = 0.f;
    for (int r = r0; r < r1; ++r) acc += dl[static_cast<size_t>(r) * ld + c];
    part[off + c] = acc;
  } else if (job == 5) {
    float acc = 0.f, sum = 0.f;
    for (int r = r0; r < r1; ++r) {
      const float da = w.dalpha[r];
      acc = fmaf(w.xcl[static_cast<size_t>(r) * d.kCl + c], da, acc);
      sum += da;
    }
    part[d.oa_w + c] = acc;
    if (c == 0) part[d.oa_b] = sum;
  } else if (job == 6) {
    float acc[3] = {0.f, 0.f, 0.f}, sum[3] = {0.f, 0.f, 0.f};
    for (int r = r0; r < r1; ++r) {
      const float x = w.r4[static_cast<size_t>(r) * d.H + c];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float da = w.da5[static_cast<size_t>(r) * 3 + j];
        acc[j] = fmaf(x, da, acc[j]);
        sum[j] += da;
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) part[d.oc_w + c * 3 + j] = acc[j];
    if (c == 0)
#pragma unroll
      for (int j = 0; j < 3; ++j) part[d.oc_b + j] = sum[j];
  } else if (c < kBSize) {
    const int k = c / 3;
    const int j = c % 3;
    float acc = 0.f;
    for (int r = r0; r < r1; ++r)
      acc = fmaf(w.proj[static_cast<size_t>(r) * kDirs + k],
                 pts[static_cast<size_t>(r) * 3 + j] * inv_scale, acc);
    part[d.P + c] = acc;
  }
}

template <int H>
__global__ void __launch_bounds__(Occ<H>::kNarrowThreads)
    narrow_kernel(const float* __restrict__ pts, Buffers w,
                  float* __restrict__ partial, int N, int rows,
                  float inv_scale, Dims rt) {
  using O = Occ<H>;
  const Dims d = dims_of<H>(rt);
  const int job = blockIdx.x;
  const int s = blockIdx.y;
  const int c = threadIdx.x;
  if constexpr (H > 0 && O::kNarrowThreads > H) {
    if (job < 7 && c >= H) return;
  }
  int r0, r1;
  chunk_rows(N, rows, s, r0, r1);
  float* part = partial + static_cast<size_t>(s) * d.PP;
  if constexpr (H > 0) {
    narrow_column(d, job, c, pts, w, part, r0, r1, inv_scale);
  } else {
    const int cols = job < 7 ? d.H : kBSize;
    for (int col = c; col < cols; col += O::kNarrowThreads)
      narrow_column(d, job, col, pts, w, part, r0, r1, inv_scale);
  }
}
constexpr int kNarrowJobs = 8;

// relu(X W + b): X [N, K] at stride ldx, W [K, H], C [N, H] at stride ldc
template <int H>
int forward_layer(const Dims& d, const float* X, int ldx, int K,
                  const float* W, const float* b, float* C, int ldc, int N,
                  cudaStream_t s) {
  Gemm g = make_gemm(X, ldx, W, d.H, C, ldc, N, d.H, K);
  g.bias = b;
  return launch_gemm<Occ<H>::BN, kNN, kBiasRelu>(g, s);
}

// (D W^T + u v^T) [mask > 0] on the first H columns, W [n, H] ([in, out]),
// the other n - H columns as they are: D [N, H] at ldd, C [N, n] at ldc
template <int H>
int input_grad(const Dims& d, const float* D, int ldd, const float* W, int n,
               float* C, int ldc, const float* mask, int ldm, const float* u,
               const float* v, int N, cudaStream_t s) {
  Gemm g = make_gemm(D, ldd, W, d.H, C, ldc, N, n, d.H);
  g.mask = mask;
  g.ldm = ldm;
  g.mask_cols = d.H;
  g.u = u;
  g.v = v;
  return launch_gemm<Occ<H>::BN, kNT, kMask>(g, s);
}

#define OC_TRY(call)       \
  if ((e = (call)) != 0) { \
    return e;              \
  }

// The PE and the five wide layers (_occ_chain :409) into the workspace's
// first five buffers: xc = [r1 | emb1], xcl = [r3 | emb2], r0, r2, r4.
template <int H>
int forward_chain(const Dims& d, const float* pts, const float* prm,
                  const float* B, const Buffers& w, int N, float inv_scale,
                  cudaStream_t s) {
  const int h = d.H;
  int e;
  embed_rows<H><<<(N + 127) / 128, 128, 0, s>>>(pts, B, w, N, inv_scale, d);
  OC_TRY(static_cast<int>(cudaGetLastError()));
  OC_TRY(forward_layer<H>(d, w.xc + h, d.kC, kE1, prm + d.in_w,
                          prm + d.in_b, w.r0, h, N, s));
  OC_TRY(forward_layer<H>(d, w.r0, h, h, prm + d.m1_w, prm + d.m1_b, w.xc,
                          d.kC, N, s));
  OC_TRY(forward_layer<H>(d, w.xc, d.kC, d.kC, prm + d.c_w, prm + d.c_b,
                          w.r2, h, N, s));
  OC_TRY(forward_layer<H>(d, w.r2, h, h, prm + d.m2_w, prm + d.m2_b, w.xcl,
                          d.kCl, N, s));
  return forward_layer<H>(d, w.xcl, d.kCl, d.kCl, prm + d.cl_w,
                          prm + d.cl_b, w.r4, h, N, s);
}

template <int H>
int run_fwd(const Dims& d, const float* pts, const float* params,
            const float* B, float* out, float* workspace, int N,
            float inv_scale, cudaStream_t s) {
  const Buffers w = carve(d, workspace, (N + 3) / 4 * 4, kFwdSlots);
  int e;
  OC_TRY(forward_chain<H>(d, pts, params, B, w, N, inv_scale, s));
  fwd_head_rows<H><<<(N + 7) / 8, 256, 0, s>>>(params, w, out, N, d);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int run_bwd(const Dims& d, const float* pts, const float* params,
            const float* B, const float* dout, float* dpts, float* partial,
            float* grads, float* workspace, int N, float inv_scale,
            cudaStream_t s) {
  using O = Occ<H>;
  const int h = d.H;
  const float* prm = params;
  const Buffers w = carve(d, workspace, (N + 3) / 4 * 4);
  const int rows = (N + kChunks - 1) / kChunks;
  int e;
  OC_TRY(forward_chain<H>(d, pts, prm, B, w, N, inv_scale, s));  // recompute
  head_rows<H><<<(N + 7) / 8, 256, 0, s>>>(prm, dout, w, N, d);
  OC_TRY(static_cast<int>(cudaGetLastError()));
  // the input gradients, output to input; ReLU(a) > 0 exactly when a > 0,
  // so the stored activation is the mask
  OC_TRY(input_grad<H>(d, w.d4, h, prm + d.cl_w, d.kCl, w.dcl, d.kCl, w.xcl,
                       d.kCl, w.dalpha, prm + d.oa_w, N,
                       s));  // [delta3 | demb2]
  OC_TRY(input_grad<H>(d, w.dcl, d.kCl, prm + d.m2_w, h, w.d2, h, w.r2, h,
                       nullptr, nullptr, N, s));  // delta2
  OC_TRY(input_grad<H>(d, w.d2, h, prm + d.c_w, d.kC, w.dc, d.kC, w.xc,
                       d.kC, nullptr, nullptr, N, s));  // [delta1 | demb1]
  OC_TRY(input_grad<H>(d, w.dc, d.kC, prm + d.m1_w, h, w.d0, h, w.r0, h,
                       nullptr, nullptr, N, s));  // delta0
  Gemm g = make_gemm(w.d0, h, prm + d.in_w, h, w.dc + h, d.kC, N, kE1, h);
  OC_TRY((launch_gemm<O::BN, kNT, kAccumulate>(g, s)));  // demb1 += d0 W^T
  embed_bwd_rows<H><<<(N + 127) / 128, 128, 0, s>>>(B, w, dpts, N,
                                                    inv_scale, d);
  OC_TRY(static_cast<int>(cudaGetLastError()));
  // the parameter gradients: per-chunk partials, then reduce_tiles
  wgrad_kernel<H><<<dim3(wgrad_jobs<O::BN>(h), kChunks), O::kThreads, 0,
                    s>>>(w, partial, N, rows, d);
  OC_TRY(static_cast<int>(cudaGetLastError()));
  narrow_kernel<H><<<dim3(kNarrowJobs, kChunks), O::kNarrowThreads, 0, s>>>(
      pts, w, partial, N, rows, inv_scale, d);
  OC_TRY(static_cast<int>(cudaGetLastError()));
  return launch_reduce(partial, grads, 1, kChunks, d.PP, s);
}

// The instantiation a width runs on (its H; 0 past kMaxInst), or -1.
int instantiation(int hidden) {
  switch (hidden) {
    case 32: case 64: case 128: case 256: return hidden;
    default:
      return hidden > kMaxInst && hidden % 32 == 0 ? 0 : -1;
  }
}

}  // namespace

extern "C" {

// [OccupancyMap P at hidden width 128, its partial row, row chunks]
int occupancy_layout(int* out) {
  out[0] = OcLayout<128>::P;
  out[1] = OcLayout<128>::PP;
  out[2] = kChunks;
  return 0;
}

// [P, partial row, workspace floats a row of the backward, of the
// forward] at hidden width `hidden` (32, 64, 128, 256, or a multiple of 32
// past 256; another width: cudaErrorInvalidValue)
int occupancy_width_layout(int hidden, int* out) {
  if (instantiation(hidden) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(hidden);
  out[0] = d.P;
  out[1] = d.PP;
  out[2] = d.ws_cols;
  out[3] = d.fwd_ws_cols;
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
    case 0: return launch_gemm<128, kNN, kBiasRelu>(g, s);
    case 1: return launch_gemm<128, kNN, kMask>(g, s);
    case 2: return launch_gemm<128, kNN, kAccumulate>(g, s);
    case 3: return launch_gemm<128, kNT, kBiasRelu>(g, s);
    case 4: return launch_gemm<128, kNT, kMask>(g, s);
    case 5: return launch_gemm<128, kNT, kAccumulate>(g, s);
    case 6: return launch_gemm<128, kTN, kBiasRelu>(g, s);
    case 7: return launch_gemm<128, kTN, kMask>(g, s);
    case 8: return launch_gemm<128, kTN, kAccumulate>(g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// pts [N,3], params [P(hidden)], B [21,3] -> out [N,4]; workspace
// [ceil4(N) * the width's forward workspace columns]
int oc_fwd(const float* pts, const float* params, const float* B, float* out,
           float* workspace, int N, int hidden, float inv_scale,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(hidden);
  switch (instantiation(hidden)) {
#define OC_FWD(h) \
  case h: return run_fwd<h>(d, pts, params, B, out, workspace, N, inv_scale, s);
    OC_FWD(32) OC_FWD(64) OC_FWD(128) OC_FWD(256) OC_FWD(0)
#undef OC_FWD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// pts [N,3], params [P(hidden)], B [21,3], dout [N,4] -> dpts [N,3],
// grads [P + 63] (via partial [kChunks, P + 63]); workspace [ceil4(N) *
// the width's backward workspace columns]
int oc_bwd(const float* pts, const float* params, const float* B,
           const float* dout, float* dpts, float* partial, float* grads,
           float* workspace, int N, int hidden, float inv_scale,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dims d = make_dims(hidden);
  switch (instantiation(hidden)) {
#define OC_BWD(h)                                                         \
  case h: return run_bwd<h>(d, pts, params, B, dout, dpts, partial, grads, \
                            workspace, N, inv_scale, s);
    OC_BWD(32) OC_BWD(64) OC_BWD(128) OC_BWD(256) OC_BWD(0)
#undef OC_BWD
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

#undef OC_TRY
