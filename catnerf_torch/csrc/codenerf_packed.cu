// The packed-ensemble CodeNeRF ("categories in lanes") backward for Hopper
// (sm_90a), float32 throughout, as a shared-memory tiled backward on the
// forward chain kernel's tile body (cn_tile.cuh).
//
// Replaces the Pallas TPU kernel of catnerf_tpu/experimental/fused_field.py:
//   cn2_bwd_kernel <- _cn2_bwd_kernel (:786), called at :929
// reduce_tiles (field_common.cuh) then sums its partials. (The packed
// forward, _cn2_fwd_kernel :773, is cn2_fwd in codenerf_fwd.cu.)
//
// The contract is the TPU kernel's: point-major rows with the C categories
// side by side, pts [N, 3C], z* [N, 32C], dsigma [N, C], drgb [N, 3C]; the
// PE is one product with the folded basis B2 (fold_b2), S = sin(t @ B2);
// the concat layers are split products over [y | t | S] (_cn2_chain :739).
// The weight gradients are per category only: the off-diagonal blocks of
// the TPU kernel's dense cotangents are dropped by its caller's autodiff
// anyway. dB2 is returned as it is, and the wrapper folds it back to dB.
//
// What bounds the work on an H100 is the operations: per row and category
// the recompute (13,648 + 378 multiply-adds) and the backward's input and
// weight gradients (twice that), 1.41 GFLOP at C = 8 x 2,100 rows, against
// 55.6 KB of weights that every row of a category shares. The design:
//   * a block owns one category and kR = 64 rows with kT = 128 threads, the
//     forward's Tile geometry; it recomputes the forward with the forward's
//     own tile_layer (the weights staged by cp.async while the PE runs, t
//     and S summed apart), and keeps in shared memory, k-major, what the
//     backward reads: emb1 = [t | S_lo] and emb2 = S_hi, every layer's
//     output g0, g1, g2, r3, h, g4, r5, r6, and the ReLU masks [a > 0] of
//     the seven ReLU layers as bytes (tile_layer's *Mask epilogues; r0, r1,
//     r2 and r4 cannot be recovered from g = r + z);
//   * each input gradient is tile_dx, dX = D W^T out of shared memory: a
//     thread's 4 rows x 4 columns, each step of 4 in o one float4 of W a
//     column (a broadcast within the quarter warp) and one float4 of D a
//     row of o, 64 FMAs for 8 loads; its epilogue masks the delta, stores
//     an injection's gradient unmasked straight to dz*, adds the sigma
//     head's term or accumulates dS;
//   * each weight gradient is tile_wgrad, X^T D over the block's 64 rows
//     out of the same k-major buffers, 4 x 4 register tiles with float4
//     loads of 4 rows, the row blocks walked in a rotated order per lane so
//     that a quarter warp's loads are conflict-free; its result goes to the
//     block's partial row [params | dB2] in device memory;
//   * dS sums into shared memory in codenerf_packed_bwd_plain's order, and
//     dsinarg = dS cos(sinarg) takes cos_f32 (cn_tile.cuh), with nothing in
//     local memory.
// Shared memory: 206,864 bytes a block, one block an SM (4 warps).
//
// Every output's sum runs in one fixed order, so two runs are bitwise equal
// (no atomics); reduce_tiles adds the blocks' partials in tile order, the
// counterpart of the revisited output blocks at :860-874. Ragged rows are
// masked, not padded: a row past N has zero cotangents (so it adds nothing
// to any sum) and writes nothing. cn2_tile_dx and cn2_tile_wgrad run one
// piece of the backward alone, cn_cos its cosine (test entries).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError().

#include "cn_tile.cuh"

namespace {

constexpr int PP2 = cn::P + kB2;  // partial row: params then dB2
constexpr int kMaskW = W / 4 * kR;  // mask bytes of a 32-wide layer

// Shared memory, in floats: the category's parameters and B2; emb1 = [t |
// S_lo] [87][kR] and emb2 = S_hi [42][kR]; the layers' outputs g0, g1, g2,
// r3, h, g4, r5 [32][kR] and r6 [16][kR]; two 32-wide delta buffers; dS
// [126][kR]; da7 [3][kR], dsigma x10 [kR], the t gradients of the
// encoding and cat layers [3][kR] each; then the masks of the seven ReLU
// layers (bytes).
constexpr int kSmW = 0;
constexpr int kSmB2 = kSmW + cn::P;
constexpr int kSmE1 = kSmB2 + kBPad;
constexpr int kSmE2 = kSmE1 + kE1 * kR;
constexpr int kSmAct = kSmE2 + kE2 * kR;  // g0 g1 g2 r3 h g4 r5, then r6
constexpr int kSmR6 = kSmAct + 7 * W * kR;
constexpr int kSmDa = kSmR6 + (W / 2) * kR;
constexpr int kSmDb = kSmDa + W * kR;
constexpr int kSmDS = kSmDb + W * kR;
constexpr int kSmD7 = kSmDS + kS * kR;
constexpr int kSmDsg = kSmD7 + 4 * kR;
constexpr int kSmDtE = kSmDsg + kR;
constexpr int kSmDtC = kSmDtE + 4 * kR;
constexpr int kSmMask = kSmDtC + 4 * kR;
constexpr int kMaskBytes = 6 * kMaskW + (W / 8) * kR;
constexpr int kSmFloats = kSmMask + kMaskBytes / 4;
constexpr size_t kSmemBytes = kSmFloats * sizeof(float);
static_assert(kSmB2 % 4 == 0 && kSmE1 % 4 == 0 && kSmE2 % 4 == 0 &&
                  kSmAct % 4 == 0 && kSmR6 % 4 == 0 && kSmDS % 4 == 0 &&
                  kSmD7 % 4 == 0 && kSmDtE % 4 == 0 && kSmMask % 4 == 0,
              "16-byte aligned");
static_assert(kB2 <= kBPad && kSmemBytes <= 232448, "one block an SM");

// ---------------------------------------------------------------------------
// The two tile pieces
// ---------------------------------------------------------------------------

// tile_dx's epilogues (fused_field.PACKED_DX_PIECES).
enum DxEpi {
  kDxStore = 0,     // y = dX
  kDxMask = 1,      // y = dX [a > 0]
  kDxGradMask = 2,  // dz = dX (device memory), y = dX [a > 0]
  kDxOuter = 3,     // y = dX + d1 w1^T
  kDxAccum = 4      // y = dX + y
};

// The input gradient of one layer over the block's kR rows:
//   dX[r][k] = sum over o < KIN, in order, of dT[o][r] w[k][o]
// with dT k-major [KIN][kR], w the KOUT rows of the layer's weight block
// that the piece reads (row-major, KIN floats a row), yT k-major
// [KOUT][kR]. The thread tile is the layer's forward Tile (Tile<16> for a
// 16-wide KOUT, else Tile<32> in passes of 32 columns, columns past KOUT
// idle), so the mask bytes a *Mask epilogue of tile_layer wrote are read by
// the thread that wrote them. kDxGradMask stores dX's rows r < nvalid at
// dz + r * zld + k; kDxOuter adds d1[r] w1[k] (the sigma head's term of dh,
// product rounded then added, as the plain version's); kDxAccum adds yT's
// own value.
template <int KOUT, int KIN, DxEpi E>
__device__ __forceinline__ void tile_dx(const float* dT, const float* w,
                                        const unsigned char* mask,
                                        const float* d1, const float* w1,
                                        float* __restrict__ dz, size_t zld,
                                        int nvalid, float* yT) {
  constexpr int kCols = KOUT == W / 2 ? W / 2 : W;
  using S = Tile<kCols>;
  constexpr int TM = S::kTM;
  constexpr bool kMasked = E == kDxMask || E == kDxGradMask;
  static_assert(!kMasked || KOUT == kCols, "a mask epilogue is one pass");
  const S ts;
#pragma unroll 1
  for (int p = 0; p < KOUT; p += kCols) {
    const int k0 = p + ts.c0;
    if (k0 >= KOUT) continue;
    const float* wr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wr[j] = w + min(k0 + j, KOUT - 1) * KIN;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if constexpr (KIN % 4 == 0) {
#pragma unroll 2
      for (int o = 0; o < KIN; o += 4) {
        float wv[4][4], dv[4][TM];
#pragma unroll
        for (int j = 0; j < 4; ++j) load_rows<4>(wr[j] + o, wv[j]);
#pragma unroll
        for (int u = 0; u < 4; ++u) load_rows<TM>(dT + (o + u) * kR + ts.r0,
                                                  dv[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(dv[u][i], wv[j][u], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int o = 0; o < KIN; ++o) {
        float dv[TM];
        load_rows<TM>(dT + o * kR + ts.r0, dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float wv = wr[j][o];
#pragma unroll
          for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(dv[i], wv, acc[i][j]);
        }
      }
    }
    unsigned bits[TM];
    if constexpr (kMasked) {
#pragma unroll
      for (int i = 0; i < TM; ++i) bits[i] = mask[(k0 / 4) * kR + ts.r0 + i];
    }
    if constexpr (E == kDxGradMask) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (ts.r0 + i < nvalid)
          *reinterpret_cast<float4*>(dz + (ts.r0 + i) * zld + k0) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j;
      if (k >= KOUT) break;
      float col[TM];
      if constexpr (E == kDxAccum) load_rows<TM>(yT + k * kR + ts.r0, col);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float v = acc[i][j];
        if constexpr (E == kDxOuter)
          v = __fadd_rn(v, __fmul_rn(d1[ts.r0 + i], w1[k]));
        if constexpr (E == kDxAccum) v = v + col[i];
        if constexpr (kMasked) v = (bits[i] >> j) & 1u ? v : 0.f;
        col[i] = v;
      }
      store_rows<TM>(yT + k * kR + ts.r0, col);
    }
  }
}

// The weight gradient of one layer over the block's kR rows:
//   part_w[k][o] = sum over r of x[k][r] d[o][r],  part_b[o] = sum of d[o][r]
// with x = [x1 (K1 rows) | x2 (K2 rows)] and dT [OUT][kR] k-major in shared
// memory, part_w [K1+K2][OUT] and part_b [OUT] in device memory (the
// block's partial row). A thread takes 4 k x 4 o tiles (k or o past the
// edge read the last row and write nothing); each sums the 16 blocks of 4
// rows in the order (s + lane % 8) mod 16, s = 0..15, and within a block in
// row order: consecutive lanes of a quarter warp take consecutive k groups,
// whose float4 loads then fall in 8 distinct 16-byte bank groups. The bias
// sums run a thread an o, over r rotated by the lane.
template <int K1, int K2, int OUT, bool BIAS = true>
__device__ __forceinline__ void tile_wgrad(const float* x1, const float* x2,
                                           const float* dT,
                                           float* __restrict__ part_w,
                                           float* __restrict__ part_b) {
  constexpr int K = K1 + K2;
  constexpr int KG = (K + 3) / 4;
  constexpr int OG = (OUT + 3) / 4;
  constexpr int kBlocks = kR / 4;
  static_assert(K2 == 0 || K1 % 4 == 0, "a k group lies in one piece");
  const int rot = threadIdx.x & 7;
  for (int t = threadIdx.x; t < KG * OG; t += kT) {
    const int kg = t % KG;
    const int og = t / KG;
    const float* xr[4];
    const float* dr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = min(4 * kg + i, K - 1);
      xr[i] = k < K1 ? x1 + k * kR : x2 + (k - K1) * kR;
      dr[i] = dT + min(4 * og + i, OUT - 1) * kR;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int s = 0; s < kBlocks; ++s) {
      const int r = 4 * ((s + rot) & (kBlocks - 1));
      float xv[4][4], dv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_rows<4>(xr[i] + r, xv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load_rows<4>(dr[j] + r, dv[j]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(xv[i][q], dv[j][q], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * kg + i;
        const int o = 4 * og + j;
        if (k < K && o < OUT) part_w[k * OUT + o] = acc[i][j];
      }
  }
  if constexpr (BIAS) {
    const int lane = threadIdx.x & 31;
    for (int o = threadIdx.x; o < OUT; o += kT) {
      float s = 0.f;
      for (int r = 0; r < kR; ++r) s += dT[o * kR + ((r + lane) & (kR - 1))];
      part_b[o] = s;
    }
  }
}

// The backward's input-gradient pieces in its order
// (fused_field.PACKED_DX_PIECES) and its weight gradients
// (fused_field.PACKED_BWD_LAYERS); the kernel and the test entries run
// each through dx_piece / wgrad_layer, so both take the same
// instantiations.
enum DxPiece {
  kPr1 = 0, kPr0, kPt0, kPvdH, kPvdS, kPen, kPs1, kPcY, kPcT, kPcS, kPs0,
  kPeT, kPeS, kNumDx
};
__host__ __device__ constexpr int dx_kout(int p) {
  return p == kPr1 ? W / 2 : p == kPvdS ? kE2
         : p == kPcT || p == kPeT       ? 3
         : p == kPcS || p == kPeS       ? kSLo
                                        : W;
}
__host__ __device__ constexpr int dx_kin(int p) {
  return p == kPr1 ? 3 : p == kPr0 ? W / 2 : W;
}
__host__ __device__ constexpr DxEpi dx_epi(int p) {
  return p == kPr1 || p == kPr0 || p == kPen               ? kDxMask
         : p == kPt0 || p == kPs1 || p == kPcY || p == kPs0 ? kDxGradMask
         : p == kPvdH                                      ? kDxOuter
         : p == kPeS                                       ? kDxAccum
                                                           : kDxStore;
}

template <int P>
__device__ __forceinline__ void dx_piece(const float* dT, const float* w,
                                         const unsigned char* mask,
                                         const float* d1, const float* w1,
                                         float* dz, size_t zld, int nvalid,
                                         float* yT) {
  tile_dx<dx_kout(P), dx_kin(P), dx_epi(P)>(dT, w, mask, d1, w1, dz, zld,
                                            nvalid, yT);
}

enum WgLayer {
  kWr1 = 0, kWr0, kWt0, kWvd, kWsg, kWen, kWs1, kWc, kWs0, kWe, kWb2, kNumWg
};
__host__ __device__ constexpr int wg_k1(int l) {
  return l == kWr1 ? W / 2 : l == kWe ? kE1 : l == kWb2 ? 3 : W;
}
__host__ __device__ constexpr int wg_k2(int l) {
  return l == kWvd ? kE2 : l == kWc ? kE1 : 0;
}
__host__ __device__ constexpr int wg_out(int l) {
  return l == kWr1 ? 3 : l == kWr0 ? W / 2 : l == kWsg ? 1
         : l == kWb2                          ? kS
                                              : W;
}

template <int L>
__device__ __forceinline__ void wgrad_layer(const float* x1, const float* x2,
                                            const float* dT, float* part_w,
                                            float* part_b) {
  tile_wgrad<wg_k1(L), wg_k2(L), wg_out(L), L != kWb2>(x1, x2, dT, part_w,
                                                       part_b);
}

// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------

// grid (ceil(N / kR), C), kT threads, kSmemBytes of dynamic shared memory.
// + dsg [N, C], dcol [N, 3C] -> dpts [N, 3C], dz* [N, 32C], and one
// partial row [params | dB2] a block: partial [C, gridDim.x, PP2].
__global__ void __launch_bounds__(kT, 1)
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
  float* sm = reinterpret_cast<float*>(smem4);
  float* sW = sm + kSmW;
  float* sB2 = sm + kSmB2;
  float* e1 = sm + kSmE1;
  float* e2 = sm + kSmE2;
  float* G0 = sm + kSmAct;
  float* G1 = G0 + W * kR;
  float* G2 = G1 + W * kR;
  float* R3 = G2 + W * kR;
  float* H = R3 + W * kR;
  float* G4 = H + W * kR;
  float* R5 = G4 + W * kR;
  float* R6 = sm + kSmR6;
  float* Da = sm + kSmDa;
  float* Db = sm + kSmDb;
  float* dS = sm + kSmDS;
  float* D7 = sm + kSmD7;
  float* Dsg = sm + kSmDsg;
  float* DtE = sm + kSmDtE;
  float* DtC = sm + kSmDtC;
  unsigned char* M0 = reinterpret_cast<unsigned char*>(sm + kSmMask);
  unsigned char* M1 = M0 + kMaskW;
  unsigned char* M2 = M1 + kMaskW;
  unsigned char* M3 = M2 + kMaskW;
  unsigned char* M4 = M3 + kMaskW;
  unsigned char* M5 = M4 + kMaskW;
  unsigned char* M6 = M5 + kMaskW;
  const int c = blockIdx.y;
  const int row0 = blockIdx.x * kR;
  const int nvalid = min(kR, N - row0);
  const int tid = threadIdx.x;

  // the forward, as chain_kernel<kFolded, kPointMajor>, keeping what the
  // backward reads
  stage_async(sW, params + static_cast<size_t>(c) * cn::P, cn::P);
  fold_b2(Bg + c * kBSize, sB2);
  for (int e = tid; e < 3 * kR; e += kT) {
    const int r = e / 3;
    const int j = e - 3 * r;
    const float p =
        r < nvalid ? pts[static_cast<size_t>(row0 + r) * 3 * C + 3 * c + j]
                   : 0.f;
    e1[j * kR + r] = p * inv_scale;
  }
  __syncthreads();
  block_embed<kFolded>(sB2, e1, e2);
  wait_async();
  __syncthreads();
  const size_t zoff = static_cast<size_t>(row0) * W * C + W * c;
  const size_t zld = static_cast<size_t>(W) * C;
  tile_layer<W, kReluAddMask, 3, kSLo>(e1, e1 + 3 * kR, nullptr,
                                       sW + cn::e_w, sW + cn::e_b, zs0 + zoff,
                                       zld, nvalid, G0, M0);
  __syncthreads();
  tile_layer<W, kReluAddMask, W>(G0, nullptr, nullptr, sW + cn::s0_w,
                                 sW + cn::s0_b, zc + zoff, zld, nvalid, G1,
                                 M1);
  __syncthreads();
  tile_layer<W, kReluAddMask, W, 3, kSLo>(G1, e1, e1 + 3 * kR, sW + cn::c_w,
                                          sW + cn::c_b, zs1 + zoff, zld,
                                          nvalid, G2, M2);
  __syncthreads();
  tile_layer<W, kReluMask, W>(G2, nullptr, nullptr, sW + cn::s1_w,
                              sW + cn::s1_b, nullptr, 0, nvalid, R3, M3);
  __syncthreads();
  tile_layer<W, kBiasOnly, W>(R3, nullptr, nullptr, sW + cn::en_w,
                              sW + cn::en_b, nullptr, 0, nvalid, H);
  __syncthreads();
  tile_layer<W, kReluAddMask, W, kE2>(H, e2, nullptr, sW + cn::vd_w,
                                      sW + cn::vd_b, zt0 + zoff, zld, nvalid,
                                      G4, M4);
  __syncthreads();
  tile_layer<W, kReluMask, W>(G4, nullptr, nullptr, sW + cn::t0_w,
                              sW + cn::t0_b, nullptr, 0, nvalid, R5, M5);
  __syncthreads();
  tile_layer<W / 2, kReluMask, W>(R5, nullptr, nullptr, sW + cn::r0_w,
                                  sW + cn::r0_b, nullptr, 0, nvalid, R6, M6);
  __syncthreads();
  // the heads' cotangents; a row past N has none
  if (tid < kR) {
    const bool ok = tid < nvalid;
    const size_t row = ok ? row0 + tid : 0;
    float a7[3];
    rgb_head(R6, sW + cn::r1_w, sW + cn::r1_b, tid, a7);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float col = sigmoidf(a7[k]);
      const float dcol = ok ? dcol_in[row * 3 * C + 3 * c + k] : 0.f;
      D7[k * kR + tid] = dcol * col * (1.f - col);
    }
    Dsg[tid] = (ok ? dsg_in[row * C + c] : 0.f) * 10.f;
  }
  __syncthreads();

  // the backward (_cn2_bwd_kernel :800-858), layer by layer; each phase
  // reads what the one before wrote
  float* part = partial + (static_cast<size_t>(c) * gridDim.x + blockIdx.x) *
                              static_cast<size_t>(PP2);
  wgrad_layer<kWr1>(R6, nullptr, D7, part + cn::r1_w, part + cn::r1_b);
  dx_piece<kPr1>(D7, sW + cn::r1_w, M6, nullptr, nullptr, nullptr, 0, nvalid,
                 Da);  // da6
  __syncthreads();
  wgrad_layer<kWr0>(R5, nullptr, Da, part + cn::r0_w, part + cn::r0_b);
  dx_piece<kPr0>(Da, sW + cn::r0_w, M5, nullptr, nullptr, nullptr, 0, nvalid,
                 Db);  // da5
  __syncthreads();
  wgrad_layer<kWt0>(G4, nullptr, Db, part + cn::t0_w, part + cn::t0_b);
  dx_piece<kPt0>(Db, sW + cn::t0_w, M4, nullptr, nullptr, dzt0 + zoff, zld,
                 nvalid, Da);  // dg4 -> dzt0, da4
  __syncthreads();
  wgrad_layer<kWvd>(H, e2, Da, part + cn::vd_w, part + cn::vd_b);
  wgrad_layer<kWsg>(H, nullptr, Dsg, part + cn::sg_w, part + cn::sg_b);
  dx_piece<kPvdH>(Da, sW + cn::vd_w, nullptr, Dsg, sW + cn::sg_w, nullptr, 0,
                  nvalid, Db);  // dh
  dx_piece<kPvdS>(Da, sW + cn::vd_w + W * W, nullptr, nullptr, nullptr,
                  nullptr, 0, nvalid, dS + kSLo * kR);  // dS[84:126]
  __syncthreads();
  wgrad_layer<kWen>(R3, nullptr, Db, part + cn::en_w, part + cn::en_b);
  dx_piece<kPen>(Db, sW + cn::en_w, M3, nullptr, nullptr, nullptr, 0, nvalid,
                 Da);  // da3
  __syncthreads();
  wgrad_layer<kWs1>(G2, nullptr, Da, part + cn::s1_w, part + cn::s1_b);
  dx_piece<kPs1>(Da, sW + cn::s1_w, M2, nullptr, nullptr, dzs1 + zoff, zld,
                 nvalid, Db);  // dg2 -> dzs1, da2
  __syncthreads();
  wgrad_layer<kWc>(G1, e1, Db, part + cn::c_w, part + cn::c_b);
  dx_piece<kPcY>(Db, sW + cn::c_w, M1, nullptr, nullptr, dzc + zoff, zld,
                 nvalid, Da);  // dg1 -> dzc, da1
  dx_piece<kPcT>(Db, sW + cn::c_w + W * W, nullptr, nullptr, nullptr,
                 nullptr, 0, nvalid, DtC);
  dx_piece<kPcS>(Db, sW + cn::c_w + (W + 3) * W, nullptr, nullptr, nullptr,
                 nullptr, 0, nvalid, dS);  // dS[0:84], the cat layer's part
  __syncthreads();
  wgrad_layer<kWs0>(G0, nullptr, Da, part + cn::s0_w, part + cn::s0_b);
  dx_piece<kPs0>(Da, sW + cn::s0_w, M0, nullptr, nullptr, dzs0 + zoff, zld,
                 nvalid, Db);  // dg0 -> dzs0, da0
  __syncthreads();
  wgrad_layer<kWe>(e1, nullptr, Db, part + cn::e_w, part + cn::e_b);
  dx_piece<kPeT>(Db, sW + cn::e_w, nullptr, nullptr, nullptr, nullptr, 0,
                 nvalid, DtE);
  dx_piece<kPeS>(Db, sW + cn::e_w + 3 * W, nullptr, nullptr, nullptr,
                 nullptr, 0, nvalid, dS);  // + the encoding layer's part
  __syncthreads();
  // dsinarg = dS cos(sinarg), sinarg recomputed from t and B2
  for (int e = tid; e < kS * kR; e += kT) {
    const int s = e / kR;
    const int r = e - s * kR;
    const float t[3] = {e1[r], e1[kR + r], e1[2 * kR + r]};
    dS[e] = dS[e] * cos_f32(sinarg(t, sB2, s));
  }
  __syncthreads();
  // dB2 = t^T dsinarg; dt = (dsinarg B2^T + dt_e) + dt_c
  wgrad_layer<kWb2>(e1, nullptr, dS, part + cn::P, nullptr);
  if (tid < nvalid) {
    const size_t row = row0 + tid;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float a = 0.f;
      for (int s = 0; s < kS; ++s)
        a = fmaf(dS[s * kR + tid], sB2[j * kS + s], a);
      dpts[row * 3 * C + 3 * c + j] =
          ((a + DtE[j * kR + tid]) + DtC[j * kR + tid]) * inv_scale;
    }
  }
}

// ---------------------------------------------------------------------------
// The pieces alone (test entries cn2_tile_dx, cn2_tile_wgrad, cn_cos)
// ---------------------------------------------------------------------------

// cn2_tile_dx's shared memory, in floats: d k-major [32][kR], w [84 x 32],
// the mask bytes [8][kR], d1 [kR], w1 [32], y k-major [84][kR].
constexpr int kDxD = 0;
constexpr int kDxW = kDxD + W * kR;
constexpr int kDxM = kDxW + kSLo * W;
constexpr int kDxD1 = kDxM + kMaskW / 4;
constexpr int kDxW1 = kDxD1 + kR;
constexpr int kDxY = kDxW1 + W;
constexpr size_t kDxSmemBytes = (kDxY + kSLo * kR) * sizeof(float);

// d [N, KIN], w [KOUT, KIN], a [N, KOUT] (the mask's pre-activation), d1
// [N], w1 [KOUT], acc [N, KOUT] (each only where the piece's epilogue reads
// it) -> y [N, KOUT], dz [N, KOUT] (kDxGradMask), all row-major; grid
// ceil(N / kR), kT threads, kDxSmemBytes. The mask bytes are laid out from
// a as tile_layer's *Mask epilogues lay them out.
template <int P>
__global__ void __launch_bounds__(kT)
    dx_test_kernel(const float* __restrict__ d, const float* __restrict__ w,
                   const float* __restrict__ a, const float* __restrict__ d1,
                   const float* __restrict__ w1,
                   const float* __restrict__ acc, float* __restrict__ y,
                   float* __restrict__ dz, int N) {
  constexpr int KOUT = dx_kout(P);
  constexpr int KIN = dx_kin(P);
  constexpr DxEpi E = dx_epi(P);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sd = sm + kDxD;
  float* sw = sm + kDxW;
  unsigned char* sm8 = reinterpret_cast<unsigned char*>(sm + kDxM);
  float* sd1 = sm + kDxD1;
  float* sw1 = sm + kDxW1;
  float* sy = sm + kDxY;
  const int row0 = blockIdx.x * kR;
  const int nvalid = min(kR, N - row0);
  const int tid = threadIdx.x;
  for (int e = tid; e < kR * KIN; e += kT) {
    const int r = e / KIN;
    const int o = e - r * KIN;
    sd[o * kR + r] = r < nvalid ? d[static_cast<size_t>(row0) * KIN + e] : 0.f;
  }
  for (int e = tid; e < KOUT * KIN; e += kT) sw[e] = w[e];
  if constexpr (E == kDxMask || E == kDxGradMask) {
    for (int e = tid; e < KOUT / 4 * kR; e += kT) {
      const int g = e / kR;
      const int r = e - g * kR;
      unsigned bits = 0u;
      for (int j = 0; j < 4 && r < nvalid; ++j)
        bits |= (a[static_cast<size_t>(row0 + r) * KOUT + 4 * g + j] > 0.f
                     ? 1u : 0u) << j;
      sm8[e] = static_cast<unsigned char>(bits);
    }
  }
  if constexpr (E == kDxOuter) {
    for (int r = tid; r < kR; r += kT) sd1[r] = r < nvalid ? d1[row0 + r] : 0.f;
    for (int k = tid; k < KOUT; k += kT) sw1[k] = w1[k];
  }
  if constexpr (E == kDxAccum) {
    for (int e = tid; e < kR * KOUT; e += kT) {
      const int r = e / KOUT;
      const int k = e - r * KOUT;
      sy[k * kR + r] =
          r < nvalid ? acc[static_cast<size_t>(row0) * KOUT + e] : 0.f;
    }
  }
  __syncthreads();
  dx_piece<P>(sd, sw, sm8, sd1, sw1,
              dz == nullptr ? nullptr : dz + static_cast<size_t>(row0) * KOUT,
              KOUT, nvalid, sy);
  __syncthreads();
  for (int e = tid; e < nvalid * KOUT; e += kT) {
    const int r = e / KOUT;
    const int k = e - r * KOUT;
    y[static_cast<size_t>(row0) * KOUT + e] = sy[k * kR + r];
  }
}

// cn2_tile_wgrad's shared memory: x k-major [119][kR], d k-major [126][kR].
constexpr size_t kWgSmemBytes = (W + kE1 + kS) * kR * sizeof(float);

// x [N, K], d [N, OUT] row-major -> partial [gridDim.x, K * OUT (+ OUT)]:
// each block's weight gradient (and bias sum) over its rows; grid
// ceil(N / kR), kT threads, kWgSmemBytes.
template <int L>
__global__ void __launch_bounds__(kT)
    wgrad_test_kernel(const float* __restrict__ x,
                      const float* __restrict__ d,
                      float* __restrict__ partial, int N) {
  constexpr int K = wg_k1(L) + wg_k2(L);
  constexpr int OUT = wg_out(L);
  constexpr int PP = K * OUT + (L != kWb2 ? OUT : 0);
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);
  float* sd = sx + (W + kE1) * kR;
  const int row0 = blockIdx.x * kR;
  const int nvalid = min(kR, N - row0);
  for (int e = threadIdx.x; e < kR * K; e += kT) {
    const int r = e / K;
    const int k = e - r * K;
    sx[k * kR + r] = r < nvalid ? x[static_cast<size_t>(row0) * K + e] : 0.f;
  }
  for (int e = threadIdx.x; e < kR * OUT; e += kT) {
    const int r = e / OUT;
    const int o = e - r * OUT;
    sd[o * kR + r] = r < nvalid ? d[static_cast<size_t>(row0) * OUT + e] : 0.f;
  }
  __syncthreads();
  float* part = partial + static_cast<size_t>(blockIdx.x) * PP;
  wgrad_layer<L>(sx, sx + wg_k1(L) * kR, sd, part, part + K * OUT);
}

// y = cos_f32(x), one thread an element.
__global__ void cos_kernel(const float* __restrict__ x, float* __restrict__ y,
                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = cos_f32(x[i]);
}

template <int P>
int launch_dx(const float* d, const float* w, const float* a, const float* d1,
              const float* w1, const float* acc, float* y, float* dz, int N,
              cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      dx_test_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kDxSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  dx_test_kernel<P><<<(N + kR - 1) / kR, kT, kDxSmemBytes, s>>>(
      d, w, a, d1, w1, acc, y, dz, N);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_wgrad(const float* x, const float* d, float* partial, float* out,
                 int N, cudaStream_t s) {
  constexpr int K = wg_k1(L) + wg_k2(L);
  constexpr int PP = K * wg_out(L) + (L != kWb2 ? wg_out(L) : 0);
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_test_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = (N + kR - 1) / kR;
  wgrad_test_kernel<L><<<nt, kT, kWgSmemBytes, s>>>(x, d, partial, N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(partial, out, 1, nt, PP, s);
}

}  // namespace

extern "C" {

// [P, B2 size, rows a block, threads a block, dynamic shared memory bytes
// of the backward]
int packed_layout(int* out) {
  out[0] = cn::P;
  out[1] = kB2;
  out[2] = kR;
  out[3] = kT;
  out[4] = static_cast<int>(kSmemBytes);
  return 0;
}

// + dsg [N,C], dcol [N,3C] -> dpts [N,3C], dz* [N,32C], grads [C, P + 378]
// (via partial [C, ceil(N / 64), P + 378])
int cn2_bwd(const float* pts, const float* zs0, const float* zc,
            const float* zs1, const float* zt0, const float* params,
            const float* B, const float* dsg, const float* dcol, float* dpts,
            float* dzs0, float* dzc, float* dzs1, float* dzt0, float* partial,
            float* grads, int C, int N, float inv_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      cn2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nt = (N + kR - 1) / kR;
  cn2_bwd_kernel<<<dim3(nt, C), kT, kSmemBytes, s>>>(
      pts, zs0, zc, zs1, zt0, params, B, dsg, dcol, dpts, dzs0, dzc, dzs1,
      dzt0, partial, N, C, inv_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(partial, grads, C, nt, PP2, s);
}

// One input-gradient piece alone (enum DxPiece, fused_field
// PACKED_DX_PIECES): d [N, KIN], w [KOUT, KIN], a / d1, w1 / acc or null
// -> y [N, KOUT], dz [N, KOUT] or null, all row-major. Any other piece is
// cudaErrorInvalidValue.
int cn2_tile_dx(int piece, const float* d, const float* w, const float* a,
                const float* d1, const float* w1, const float* acc, float* y,
                float* dz, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (piece) {
    case kPr1: return launch_dx<kPr1>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPr0: return launch_dx<kPr0>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPt0: return launch_dx<kPt0>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPvdH: return launch_dx<kPvdH>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPvdS: return launch_dx<kPvdS>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPen: return launch_dx<kPen>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPs1: return launch_dx<kPs1>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPcY: return launch_dx<kPcY>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPcT: return launch_dx<kPcT>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPcS: return launch_dx<kPcS>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPs0: return launch_dx<kPs0>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPeT: return launch_dx<kPeT>(d, w, a, d1, w1, acc, y, dz, N, s);
    case kPeS: return launch_dx<kPeS>(d, w, a, d1, w1, acc, y, dz, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One weight gradient alone (enum WgLayer, fused_field PACKED_BWD_LAYERS):
// x [N, K], d [N, OUT] -> out [K * OUT (+ OUT)] = [dW | db], through
// partial [ceil(N / 64), K * OUT (+ OUT)] and reduce_tiles. Any other
// layer is cudaErrorInvalidValue.
int cn2_tile_wgrad(int layer, const float* x, const float* d, float* partial,
                   float* out, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layer) {
    case kWr1: return launch_wgrad<kWr1>(x, d, partial, out, N, s);
    case kWr0: return launch_wgrad<kWr0>(x, d, partial, out, N, s);
    case kWt0: return launch_wgrad<kWt0>(x, d, partial, out, N, s);
    case kWvd: return launch_wgrad<kWvd>(x, d, partial, out, N, s);
    case kWsg: return launch_wgrad<kWsg>(x, d, partial, out, N, s);
    case kWen: return launch_wgrad<kWen>(x, d, partial, out, N, s);
    case kWs1: return launch_wgrad<kWs1>(x, d, partial, out, N, s);
    case kWc: return launch_wgrad<kWc>(x, d, partial, out, N, s);
    case kWs0: return launch_wgrad<kWs0>(x, d, partial, out, N, s);
    case kWe: return launch_wgrad<kWe>(x, d, partial, out, N, s);
    case kWb2: return launch_wgrad<kWb2>(x, d, partial, out, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward's cosine alone: y[i] = cos(x[i]), i < n.
int cn_cos(const float* x, float* y, int n, void* stream) {
  cos_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
