// registration.cpp — robust point-cloud registration kernels.
//
// First-party replacements for the reference's native dependencies:
//   TEASER++ GNC-TLS rotation solver + max-clique inlier selection
//     (ref: src/teaser_utils/helpers.py:54-69,
//      src/teaser_utils/teaser_fpfh_icp.py:77-89)
//   Open3D point-to-point ICP (max 100 iters)
//     (ref: src/teaser_utils/teaser_fpfh_icp.py:85-89)
//   Open3D FPFH features (ref: src/teaser_utils/helpers.py:17-25)
//   Open3D normal estimation (ref: src/utils.py:569)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <limits>
#include <numeric>
#include <vector>

namespace {

// ------------------------- small linear algebra ---------------------------

struct Mat3 {
  double m[3][3];
  static Mat3 identity() {
    Mat3 r{};
    r.m[0][0] = r.m[1][1] = r.m[2][2] = 1.0;
    return r;
  }
};

inline Mat3 matmul(const Mat3& a, const Mat3& b) {
  Mat3 r{};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) r.m[i][j] += a.m[i][k] * b.m[k][j];
  return r;
}

inline Mat3 transpose(const Mat3& a) {
  Mat3 r{};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) r.m[i][j] = a.m[j][i];
  return r;
}

inline double det3(const Mat3& a) {
  return a.m[0][0] * (a.m[1][1] * a.m[2][2] - a.m[1][2] * a.m[2][1]) -
         a.m[0][1] * (a.m[1][0] * a.m[2][2] - a.m[1][2] * a.m[2][0]) +
         a.m[0][2] * (a.m[1][0] * a.m[2][1] - a.m[1][1] * a.m[2][0]);
}

// Jacobi eigen-decomposition of a symmetric 3x3: A = V diag(w) V^T.
void sym_eigen(const Mat3& A_in, double w[3], Mat3* V) {
  Mat3 A = A_in;
  *V = Mat3::identity();
  for (int sweep = 0; sweep < 50; ++sweep) {
    double off = std::abs(A.m[0][1]) + std::abs(A.m[0][2]) + std::abs(A.m[1][2]);
    if (off < 1e-15) break;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        if (std::abs(A.m[p][q]) < 1e-18) continue;
        double theta = (A.m[q][q] - A.m[p][p]) / (2.0 * A.m[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::abs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0);
        double s = t * c;
        Mat3 R = Mat3::identity();
        R.m[p][p] = c; R.m[q][q] = c; R.m[p][q] = s; R.m[q][p] = -s;
        A = matmul(matmul(transpose(R), A), R);
        *V = matmul(*V, R);
      }
    }
  }
  for (int i = 0; i < 3; ++i) w[i] = A.m[i][i];
}

// Best rotation R minimizing sum w_i |b_i - R a_i|^2 (Kabsch via eigen of
// H^T H). a, b: (n, 3); weights may be null.
Mat3 weighted_kabsch(const double* a, const double* b, const double* w, int n) {
  Mat3 H{};
  for (int i = 0; i < n; ++i) {
    double wi = w ? w[i] : 1.0;
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        H.m[r][c] += wi * b[i * 3 + r] * a[i * 3 + c];
  }
  // SVD via eigen of H^T H = V S^2 V^T ; U = H V S^-1
  Mat3 HtH = matmul(transpose(H), H);
  double w2[3];
  Mat3 V;
  sym_eigen(HtH, w2, &V);
  // sort eigenvalues descending
  int idx[3] = {0, 1, 2};
  std::sort(idx, idx + 3, [&](int x, int y) { return w2[x] > w2[y]; });
  Mat3 Vs{};
  double s[3];
  for (int j = 0; j < 3; ++j) {
    s[j] = std::sqrt(std::max(w2[idx[j]], 0.0));
    for (int i = 0; i < 3; ++i) Vs.m[i][j] = V.m[i][idx[j]];
  }
  Mat3 U{};
  for (int j = 0; j < 3; ++j) {
    double inv = s[j] > 1e-12 ? 1.0 / s[j] : 0.0;
    for (int i = 0; i < 3; ++i) {
      double acc = 0;
      for (int k = 0; k < 3; ++k) acc += H.m[i][k] * Vs.m[k][j];
      U.m[i][j] = acc * inv;
    }
  }
  // handle rank deficiency: complete U's null columns via cross products
  auto fix_col = [&](Mat3& M, int j) {
    int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
    M.m[0][j] = M.m[1][j1] * M.m[2][j2] - M.m[2][j1] * M.m[1][j2];
    M.m[1][j] = M.m[2][j1] * M.m[0][j2] - M.m[0][j1] * M.m[2][j2];
    M.m[2][j] = M.m[0][j1] * M.m[1][j2] - M.m[1][j1] * M.m[0][j2];
  };
  for (int j = 0; j < 3; ++j) {
    double norm = 0;
    for (int i = 0; i < 3; ++i) norm += U.m[i][j] * U.m[i][j];
    if (norm < 0.5) fix_col(U, j);
  }
  Mat3 R = matmul(U, transpose(Vs));
  if (det3(R) < 0) {
    for (int i = 0; i < 3; ++i) Vs.m[i][2] = -Vs.m[i][2];
    R = matmul(U, transpose(Vs));
  }
  return R;
}

// Minimal 3D KD-tree reused locally (geomlib.cpp has the exported one).
struct KD {
  std::vector<float> pts;
  std::vector<int> order;
  int n = 0;
  void build(const float* p, int n_) {
    n = n_;
    pts.assign(p, p + size_t(n) * 3);
    order.resize(n);
    std::iota(order.begin(), order.end(), 0);
    rec(0, n, 0);
  }
  void rec(int lo, int hi, int axis) {
    if (hi - lo <= 1) return;
    int mid = (lo + hi) / 2;
    std::nth_element(order.begin() + lo, order.begin() + mid,
                     order.begin() + hi, [&](int a, int b) {
                       return pts[a * 3 + axis] < pts[b * 3 + axis];
                     });
    rec(lo, mid, (axis + 1) % 3);
    rec(mid + 1, hi, (axis + 1) % 3);
  }
  void nn(const float* q, int* bi, float* bd2) const {
    *bi = -1;
    *bd2 = std::numeric_limits<float>::max();
    nn_rec(q, 0, n, 0, bi, bd2);
  }
  void nn_rec(const float* q, int lo, int hi, int axis, int* bi,
              float* bd2) const {
    if (lo >= hi) return;
    int mid = (lo + hi) / 2;
    int p = order[mid];
    float dx = q[0] - pts[p * 3], dy = q[1] - pts[p * 3 + 1],
          dz = q[2] - pts[p * 3 + 2];
    float d2 = dx * dx + dy * dy + dz * dz;
    if (d2 < *bd2) { *bd2 = d2; *bi = p; }
    float diff = q[axis] - pts[p * 3 + axis];
    int na = (axis + 1) % 3;
    if (diff < 0) {
      nn_rec(q, lo, mid, na, bi, bd2);
      if (diff * diff < *bd2) nn_rec(q, mid + 1, hi, na, bi, bd2);
    } else {
      nn_rec(q, mid + 1, hi, na, bi, bd2);
      if (diff * diff < *bd2) nn_rec(q, lo, mid, na, bi, bd2);
    }
  }
  void radius(const float* q, float r2, int lo, int hi, int axis,
              std::vector<int>* out) const {
    if (lo >= hi) return;
    int mid = (lo + hi) / 2;
    int p = order[mid];
    float dx = q[0] - pts[p * 3], dy = q[1] - pts[p * 3 + 1],
          dz = q[2] - pts[p * 3 + 2];
    if (dx * dx + dy * dy + dz * dz <= r2) out->push_back(p);
    float diff = q[axis] - pts[p * 3 + axis];
    int na = (axis + 1) % 3;
    if (diff < 0) {
      radius(q, r2, lo, mid, na, out);
      if (diff * diff <= r2) radius(q, r2, mid + 1, hi, na, out);
    } else {
      radius(q, r2, mid + 1, hi, na, out);
      if (diff * diff <= r2) radius(q, r2, lo, mid, na, out);
    }
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Normal estimation: PCA over radius/knn-hybrid neighborhoods
// (Open3D KDTreeSearchParamHybrid semantics, ref: src/utils.py:569).
// ---------------------------------------------------------------------------

void estimate_normals(const float* pts, int n, float radius, int max_nn,
                      float* normals) {
  KD kd;
  kd.build(pts, n);
  std::vector<int> nbrs;
  float r2 = radius * radius;
  for (int i = 0; i < n; ++i) {
    nbrs.clear();
    kd.radius(pts + size_t(i) * 3, r2, 0, n, 0, &nbrs);
    if ((int)nbrs.size() > max_nn) {
      // keep the max_nn closest
      const float* q = pts + size_t(i) * 3;
      std::partial_sort(nbrs.begin(), nbrs.begin() + max_nn, nbrs.end(),
                        [&](int a, int b) {
                          auto d2 = [&](int j) {
                            float dx = q[0] - kd.pts[j * 3],
                                  dy = q[1] - kd.pts[j * 3 + 1],
                                  dz = q[2] - kd.pts[j * 3 + 2];
                            return dx * dx + dy * dy + dz * dz;
                          };
                          return d2(a) < d2(b);
                        });
      nbrs.resize(max_nn);
    }
    float* out = normals + size_t(i) * 3;
    if (nbrs.size() < 3) { out[0] = out[1] = 0; out[2] = 1; continue; }
    double mean[3] = {0, 0, 0};
    for (int j : nbrs)
      for (int d = 0; d < 3; ++d) mean[d] += pts[size_t(j) * 3 + d];
    for (double& m : mean) m /= nbrs.size();
    Mat3 C{};
    for (int j : nbrs) {
      double d0 = pts[size_t(j) * 3] - mean[0];
      double d1 = pts[size_t(j) * 3 + 1] - mean[1];
      double d2v = pts[size_t(j) * 3 + 2] - mean[2];
      double dv[3] = {d0, d1, d2v};
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) C.m[r][c] += dv[r] * dv[c];
    }
    double w[3];
    Mat3 V;
    sym_eigen(C, w, &V);
    int smallest = 0;
    if (w[1] < w[smallest]) smallest = 1;
    if (w[2] < w[smallest]) smallest = 2;
    double nx = V.m[0][smallest], ny = V.m[1][smallest], nz = V.m[2][smallest];
    double norm = std::sqrt(nx * nx + ny * ny + nz * nz) + 1e-30;
    out[0] = float(nx / norm);
    out[1] = float(ny / norm);
    out[2] = float(nz / norm);
  }
}

// ---------------------------------------------------------------------------
// FPFH features (33-dim), Open3D-compatible binning
// (ref: src/teaser_utils/helpers.py:17-25 computes FPFH at radius 5*voxel).
// ---------------------------------------------------------------------------

void compute_fpfh(const float* pts, const float* normals, int n, float radius,
                  int max_nn, float* out /* (n, 33) */) {
  KD kd;
  kd.build(pts, n);
  float r2 = radius * radius;
  const int B = 11;
  std::vector<float> spfh(size_t(n) * 33, 0.0f);
  std::vector<std::vector<int>> neighbor_lists(n);
  std::vector<int> nbrs;

  for (int i = 0; i < n; ++i) {
    nbrs.clear();
    kd.radius(pts + size_t(i) * 3, r2, 0, n, 0, &nbrs);
    nbrs.erase(std::remove(nbrs.begin(), nbrs.end(), i), nbrs.end());
    if ((int)nbrs.size() > max_nn) nbrs.resize(max_nn);
    neighbor_lists[i] = nbrs;
    if (nbrs.empty()) continue;
    const float* pi = pts + size_t(i) * 3;
    const float* ni = normals + size_t(i) * 3;
    float inc = 1.0f / nbrs.size();
    for (int j : nbrs) {
      const float* pj = pts + size_t(j) * 3;
      const float* nj = normals + size_t(j) * 3;
      double d[3] = {pj[0] - pi[0], pj[1] - pi[1], pj[2] - pi[2]};
      double dist = std::sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
      if (dist < 1e-12) continue;
      for (double& v : d) v /= dist;
      // Darboux frame at source (u = n_s chosen by larger angle, per PCL)
      const float *ns = ni, *nt = nj;
      double dot_s = ns[0] * d[0] + ns[1] * d[1] + ns[2] * d[2];
      double dot_t = nt[0] * -d[0] + nt[1] * -d[1] + nt[2] * -d[2];
      double dd[3] = {d[0], d[1], d[2]};
      if (std::acos(std::abs(dot_s)) > std::acos(std::abs(dot_t))) {
        std::swap(ns, nt);
        for (double& v : dd) v = -v;
        dot_s = dot_t;
      }
      double u[3] = {ns[0], ns[1], ns[2]};
      double v_[3] = {dd[1] * u[2] - dd[2] * u[1], dd[2] * u[0] - dd[0] * u[2],
                      dd[0] * u[1] - dd[1] * u[0]};
      double vn = std::sqrt(v_[0] * v_[0] + v_[1] * v_[1] + v_[2] * v_[2]);
      if (vn < 1e-12) continue;
      for (double& x : v_) x /= vn;
      double w_[3] = {u[1] * v_[2] - u[2] * v_[1], u[2] * v_[0] - u[0] * v_[2],
                      u[0] * v_[1] - u[1] * v_[0]};
      double alpha = v_[0] * nt[0] + v_[1] * nt[1] + v_[2] * nt[2];
      double phi = dot_s;
      double theta = std::atan2(w_[0] * nt[0] + w_[1] * nt[1] + w_[2] * nt[2],
                                u[0] * nt[0] + u[1] * nt[1] + u[2] * nt[2]);
      int b0 = std::min(B - 1, std::max(0, int(B * (alpha + 1.0) / 2.0)));
      int b1 = std::min(B - 1, std::max(0, int(B * (phi + 1.0) / 2.0)));
      int b2 = std::min(B - 1, std::max(0, int(B * (theta + M_PI) / (2 * M_PI))));
      spfh[size_t(i) * 33 + b0] += inc;
      spfh[size_t(i) * 33 + B + b1] += inc;
      spfh[size_t(i) * 33 + 2 * B + b2] += inc;
    }
  }

  for (int i = 0; i < n; ++i) {
    float* fi = out + size_t(i) * 33;
    for (int k = 0; k < 33; ++k) fi[k] = spfh[size_t(i) * 33 + k];
    const auto& nbrs_i = neighbor_lists[i];
    if (nbrs_i.empty()) continue;
    const float* pi = pts + size_t(i) * 3;
    double wsum = 0;
    std::vector<double> acc(33, 0.0);
    for (int j : nbrs_i) {
      const float* pj = pts + size_t(j) * 3;
      double dx = pj[0] - pi[0], dy = pj[1] - pi[1], dz = pj[2] - pi[2];
      double d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < 1e-12) continue;
      double w = 1.0 / d2;
      wsum += w;
      for (int k = 0; k < 33; ++k) acc[k] += w * spfh[size_t(j) * 33 + k];
    }
    // PCL: FPFH_i = SPFH_i + 1/k * sum_j (1/omega_j) SPFH_j, omega_j = d^2;
    // acc already holds sum_j (1/d2_j) SPFH_j.
    (void)wsum;
    for (int k = 0; k < 33; ++k)
      fi[k] = spfh[size_t(i) * 33 + k] + float(acc[k] / nbrs_i.size());
  }
}

// ---------------------------------------------------------------------------
// Point-to-point ICP (Open3D-compatible: max-correspondence gating, Kabsch
// update, 100-iteration cap; ref: src/teaser_utils/teaser_fpfh_icp.py:85-89).
// T is 4x4 row-major in/out. Returns number of iterations run.
// ---------------------------------------------------------------------------

int icp_point_to_point(const float* src, int n_src, const float* dst,
                       int n_dst, float max_corr_dist, int max_iter,
                       double* T_io, double* out_fitness, double* out_rmse) {
  KD kd;
  kd.build(dst, n_dst);
  double T[4][4];
  std::memcpy(T, T_io, sizeof(T));

  std::vector<double> a, b;
  double prev_rmse = 1e300;
  int it = 0;
  for (; it < max_iter; ++it) {
    a.clear();
    b.clear();
    double sq_sum = 0;
    int matched = 0;
    for (int i = 0; i < n_src; ++i) {
      const float* p = src + size_t(i) * 3;
      float tp[3];
      for (int r = 0; r < 3; ++r)
        tp[r] = float(T[r][0] * p[0] + T[r][1] * p[1] + T[r][2] * p[2] + T[r][3]);
      int bi;
      float bd2;
      kd.nn(tp, &bi, &bd2);
      if (bd2 <= max_corr_dist * max_corr_dist) {
        ++matched;
        sq_sum += bd2;
        a.push_back(tp[0]); a.push_back(tp[1]); a.push_back(tp[2]);
        const float* q = dst + size_t(bi) * 3;
        b.push_back(q[0]); b.push_back(q[1]); b.push_back(q[2]);
      }
    }
    if (matched < 3) break;
    double rmse = std::sqrt(sq_sum / matched);
    *out_fitness = double(matched) / n_src;
    *out_rmse = rmse;
    if (std::abs(prev_rmse - rmse) < 1e-8) break;
    prev_rmse = rmse;

    // centroids
    int m = matched;
    double ca[3] = {0, 0, 0}, cb[3] = {0, 0, 0};
    for (int i = 0; i < m; ++i)
      for (int d = 0; d < 3; ++d) {
        ca[d] += a[i * 3 + d];
        cb[d] += b[i * 3 + d];
      }
    for (int d = 0; d < 3; ++d) { ca[d] /= m; cb[d] /= m; }
    std::vector<double> ac(m * 3), bc(m * 3);
    for (int i = 0; i < m; ++i)
      for (int d = 0; d < 3; ++d) {
        ac[i * 3 + d] = a[i * 3 + d] - ca[d];
        bc[i * 3 + d] = b[i * 3 + d] - cb[d];
      }
    Mat3 R = weighted_kabsch(ac.data(), bc.data(), nullptr, m);
    double t[3];
    for (int d = 0; d < 3; ++d)
      t[d] = cb[d] - (R.m[d][0] * ca[0] + R.m[d][1] * ca[1] + R.m[d][2] * ca[2]);
    // T = [R t] * T
    double Tn[4][4] = {{0}};
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 4; ++c) {
        Tn[r][c] = R.m[r][0] * T[0][c] + R.m[r][1] * T[1][c] + R.m[r][2] * T[2][c];
      }
      Tn[r][3] += t[r];
    }
    Tn[3][3] = 1.0;
    std::memcpy(T, Tn, sizeof(T));
  }
  std::memcpy(T_io, T, sizeof(T));
  return it;
}

// ---------------------------------------------------------------------------
// EXACT max-clique inlier selection on the TIM consistency graph.
//
// Edge (i, j) iff | |a_i - a_j| - |b_i - b_j| | <= 2 * noise_bound
// (scale-free TIMs with known scale=1, TEASER's invariance test). The
// reference uses PMC exact (helpers.py:62-64); this is a first-party exact
// solver: greedy incumbent -> k-core pruning -> Tomita-style branch &
// bound with greedy-coloring upper bounds over bitset adjacency. A node
// budget caps the worst case; if it trips, the incumbent (>= greedy) is
// returned. Registration consistency graphs (one dominant inlier clique +
// sparse noise edges) solve exactly within a tiny fraction of the budget.
// ---------------------------------------------------------------------------

}  // extern "C"

namespace {

struct CliqueBB {
  int n = 0, words = 0;
  std::vector<uint64_t> adj;   // n rows x words bitset
  std::vector<int> best;
  long long budget = 20'000'000;
  bool exact = true;

  const uint64_t* row(int v) const { return adj.data() + size_t(v) * words; }

  static int first_bit(const std::vector<uint64_t>& bs) {
    for (size_t w = 0; w < bs.size(); ++w)
      if (bs[w]) return int(w * 64 + __builtin_ctzll(bs[w]));
    return -1;
  }
  static void clear_bit(std::vector<uint64_t>& bs, int v) {
    bs[v >> 6] &= ~(1ull << (v & 63));
  }
  static int popcount(const std::vector<uint64_t>& bs) {
    int c = 0;
    for (uint64_t w : bs) c += __builtin_popcountll(w);
    return c;
  }

  // Tomita MCQ: candidates P colored greedily; vertices visited in
  // descending color order with bound |R| + color(v) <= |best|.
  void expand(std::vector<int>& R, std::vector<uint64_t>& P, int pcnt) {
    if (--budget < 0) { exact = false; return; }
    if (pcnt == 0) {
      if (R.size() > best.size()) best = R;
      return;
    }
    std::vector<int> order, colors;
    order.reserve(pcnt);
    colors.reserve(pcnt);
    std::vector<uint64_t> uncolored = P, avail(words);
    int color = 0;
    while (true) {
      int v0 = first_bit(uncolored);
      if (v0 < 0) break;
      ++color;
      avail = uncolored;
      while (true) {
        int v = first_bit(avail);
        if (v < 0) break;
        clear_bit(avail, v);
        clear_bit(uncolored, v);
        const uint64_t* rv = row(v);
        for (int w = 0; w < words; ++w) avail[w] &= ~rv[w];
        order.push_back(v);
        colors.push_back(color);
      }
    }
    std::vector<uint64_t> P2(words);
    for (int i = int(order.size()) - 1; i >= 0; --i) {
      if ((int)R.size() + colors[i] <= (int)best.size()) return;
      int v = order[i];
      const uint64_t* rv = row(v);
      int cnt2 = 0;
      for (int w = 0; w < words; ++w) {
        P2[w] = P[w] & rv[w];
        cnt2 += __builtin_popcountll(P2[w]);
      }
      R.push_back(v);
      std::vector<uint64_t> P2c = P2;
      expand(R, P2c, cnt2);
      R.pop_back();
      if (!exact) return;
      clear_bit(P, v);
    }
  }
};

// Shared driver over a dense uint8 adjacency matrix.
int solve_max_clique(const uint8_t* adj, int n, int* out_idx) {
  if (n <= 0) return 0;
  std::vector<int> deg(n, 0);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      if (i != j && adj[size_t(i) * n + j]) ++deg[i];

  // Greedy incumbent (top-degree seeds, max-connectivity expansion).
  std::vector<int> seeds(n);
  std::iota(seeds.begin(), seeds.end(), 0);
  std::sort(seeds.begin(), seeds.end(),
            [&](int x, int y) { return deg[x] > deg[y]; });
  int n_seeds = std::min(n, 24);
  std::vector<int> best, cand, clique;
  for (int s = 0; s < n_seeds; ++s) {
    int seed = seeds[s];
    clique.assign(1, seed);
    cand.clear();
    for (int j = 0; j < n; ++j)
      if (adj[size_t(seed) * n + j] && j != seed) cand.push_back(j);
    while (!cand.empty()) {
      int best_c = -1, best_score = -1;
      for (int c : cand) {
        int score = 0;
        for (int d : cand) score += adj[size_t(c) * n + d];
        if (score > best_score) { best_score = score; best_c = c; }
      }
      clique.push_back(best_c);
      std::vector<int> next;
      for (int d : cand)
        if (d != best_c && adj[size_t(best_c) * n + d]) next.push_back(d);
      cand.swap(next);
    }
    if (clique.size() > best.size()) best = clique;
  }

  // k-core pruning: a clique larger than |best| needs min degree >= |best|.
  std::vector<uint8_t> alive(n, 1);
  std::vector<int> d = deg;
  bool changed = true;
  while (changed) {
    changed = false;
    for (int i = 0; i < n; ++i) {
      if (alive[i] && d[i] < (int)best.size()) {
        alive[i] = 0;
        changed = true;
        for (int j = 0; j < n; ++j)
          if (alive[j] && adj[size_t(i) * n + j]) --d[j];
      }
    }
  }
  std::vector<int> ids;  // surviving vertices, ordered by degeneracy proxy
  for (int i = 0; i < n; ++i)
    if (alive[i]) ids.push_back(i);
  std::sort(ids.begin(), ids.end(), [&](int x, int y) { return d[x] > d[y]; });

  int m = int(ids.size());
  if (m > (int)best.size()) {
    CliqueBB bb;
    bb.n = m;
    bb.words = (m + 63) / 64;
    bb.adj.assign(size_t(m) * bb.words, 0);
    for (int i = 0; i < m; ++i)
      for (int j = 0; j < m; ++j)
        if (i != j && adj[size_t(ids[i]) * n + ids[j]])
          bb.adj[size_t(i) * bb.words + (j >> 6)] |= 1ull << (j & 63);
    // seed incumbent (indices in compact space don't matter, only size;
    // remap best into compact ids when possible, else keep size-only bound)
    std::vector<int> R;
    std::vector<uint64_t> P(bb.words, 0);
    for (int i = 0; i < m; ++i) P[i >> 6] |= 1ull << (i & 63);
    // use a size-only incumbent: store dummy best of same size
    bb.best.assign(best.size(), -1);
    bb.expand(R, P, m);
    if ((int)bb.best.size() > (int)best.size() && bb.best[0] >= 0) {
      best.clear();
      for (int v : bb.best) best.push_back(ids[v]);
    }
  }

  for (size_t i = 0; i < best.size(); ++i) out_idx[i] = best[i];
  return int(best.size());
}

}  // namespace

extern "C" {

// Exact max clique over a caller-provided dense adjacency (n x n, uint8).
int max_clique_graph(const uint8_t* adj, int n, int* out_idx) {
  return solve_max_clique(adj, n, out_idx);
}

int max_clique_inliers(const float* a, const float* b, int n,
                       float noise_bound, int* out_idx) {
  if (n <= 0) return 0;
  std::vector<uint8_t> adj(size_t(n) * n, 0);
  float tol = 2.0f * noise_bound;
  for (int i = 0; i < n; ++i) {
    for (int j = i + 1; j < n; ++j) {
      double da = 0, db = 0;
      for (int d = 0; d < 3; ++d) {
        double xa = a[i * 3 + d] - a[j * 3 + d];
        double xb = b[i * 3 + d] - b[j * 3 + d];
        da += xa * xa;
        db += xb * xb;
      }
      if (std::abs(std::sqrt(da) - std::sqrt(db)) <= tol)
        adj[size_t(i) * n + j] = adj[size_t(j) * n + i] = 1;
    }
  }
  return solve_max_clique(adj.data(), n, out_idx);
}

// ---------------------------------------------------------------------------
// GNC-TLS rotation + component-wise TLS translation (TEASER-style,
// estimate_scaling=False; ref solver params: helpers.py:54-69 — GNC_TLS,
// cbar2=1, gnc factor 1.4, 100 iters, rel cost tol 1e-12).
//
// src/dst: (n, 3) corresponding points (already max-clique pruned).
// Solves dst ~= R src + t. Writes T (4x4 row-major) and inlier mask.
// ---------------------------------------------------------------------------

int gnc_tls_solve(const float* src, const float* dst, int n,
                  float noise_bound, double* T_out, uint8_t* inlier_mask) {
  if (n < 3) return -1;
  // TIMs: pairwise differences over a chain graph doubled (i, i+1) and
  // (i, i+2) for redundancy.
  std::vector<double> ta, tb;
  auto add_tim = [&](int i, int j) {
    for (int d = 0; d < 3; ++d) {
      ta.push_back(double(src[j * 3 + d]) - src[i * 3 + d]);
      tb.push_back(double(dst[j * 3 + d]) - dst[i * 3 + d]);
    }
  };
  for (int i = 0; i + 1 < n; ++i) add_tim(i, i + 1);
  for (int i = 0; i + 2 < n; ++i) add_tim(i, i + 2);
  add_tim(n - 1, 0);
  int m = int(ta.size() / 3);

  double cbar2 = 1.0;
  double nb2 = double(noise_bound) * noise_bound * cbar2;
  std::vector<double> w(m, 1.0);
  Mat3 R = weighted_kabsch(ta.data(), tb.data(), w.data(), m);

  // initial max residual
  auto residual2 = [&](int i, const Mat3& Rm) {
    double r2 = 0;
    for (int d = 0; d < 3; ++d) {
      double pred = Rm.m[d][0] * ta[i * 3] + Rm.m[d][1] * ta[i * 3 + 1] +
                    Rm.m[d][2] * ta[i * 3 + 2];
      double diff = tb[i * 3 + d] - pred;
      r2 += diff * diff;
    }
    return r2;
  };
  double max_r2 = 0;
  for (int i = 0; i < m; ++i) max_r2 = std::max(max_r2, residual2(i, R));
  double mu = nb2 / (2 * max_r2 - nb2);
  if (mu < 0) mu = 1e-10;

  double prev_cost = 1e300;
  for (int it = 0; it < 100; ++it) {
    double cost = 0;
    for (int i = 0; i < m; ++i) {
      double r2 = residual2(i, R);
      cost += std::min(r2, nb2);
      double th1 = (mu + 1.0) / mu * nb2;
      double th2 = mu / (mu + 1.0) * nb2;
      if (r2 >= th1) w[i] = 0.0;
      else if (r2 <= th2) w[i] = 1.0;
      else w[i] = std::sqrt(nb2 * mu * (mu + 1.0) / r2) - mu;
    }
    R = weighted_kabsch(ta.data(), tb.data(), w.data(), m);
    if (std::abs(cost - prev_cost) < 1e-12 * std::max(prev_cost, 1.0)) break;
    prev_cost = cost;
    mu *= 1.4;
  }

  // Component-wise TLS translation on the original correspondences:
  // consensus-maximizing interval per axis, then inlier mean.
  double t[3];
  std::vector<double> resid(n);
  for (int d = 0; d < 3; ++d) {
    for (int i = 0; i < n; ++i) {
      double pred = R.m[d][0] * src[i * 3] + R.m[d][1] * src[i * 3 + 1] +
                    R.m[d][2] * src[i * 3 + 2];
      resid[i] = dst[i * 3 + d] - pred;
    }
    std::vector<double> sorted_r = resid;
    std::sort(sorted_r.begin(), sorted_r.end());
    int best_cnt = -1, best_lo = 0;
    int hi = 0;
    for (int lo = 0; lo < n; ++lo) {
      if (hi < lo) hi = lo;
      while (hi < n && sorted_r[hi] - sorted_r[lo] <= 2.0 * noise_bound) ++hi;
      if (hi - lo > best_cnt) { best_cnt = hi - lo; best_lo = lo; }
    }
    double acc = 0;
    int lo = best_lo;
    int cnt = best_cnt;
    for (int i = lo; i < lo + cnt; ++i) acc += sorted_r[i];
    t[d] = acc / cnt;
  }

  for (int i = 0; i < n; ++i) {
    double r2 = 0;
    for (int d = 0; d < 3; ++d) {
      double pred = R.m[d][0] * src[i * 3] + R.m[d][1] * src[i * 3 + 1] +
                    R.m[d][2] * src[i * 3 + 2] + t[d];
      double diff = dst[i * 3 + d] - pred;
      r2 += diff * diff;
    }
    inlier_mask[i] = r2 <= 4.0 * nb2 ? 1 : 0;
  }

  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) T_out[r * 4 + c] = R.m[r][c];
    T_out[r * 4 + 3] = t[r];
  }
  T_out[12] = T_out[13] = T_out[14] = 0.0;
  T_out[15] = 1.0;
  return 0;
}

}  // extern "C"
