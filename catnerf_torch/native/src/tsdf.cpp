// tsdf.cpp — hashed truncated signed distance fusion + surface extraction.
//
// First-party replacement for Open3D ScalableTSDFVolume
// (ref: src/utils.py:212-247: voxel_length, sdf_trunc = 4 * voxel, RGB8
// color, integrate(rgbd, intrinsic, T_CW), extract_point_cloud()).
//
// Integration projects each allocated voxel into the depth image
// (projective TSDF, same as Open3D); voxels are allocated by marching the
// truncation band along each valid depth pixel's ray. Extraction emits one
// point per voxel at a zero crossing (tsdf sign change vs +x/+y/+z
// neighbor), linearly interpolated, with its fused color.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <unordered_map>
#include <vector>

namespace {

struct Voxel {
  float tsdf = 0.0f;
  float weight = 0.0f;
  float r = 0, g = 0, b = 0;
};

inline int64_t vkey(int x, int y, int z) {
  // pack 21-bit signed coords
  auto u = [](int v) { return uint64_t(v + (1 << 20)) & 0x1FFFFF; };
  return int64_t((u(x) << 42) | (u(y) << 21) | u(z));
}

struct TSDFVolume {
  float voxel;
  float trunc;
  std::unordered_map<int64_t, Voxel> voxels;
};

}  // namespace

extern "C" {

void* tsdf_create(float voxel_length, float sdf_trunc) {
  auto* v = new TSDFVolume();
  v->voxel = voxel_length;
  v->trunc = sdf_trunc;
  return v;
}

void tsdf_destroy(void* vol) { delete static_cast<TSDFVolume*>(vol); }

// depth: (w, h) meters, 0 = invalid (transposed W,H layout like the rest of
// the pipeline); color: (w, h, 3) uint8; T_CW: 4x4 row-major world->camera.
void tsdf_integrate(void* vol_, const float* depth, const uint8_t* color,
                    int w, int h, float fx, float fy, float cx, float cy,
                    const double* T_CW, float max_depth) {
  auto* vol = static_cast<TSDFVolume*>(vol_);
  const float vox = vol->voxel, trunc = vol->trunc;

  // camera->world for ray marching allocation
  double R[3][3] = {{T_CW[0], T_CW[1], T_CW[2]},
                    {T_CW[4], T_CW[5], T_CW[6]},
                    {T_CW[8], T_CW[9], T_CW[10]}};
  double tcw[3] = {T_CW[3], T_CW[7], T_CW[11]};
  // inverse (rigid): R_wc = R^T, t_wc = -R^T t
  double Rwc[3][3], twc[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Rwc[i][j] = R[j][i];
  for (int i = 0; i < 3; ++i)
    twc[i] = -(Rwc[i][0] * tcw[0] + Rwc[i][1] * tcw[1] + Rwc[i][2] * tcw[2]);

  // Pass 1: allocate voxels in the truncation band along each pixel ray.
  for (int u = 0; u < w; ++u) {
    for (int v = 0; v < h; ++v) {
      float d = depth[size_t(u) * h + v];
      if (d <= 0 || d > max_depth) continue;
      double dir_c[3] = {(u - cx) / fx, (v - cy) / fy, 1.0};
      // step in camera z such that the WORLD-space stride along the ray
      // stays vox/2: a border pixel's |dir_c| reaches ~1.4, so a plain
      // vox/2 z-step would stride ~0.7*vox along the ray and can skip
      // band voxels at steep incidence (pinholes in the extraction)
      double dn = std::sqrt(dir_c[0] * dir_c[0] + dir_c[1] * dir_c[1] + 1.0);
      float dz = float(vox * 0.5 / dn);
      for (float z = d - trunc; z <= d + trunc; z += dz) {
        if (z <= 0) continue;
        double pc[3] = {dir_c[0] * z, dir_c[1] * z, z};
        double pw[3];
        for (int i = 0; i < 3; ++i)
          pw[i] = Rwc[i][0] * pc[0] + Rwc[i][1] * pc[1] + Rwc[i][2] * pc[2] +
                  twc[i];
        int ix = int(std::floor(pw[0] / vox));
        int iy = int(std::floor(pw[1] / vox));
        int iz = int(std::floor(pw[2] / vox));
        vol->voxels.emplace(vkey(ix, iy, iz), Voxel{});
      }
    }
  }

  // Pass 2: projective TSDF update of every allocated voxel.
  for (auto& kv : vol->voxels) {
    int64_t key = kv.first;
    int ix = int(((key >> 42) & 0x1FFFFF)) - (1 << 20);
    int iy = int(((key >> 21) & 0x1FFFFF)) - (1 << 20);
    int iz = int((key & 0x1FFFFF)) - (1 << 20);
    double pw[3] = {(ix + 0.5) * vox, (iy + 0.5) * vox, (iz + 0.5) * vox};
    double pc[3];
    for (int i = 0; i < 3; ++i)
      pc[i] = R[i][0] * pw[0] + R[i][1] * pw[1] + R[i][2] * pw[2] + tcw[i];
    if (pc[2] <= 0) continue;
    // bounds-check in double BEFORE the int cast: a voxel center a hair
    // in front of the camera plane projects to ~1e10 and double->int of
    // an out-of-range value is undefined behavior
    double du = pc[0] / pc[2] * fx + cx;
    double dv = pc[1] / pc[2] * fy + cy;
    if (!(du >= -0.49 && du <= w - 0.51 && dv >= -0.49 && dv <= h - 0.51))
      continue;
    int u = int(std::round(du));
    int v = int(std::round(dv));
    float d = depth[size_t(u) * h + v];
    if (d <= 0 || d > max_depth) continue;
    float sdf = d - float(pc[2]);
    if (sdf < -vol->trunc) continue;
    float tsdf = std::min(1.0f, sdf / vol->trunc);
    Voxel& vx = kv.second;
    float wnew = vx.weight + 1.0f;
    vx.tsdf = (vx.tsdf * vx.weight + tsdf) / wnew;
    if (color) {
      const uint8_t* c = color + (size_t(u) * h + v) * 3;
      vx.r = (vx.r * vx.weight + c[0]) / wnew;
      vx.g = (vx.g * vx.weight + c[1]) / wnew;
      vx.b = (vx.b * vx.weight + c[2]) / wnew;
    }
    vx.weight = wnew;
  }
}

// Extract surface points at zero crossings. Returns count; caller frees via
// geom_free.
int64_t tsdf_extract_points(void* vol_, float** out_pts, float** out_colors) {
  auto* vol = static_cast<TSDFVolume*>(vol_);
  std::vector<float> pts, cols;
  const float vox = vol->voxel;
  for (auto& kv : vol->voxels) {
    const Voxel& v0 = kv.second;
    if (v0.weight <= 0) continue;
    int64_t key = kv.first;
    int ix = int(((key >> 42) & 0x1FFFFF)) - (1 << 20);
    int iy = int(((key >> 21) & 0x1FFFFF)) - (1 << 20);
    int iz = int((key & 0x1FFFFF)) - (1 << 20);
    const int nbr[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
    for (int a = 0; a < 3; ++a) {
      auto it = vol->voxels.find(
          vkey(ix + nbr[a][0], iy + nbr[a][1], iz + nbr[a][2]));
      if (it == vol->voxels.end() || it->second.weight <= 0) continue;
      const Voxel& v1 = it->second;
      if ((v0.tsdf > 0) == (v1.tsdf > 0)) continue;
      float t = v0.tsdf / (v0.tsdf - v1.tsdf);
      float p[3] = {(ix + 0.5f) * vox, (iy + 0.5f) * vox, (iz + 0.5f) * vox};
      p[a] += t * vox;
      pts.push_back(p[0]);
      pts.push_back(p[1]);
      pts.push_back(p[2]);
      cols.push_back((v0.r + t * (v1.r - v0.r)) / 255.0f);
      cols.push_back((v0.g + t * (v1.g - v0.g)) / 255.0f);
      cols.push_back((v0.b + t * (v1.b - v0.b)) / 255.0f);
    }
  }
  int64_t n = int64_t(pts.size() / 3);
  *out_pts = (float*)std::malloc(pts.size() * sizeof(float));
  *out_colors = (float*)std::malloc(cols.size() * sizeof(float));
  std::memcpy(*out_pts, pts.data(), pts.size() * sizeof(float));
  std::memcpy(*out_colors, cols.data(), cols.size() * sizeof(float));
  return n;
}

}  // extern "C"
