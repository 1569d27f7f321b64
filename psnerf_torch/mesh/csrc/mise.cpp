// MISE: Multi-resolution IsoSurface Extraction octree (host-side, C++).
//
// TPU-native equivalent of the reference's Cython octree
// (stage1/utils/libmise/mise.pyx:34-370): the octree lives on the host and
// batches unknown-point queries through the accelerator-side occupancy field;
// only voxels whose neighborhood straddles the threshold subdivide.
//
// Faithful semantics:
//   * initial lattice: (res0+1)^3 points at stride 2^depth (final-res coords)
//   * update() marks values, then every leaf voxel adjacent to BOTH a known
//     value >= thresh and a known value <= thresh (via the 8 cells incident
//     to each known point) subdivides, creating the 3^3 child lattice
//   * to_dense() writes known values into a (res+1)^3 grid and fills NaNs by
//     propagation along x, then y, then z (mise.pyx:131-165)
//
// Exposed through a plain C API for ctypes (no pybind11 in this image).

#include <cmath>
#include <limits>
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Voxel {
  int x, y, z;       // lower corner, final-res coords
  int level;
  bool is_leaf;
  int64_t child0;    // index of first of 8 children (contiguous), -1 if none
};

struct Mise {
  int res0, depth, res;   // res = res0 << depth
  double thresh;
  std::vector<Voxel> voxels;
  std::unordered_map<int64_t, double> value;   // point key -> value
  std::vector<int64_t> unknown;                // point keys awaiting values

  int64_t pkey(int x, int y, int z) const {
    return ((int64_t)x * (res + 1) + y) * (res + 1) + z;
  }
  void punpack(int64_t k, int* x, int* y, int* z) const {
    *z = (int)(k % (res + 1));
    k /= (res + 1);
    *y = (int)(k % (res + 1));
    *x = (int)(k / (res + 1));
  }

  Mise(int r0, int d, double t) : res0(r0), depth(d), res(r0 << d), thresh(t) {
    int vs0 = 1 << depth;
    voxels.reserve((size_t)res0 * res0 * res0);
    for (int i = 0; i < res0; i++)
      for (int j = 0; j < res0; j++)
        for (int k = 0; k < res0; k++)
          voxels.push_back({i * vs0, j * vs0, k * vs0, 0, true, -1});
    for (int i = 0; i <= res0; i++)
      for (int j = 0; j <= res0; j++)
        for (int k = 0; k <= res0; k++)
          add_point(i * vs0, j * vs0, k * vs0);
  }

  void add_point(int x, int y, int z) {
    int64_t k = pkey(x, y, z);
    if (value.count(k)) return;
    value.emplace(k, std::nan(""));
    unknown.push_back(k);
  }

  // leaf voxel containing final-res cell (cx, cy, cz), or -1
  int64_t leaf_at(int cx, int cy, int cz) const {
    if (cx < 0 || cy < 0 || cz < 0 || cx >= res || cy >= res || cz >= res)
      return -1;
    int vs0 = 1 << depth;
    int64_t idx =
        (((int64_t)(cx / vs0) * res0) + (cy / vs0)) * res0 + (cz / vs0);
    while (!voxels[idx].is_leaf) {
      const Voxel& v = voxels[idx];
      int half = 1 << (depth - v.level - 1);
      int i = (cx - v.x) >= half, j = (cy - v.y) >= half,
          k = (cz - v.z) >= half;
      idx = v.child0 + ((i * 2 + j) * 2 + k);
    }
    return idx;
  }

  void update(const int64_t* pts, const double* vals, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
      int64_t k = pkey((int)pts[3 * i], (int)pts[3 * i + 1], (int)pts[3 * i + 2]);
      auto it = value.find(k);
      if (it == value.end()) continue;  // point not in grid (caller bug)
      it->second = vals[i];
    }
    unknown.clear();
    subdivide();
  }

  void subdivide() {
    // mark leaves adjacent to >=thresh and <=thresh known points
    std::unordered_set<int64_t> pos, neg;
    for (const auto& kv : value) {
      if (std::isnan(kv.second)) continue;
      int x, y, z;
      punpack(kv.first, &x, &y, &z);
      for (int i = -1; i <= 0; i++)
        for (int j = -1; j <= 0; j++)
          for (int k = -1; k <= 0; k++) {
            int64_t vi = leaf_at(x + i, y + j, z + k);
            if (vi < 0) continue;
            if (kv.second >= thresh) pos.insert(vi);
            if (kv.second <= thresh) neg.insert(vi);
          }
    }
    std::vector<int64_t> to_split;
    for (int64_t vi : pos)
      if (neg.count(vi) && voxels[vi].level < depth) to_split.push_back(vi);
    for (int64_t vi : to_split) split(vi);
  }

  void split(int64_t idx) {
    Voxel v = voxels[idx];
    int ns = 1 << (depth - v.level - 1);
    voxels[idx].is_leaf = false;
    voxels[idx].child0 = (int64_t)voxels.size();
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++)
        for (int k = 0; k < 2; k++)
          voxels.push_back(
              {v.x + i * ns, v.y + j * ns, v.z + k * ns, v.level + 1, true, -1});
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++)
        for (int k = 0; k < 3; k++)
          add_point(v.x + i * ns, v.y + j * ns, v.z + k * ns);
  }

  template <typename T>
  void to_dense_t(T* out) const {
    // single-core host: keep the fill vectorizable (branchless selects, the
    // x/y passes carry no dependency along the inner contiguous axis)
    int n = res + 1;
    size_t total = (size_t)n * n * n;
    const T NaN = std::numeric_limits<T>::quiet_NaN();
    std::fill(out, out + total, NaN);
    for (const auto& kv : value) {
      int x, y, z;
      punpack(kv.first, &x, &y, &z);
      out[((size_t)x * n + y) * n + z] = (T)kv.second;
    }
    // propagate along x, then y, then z (reference order)
    const size_t nn = (size_t)n * n;
    for (int i = 1; i < n; i++) {
      T* cur = out + (size_t)i * nn;
      const T* prev = cur - nn;
#pragma GCC ivdep
      for (size_t o = 0; o < nn; o++) {
        T v = cur[o];
        cur[o] = std::isnan(v) ? prev[o] : v;
      }
    }
    for (int i = 0; i < n; i++)
      for (int j = 1; j < n; j++) {
        T* cur = out + (size_t)i * nn + (size_t)j * n;
        const T* prev = cur - n;
#pragma GCC ivdep
        for (int k = 0; k < n; k++) {
          T v = cur[k];
          cur[k] = std::isnan(v) ? prev[k] : v;
        }
      }
    for (size_t row = 0; row < (size_t)n * n; row++) {
      T* line = out + row * n;
      for (int k = 1; k < n; k++)
        if (std::isnan(line[k])) line[k] = line[k - 1];
    }
  }
  void to_dense(double* out) const { to_dense_t<double>(out); }
};

}  // namespace

extern "C" {

void* mise_new(int res0, int depth, double thresh) {
  return new Mise(res0, depth, thresh);
}
void mise_free(void* h) { delete (Mise*)h; }
int mise_resolution(void* h) { return ((Mise*)h)->res; }

int64_t mise_query_count(void* h) { return (int64_t)((Mise*)h)->unknown.size(); }

void mise_query(void* h, int64_t* out) {
  Mise* m = (Mise*)h;
  for (size_t i = 0; i < m->unknown.size(); i++) {
    int x, y, z;
    m->punpack(m->unknown[i], &x, &y, &z);
    out[3 * i] = x;
    out[3 * i + 1] = y;
    out[3 * i + 2] = z;
  }
}

void mise_update(void* h, const int64_t* pts, const double* vals, int64_t n) {
  ((Mise*)h)->update(pts, vals, n);
}

void mise_to_dense_f32(void* h, float* out) {
  ((Mise*)h)->to_dense_t<float>(out);
}
void mise_to_dense(void* h, double* out) { ((Mise*)h)->to_dense(out); }

}  // extern "C"
