// Isosurface extraction from a dense scalar grid (host-side, C++).
//
// Fills the role of the reference's libmcubes (stage1/utils/libmcubes,
// mcubes.pyx:21-26: dense double grid + iso level -> vertices/triangles in
// grid-index coordinates). Implementation is marching TETRAHEDRA (6 tets per
// cell around the main diagonal) rather than tabulated marching cubes: the
// case analysis is derived from first principles in ~40 lines (no imported
// triangle tables), is watertight across the diagonal decomposition, and
// converges to the same isosurface — at 512^3 extraction resolution the
// Chamfer difference vs tabulated MC is far below the evaluation noise floor.
//
// Vertices are emitted on cell edges at linear interpolation of the iso
// crossing, welded via an edge-keyed hash map. Triangles are oriented so
// the right-hand normal points toward LOWER field values (outward when the
// field is an inside-positive occupancy logit).

#include <cstdint>
#include <cstdlib>
#include <unordered_map>
#include <vector>

namespace {

template <typename T>
struct Mesher {
  const T* g;
  int64_t nx, ny, nz;
  double iso;
  std::vector<double> verts;    // x,y,z triples
  std::vector<int64_t> tris;    // index triples
  std::unordered_map<uint64_t, int64_t> edge_vert;

  double at(int64_t x, int64_t y, int64_t z) const {
    return (double)g[(x * ny + y) * nz + z];
  }
  uint64_t corner_id(int64_t x, int64_t y, int64_t z) const {
    return (uint64_t)((x * (ny + 1) + y) * (nz + 1) + z);
  }

  // vertex on the edge between corners a and b (grid coords), welded
  int64_t edge_vertex(const int64_t a[3], const int64_t b[3]) {
    uint64_t ka = corner_id(a[0], a[1], a[2]);
    uint64_t kb = corner_id(b[0], b[1], b[2]);
    // corner ids < 2^32 for any practical grid -> sorted pair packs uniquely
    uint64_t lo = ka < kb ? ka : kb, hi = ka < kb ? kb : ka;
    uint64_t key = (lo << 32) | hi;
    auto it = edge_vert.find(key);
    if (it != edge_vert.end()) return it->second;
    double va = at(a[0], a[1], a[2]), vb = at(b[0], b[1], b[2]);
    double t = (va == vb) ? 0.5 : (iso - va) / (vb - va);
    if (t < 0) t = 0;
    if (t > 1) t = 1;
    int64_t vid = (int64_t)(verts.size() / 3);
    for (int d = 0; d < 3; d++)
      verts.push_back((double)a[d] + t * ((double)b[d] - (double)a[d]));
    edge_vert.emplace(key, vid);
    return vid;
  }

  void emit(int64_t v0, int64_t v1, int64_t v2, const double* toward_out) {
    // orient: right-hand normal should point along toward_out
    const double* p0 = &verts[3 * v0];
    const double* p1 = &verts[3 * v1];
    const double* p2 = &verts[3 * v2];
    double e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
    double e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
    double n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                   e1[2] * e2[0] - e1[0] * e2[2],
                   e1[0] * e2[1] - e1[1] * e2[0]};
    double dot = n[0] * toward_out[0] + n[1] * toward_out[1] + n[2] * toward_out[2];
    if (dot >= 0) {
      tris.push_back(v0); tris.push_back(v1); tris.push_back(v2);
    } else {
      tris.push_back(v0); tris.push_back(v2); tris.push_back(v1);
    }
  }

  void do_tet(const int64_t c[4][3]) {
    double v[4];
    int inside = 0, in_idx[4], out_idx[4], n_in = 0, n_out = 0;
    for (int i = 0; i < 4; i++) {
      v[i] = at(c[i][0], c[i][1], c[i][2]);
      if (v[i] > iso) { in_idx[n_in++] = i; inside++; }
      else out_idx[n_out++] = i;
    }
    if (inside == 0 || inside == 4) return;

    // outward direction: centroid(outside corners) - centroid(inside corners)
    double ci[3] = {0, 0, 0}, co[3] = {0, 0, 0}, dir[3];
    for (int i = 0; i < n_in; i++)
      for (int d = 0; d < 3; d++) ci[d] += (double)c[in_idx[i]][d] / n_in;
    for (int i = 0; i < n_out; i++)
      for (int d = 0; d < 3; d++) co[d] += (double)c[out_idx[i]][d] / n_out;
    for (int d = 0; d < 3; d++) dir[d] = co[d] - ci[d];

    if (inside == 1) {
      int a = in_idx[0];
      int64_t e0 = edge_vertex(c[a], c[out_idx[0]]);
      int64_t e1 = edge_vertex(c[a], c[out_idx[1]]);
      int64_t e2 = edge_vertex(c[a], c[out_idx[2]]);
      emit(e0, e1, e2, dir);
    } else if (inside == 3) {
      int a = out_idx[0];
      int64_t e0 = edge_vertex(c[in_idx[0]], c[a]);
      int64_t e1 = edge_vertex(c[in_idx[1]], c[a]);
      int64_t e2 = edge_vertex(c[in_idx[2]], c[a]);
      emit(e0, e1, e2, dir);
    } else {  // 2 in, 2 out -> quad = 2 triangles
      int a = in_idx[0], b = in_idx[1], p = out_idx[0], q = out_idx[1];
      int64_t eap = edge_vertex(c[a], c[p]);
      int64_t eaq = edge_vertex(c[a], c[q]);
      int64_t ebp = edge_vertex(c[b], c[p]);
      int64_t ebq = edge_vertex(c[b], c[q]);
      // quad vertex ring: eap -> eaq -> ebq -> ebp
      emit(eap, eaq, ebq, dir);
      emit(eap, ebq, ebp, dir);
    }
  }

  void run() {
    // 6-tet decomposition of each cell around diagonal v0=(0,0,0)-v6=(1,1,1);
    // every tet contains the diagonal, which makes faces consistent between
    // neighboring cells (shared cell faces are split along the same diagonal)
    static const int corners[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                                      {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
    static const int tets[6][4] = {{0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
                                   {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6}};
    for (int64_t x = 0; x + 1 < nx; x++)
      for (int64_t y = 0; y + 1 < ny; y++)
        for (int64_t z = 0; z + 1 < nz; z++) {
          // quick reject: all 8 corners same side
          bool any_in = false, any_out = false;
          for (int i = 0; i < 8; i++) {
            double v = at(x + corners[i][0], y + corners[i][1], z + corners[i][2]);
            if (v > iso) any_in = true; else any_out = true;
          }
          if (!any_in || !any_out) continue;
          for (int t = 0; t < 6; t++) {
            int64_t c[4][3];
            for (int i = 0; i < 4; i++) {
              const int* off = corners[tets[t][i]];
              c[i][0] = x + off[0];
              c[i][1] = y + off[1];
              c[i][2] = z + off[2];
            }
            do_tet(c);
          }
        }
  }
};

// type-erased result so the C API serves both grid dtypes (the extraction
// pipeline keeps the dense grid in float32 end-to-end on a 1-core host —
// half the memory traffic of the round-3 double path)
struct Result {
  std::vector<double> verts;
  std::vector<int64_t> tris;
};

template <typename T>
Result* run_mesher(const T* grid, int64_t nx, int64_t ny, int64_t nz,
                   double iso) {
  Mesher<T> m{grid, nx, ny, nz, iso};
  m.run();
  return new Result{std::move(m.verts), std::move(m.tris)};
}

}  // namespace

extern "C" {

// Returns handle; caller reads counts, then copies, then frees.
void* iso_run(const double* grid, int64_t nx, int64_t ny, int64_t nz,
              double iso) {
  return run_mesher<double>(grid, nx, ny, nz, iso);
}
void* iso_run_f32(const float* grid, int64_t nx, int64_t ny, int64_t nz,
                  double iso) {
  return run_mesher<float>(grid, nx, ny, nz, iso);
}
int64_t iso_n_verts(void* h) { return (int64_t)(((Result*)h)->verts.size() / 3); }
int64_t iso_n_tris(void* h) { return (int64_t)(((Result*)h)->tris.size() / 3); }
void iso_copy(void* h, double* verts_out, int64_t* tris_out) {
  Result* m = (Result*)h;
  std::copy(m->verts.begin(), m->verts.end(), verts_out);
  std::copy(m->tris.begin(), m->tris.end(), tris_out);
}
void iso_free(void* h) { delete (Result*)h; }

}  // extern "C"
