// geomrl_native — host-side native runtime for geometry_rl_tpu.
//
// The device compute path is JAX/XLA; this library covers the host-side work the
// reference delegated to native code: graph-topology construction (PyG's C++
// kNN kernels, rigid_tasks_data.py:285-319) and a native reference solver for
// the diagonal KL covariance projection (the role ITPAL's cpp_projection
// played, kl_projection_layer.py:162-204) used for cross-checking the XLA
// implementation and for CPU-only deployments.
//
// Plain C ABI (ctypes-loadable; no pybind11 in this image). Build:
//   g++ -O3 -march=native -shared -fPIC -o libgeomrl_native.so geomrl_native.cpp
//
// All matrices are row-major float32/int32.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// kNN graph construction (PyG knn_graph semantics: directed edges j -> i for
// j among i's k nearest, self excluded).
//
// points:    [num_points, 3]
// out_edges: [num_valid * k, 2]  (src, dst) pairs
// returns the number of edges written.
// ---------------------------------------------------------------------------
int64_t knn_graph(const float* points, int64_t num_points, int64_t num_valid,
                  int64_t k, int32_t* out_edges) {
  if (num_valid <= 1 || k <= 0) return 0;
  const int64_t kk = std::min<int64_t>(k, num_valid - 1);
  std::vector<std::pair<float, int32_t>> dists(num_valid);
  int64_t e = 0;
  for (int64_t i = 0; i < num_valid; ++i) {
    const float xi = points[3 * i], yi = points[3 * i + 1], zi = points[3 * i + 2];
    int64_t n = 0;
    for (int64_t j = 0; j < num_valid; ++j) {
      if (j == i) continue;
      const float dx = points[3 * j] - xi;
      const float dy = points[3 * j + 1] - yi;
      const float dz = points[3 * j + 2] - zi;
      dists[n++] = {dx * dx + dy * dy + dz * dz, (int32_t)j};
    }
    std::partial_sort(dists.begin(), dists.begin() + kk, dists.begin() + n);
    for (int64_t m = 0; m < kk; ++m) {
      out_edges[2 * e] = dists[m].second;  // src = neighbor
      out_edges[2 * e + 1] = (int32_t)i;   // dst = node
      ++e;
    }
  }
  return e;
}

// Batched multi-shape topology builder: for S padded shapes emit padded edge
// arrays + masks in one call (the init-time builder for the multi-asset
// mechanism). out_src/out_dst/out_mask: [S, P_max * k].
void knn_graph_batch(const float* points, const int32_t* num_valid, int64_t S,
                     int64_t P_max, int64_t k, int32_t* out_src,
                     int32_t* out_dst, float* out_mask) {
  std::vector<int32_t> edges(P_max * k * 2);
  for (int64_t s = 0; s < S; ++s) {
    const int64_t e = knn_graph(points + s * P_max * 3, P_max, num_valid[s], k,
                                edges.data());
    const int64_t base = s * P_max * k;
    for (int64_t m = 0; m < P_max * k; ++m) {
      if (m < e) {
        out_src[base + m] = edges[2 * m];
        out_dst[base + m] = edges[2 * m + 1];
        out_mask[base + m] = 1.0f;
      } else {
        out_src[base + m] = 0;
        out_dst[base + m] = 0;
        out_mask[base + m] = 0.0f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Edges from triangle faces with deduplication (tasks/common/utils.py
// extract_edges_from_faces). faces: [num_faces, 3]; out_edges capacity must
// be >= num_faces * 3 * 2 ints. Returns number of unique undirected edges.
// ---------------------------------------------------------------------------
int64_t edges_from_faces(const int32_t* faces, int64_t num_faces,
                         int32_t* out_edges) {
  std::vector<int64_t> keys;
  keys.reserve(num_faces * 3);
  for (int64_t f = 0; f < num_faces; ++f) {
    const int32_t v[3] = {faces[3 * f], faces[3 * f + 1], faces[3 * f + 2]};
    for (int c = 0; c < 3; ++c) {
      int32_t a = v[c], b = v[(c + 1) % 3];
      if (a > b) std::swap(a, b);
      keys.push_back(((int64_t)a << 32) | (uint32_t)b);
    }
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  for (size_t m = 0; m < keys.size(); ++m) {
    out_edges[2 * m] = (int32_t)(keys[m] >> 32);
    out_edges[2 * m + 1] = (int32_t)(keys[m] & 0xffffffff);
  }
  return (int64_t)keys.size();
}

// ---------------------------------------------------------------------------
// Diagonal KL covariance projection — native reference solver.
//
// Per batch row: find eta >= 0 with KLcov(v*(eta) || v_old) = eps where
// 1/v*_i = (1/v_i + eta/v_old_i) / (1 + eta); Newton on log1p(eta) with
// bisection safeguarding. Matches geometry_rl_tpu.rl.projections.kl.
//
// var, old_var: [batch, dim]; eps: [batch]; out: [batch, dim].
// ---------------------------------------------------------------------------
static double kl_cov(const float* vp, const float* vq, int64_t dim) {
  double acc = 0.0;
  for (int64_t i = 0; i < dim; ++i) {
    const double r = (double)vp[i] / (double)vq[i];
    acc += r - 1.0 - std::log(r);
  }
  return 0.5 * acc;
}

void diag_kl_project(const float* var, const float* old_var, const float* eps,
                     int64_t batch, int64_t dim, float* out) {
  std::vector<float> tmp(dim);
  for (int64_t b = 0; b < batch; ++b) {
    const float* v = var + b * dim;
    const float* vo = old_var + b * dim;
    float* o = out + b * dim;
    if (kl_cov(v, vo, dim) <= eps[b]) {
      std::copy(v, v + dim, o);
      continue;
    }
    double lo = 0.0, hi = 1e12;
    for (int iter = 0; iter < 200; ++iter) {
      const double mid = std::expm1(0.5 * (std::log1p(lo) + std::log1p(hi)));
      for (int64_t i = 0; i < dim; ++i)
        tmp[i] = (float)((1.0 + mid) / (1.0 / v[i] + mid / vo[i]));
      if (kl_cov(tmp.data(), vo, dim) > eps[b])
        lo = mid;
      else
        hi = mid;
    }
    const double eta = 0.5 * (lo + hi);
    for (int64_t i = 0; i < dim; ++i)
      o[i] = (float)((1.0 + eta) / (1.0 / v[i] + eta / vo[i]));
  }
}

// ---------------------------------------------------------------------------
// Polygon SDF batch evaluation (contact precomputation / debugging).
// verts: [K, 2] padded by repeating the first vertex; q: [N, 2]; out: [N].
// ---------------------------------------------------------------------------
void polygon_sdf(const float* verts, int64_t K, const float* q, int64_t N,
                 float* out) {
  for (int64_t n = 0; n < N; ++n) {
    const float px = q[2 * n], py = q[2 * n + 1];
    float best = 1e30f;
    bool inside = false;
    for (int64_t k = 0; k < K; ++k) {
      const int64_t k2 = (k + 1) % K;
      const float ax = verts[2 * k], ay = verts[2 * k + 1];
      const float bx = verts[2 * k2], by = verts[2 * k2 + 1];
      const float ex = bx - ax, ey = by - ay;
      const float wx = px - ax, wy = py - ay;
      const float ee = std::max(ex * ex + ey * ey, 1e-12f);
      const float t = std::min(1.0f, std::max(0.0f, (wx * ex + wy * ey) / ee));
      const float dx = wx - t * ex, dy = wy - t * ey;
      best = std::min(best, dx * dx + dy * dy);
      if (((ay <= py) != (by <= py))) {
        const float xint = ax + (py - ay) / (ey == 0.0f ? 1e-12f : ey) * ex;
        if (px < xint) inside = !inside;
      }
    }
    out[n] = inside ? -std::sqrt(best) : std::sqrt(best);
  }
}

}  // extern "C"
