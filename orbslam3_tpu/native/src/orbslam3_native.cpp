// Native host-runtime kernels for orbslam3-tpu.
//
// The device owns the dense per-pixel/per-keypoint compute (JAX); these
// are the *host-side* sequential hot loops, implemented natively where the
// reference keeps them in C++ (role-parity):
//  - distribute_octree: the exact recursive quadtree keypoint spreading
//    (reference ORBextractor::DistributeOctTree semantics,
//    /root/reference/src/ORBextractor.cc:584-774) — kept as the parity
//    oracle for the device grid-top-K selection and usable as a drop-in.
//  - hamming_knn: brute-force 256-bit Hamming k-nearest-neighbors with
//    hardware popcount (ORBmatcher::DescriptorDistance role at batch scale,
//    used by the fisheye BFMatcher-style path).
//  - hamming_radius_count: candidate counting for inverted-file queries.
//
// Built as a plain C ABI shared library; Python binds via ctypes
// (orbslam3_tpu/native/__init__.py) with a pure-NumPy fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <list>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// distribute_octree
// ---------------------------------------------------------------------------
struct Node {
  int ul_x, ul_y, br_x, br_y;  // integer node bounds (oracle semantics)
  std::vector<int> idx;
  bool no_more = false;
};

// kps: n x 3 floats (x, y, response) in crop coordinates.
// out_idx: caller-allocated buffer of size n; returns number selected.
int distribute_octree(const float* kps, int n, int min_x, int max_x, int min_y,
                      int max_y, int target, int* out_idx) {
  if (n <= 0) return 0;
  const double w = double(max_x - min_x);
  const double h = double(max_y - min_y);
  int n_ini = std::max(1, int(std::lround(w / h)));
  const double hx = w / n_ini;

  std::list<Node> nodes;
  std::vector<Node*> ini(n_ini);
  for (int i = 0; i < n_ini; ++i) {
    Node nd;
    nd.ul_x = int(hx * i);
    nd.ul_y = 0;
    nd.br_x = int(hx * (i + 1));
    nd.br_y = max_y - min_y;
    nodes.push_back(std::move(nd));
    ini[i] = &nodes.back();
  }
  for (int i = 0; i < n; ++i) {
    int b = std::min(n_ini - 1, int(kps[3 * i] / hx));
    ini[b]->idx.push_back(i);
  }
  for (auto it = nodes.begin(); it != nodes.end();) {
    if (it->idx.empty()) {
      it = nodes.erase(it);
    } else {
      if (it->idx.size() == 1) it->no_more = true;
      ++it;
    }
  }

  auto divide = [&kps](const Node& nd, Node out[4]) {
    const int half_x = int(std::ceil((nd.br_x - nd.ul_x) / 2.0));
    const int half_y = int(std::ceil((nd.br_y - nd.ul_y) / 2.0));
    const int cx = nd.ul_x + half_x;
    const int cy = nd.ul_y + half_y;
    out[0] = {nd.ul_x, nd.ul_y, cx, cy, {}, false};
    out[1] = {cx, nd.ul_y, nd.br_x, cy, {}, false};
    out[2] = {nd.ul_x, cy, cx, nd.br_y, {}, false};
    out[3] = {cx, cy, nd.br_x, nd.br_y, {}, false};
    for (int i : nd.idx) {
      const float x = kps[3 * i], y = kps[3 * i + 1];
      int q = (x < cx ? 0 : 1) + (y < cy ? 0 : 2);
      out[q].idx.push_back(i);
    }
    for (int q = 0; q < 4; ++q)
      if (out[q].idx.size() == 1) out[q].no_more = true;
  };

  bool finished = false;
  std::vector<std::pair<int, Node*>> to_expand;
  while (!finished) {
    const size_t prev_size = nodes.size();
    to_expand.clear();
    // oracle iterates the node list in order, appending surviving no_more
    // nodes and PREPENDING children (insert(0, c) per child -> reversed)
    std::list<Node> new_nodes;
    for (auto it = nodes.begin(); it != nodes.end(); ++it) {
      if (it->no_more) {
        new_nodes.push_back(std::move(*it));
        continue;
      }
      Node kids[4];
      divide(*it, kids);
      for (int q = 0; q < 4; ++q) {
        if (kids[q].idx.empty()) continue;
        new_nodes.push_front(std::move(kids[q]));
        if (new_nodes.front().idx.size() > 1)
          to_expand.emplace_back(int(new_nodes.front().idx.size()),
                                 &new_nodes.front());
      }
    }
    nodes = std::move(new_nodes);
    if (int(nodes.size()) >= target || nodes.size() == prev_size) {
      finished = true;
    } else if (int(nodes.size()) + 3 * int(to_expand.size()) > target) {
      // expand biggest-first (stable by insertion order on ties)
      while (!finished) {
        const size_t prev2 = nodes.size();
        auto prev_expand = to_expand;
        to_expand.clear();
        std::stable_sort(prev_expand.begin(), prev_expand.end(),
                         [](auto& a, auto& b) { return a.first < b.first; });
        for (auto pit = prev_expand.rbegin(); pit != prev_expand.rend(); ++pit) {
          // remove the parent first (oracle: nodes.remove(nd) precedes insert)
          Node parent;
          for (auto it = nodes.begin(); it != nodes.end(); ++it) {
            if (&*it == pit->second) {
              parent = std::move(*it);
              nodes.erase(it);
              break;
            }
          }
          Node kids[4];
          divide(parent, kids);
          for (int q = 0; q < 4; ++q) {
            if (kids[q].idx.empty()) continue;
            nodes.push_front(std::move(kids[q]));
            if (nodes.front().idx.size() > 1)
              to_expand.emplace_back(int(nodes.front().idx.size()),
                                     &nodes.front());
          }
          if (int(nodes.size()) >= target) break;
        }
        if (int(nodes.size()) >= target || nodes.size() == prev2)
          finished = true;
      }
    }
  }

  int out_n = 0;
  for (const auto& nd : nodes) {
    int best = nd.idx[0];
    float best_r = kps[3 * best + 2];
    for (int i : nd.idx) {
      if (kps[3 * i + 2] > best_r) {
        best_r = kps[3 * i + 2];
        best = i;
      }
    }
    out_idx[out_n++] = best;
  }
  return out_n;
}

// ---------------------------------------------------------------------------
// hamming_knn: for each descriptor in A (na x 32 bytes), the k nearest in B.
// out_idx/out_dist: na x k, row-major; missing neighbors get idx -1.
// ---------------------------------------------------------------------------
void hamming_knn(const uint8_t* a, int na, const uint8_t* b, int nb, int k,
                 int32_t* out_idx, int32_t* out_dist) {
  const uint64_t* a64 = reinterpret_cast<const uint64_t*>(a);
  const uint64_t* b64 = reinterpret_cast<const uint64_t*>(b);
  std::vector<int32_t> dists(nb);
  for (int i = 0; i < na; ++i) {
    const uint64_t* ai = a64 + 4 * i;
    for (int j = 0; j < nb; ++j) {
      const uint64_t* bj = b64 + 4 * j;
      dists[j] = __builtin_popcountll(ai[0] ^ bj[0]) +
                 __builtin_popcountll(ai[1] ^ bj[1]) +
                 __builtin_popcountll(ai[2] ^ bj[2]) +
                 __builtin_popcountll(ai[3] ^ bj[3]);
    }
    for (int kk = 0; kk < k; ++kk) {
      int best = -1, best_d = 1 << 30;
      for (int j = 0; j < nb; ++j) {
        if (dists[j] < best_d) {
          best_d = dists[j];
          best = j;
        }
      }
      out_idx[i * k + kk] = best;
      out_dist[i * k + kk] = best >= 0 ? best_d : -1;
      if (best >= 0) dists[best] = 1 << 30;
    }
  }
}

// ---------------------------------------------------------------------------
// distinctive_select: per observation group, the min-median-Hamming
// representative descriptor (MapPoint::ComputeDistinctiveDescriptors role;
// the "median" is the sorted element at (n-1)/2, self-distance included).
// descs: (N, 32) group-ordered; group_off: (G+1,) row offsets.
// out_row[g] = global row index of the winner, -1 for an empty group.
// Replaces the batched NumPy path's (G, nmax, nmax, 32) padded XOR tensor
// with per-group popcounts: ~10x less memory traffic on KF insertion.
// ---------------------------------------------------------------------------
void distinctive_select(const uint8_t* descs, const int32_t* group_off,
                        int g_count, int32_t* out_row) {
  const uint64_t* d64 = reinterpret_cast<const uint64_t*>(descs);
  std::vector<int32_t> dist;  // n*n scratch, reused across groups
  std::vector<int32_t> row;
  for (int g = 0; g < g_count; ++g) {
    const int b0 = group_off[g], b1 = group_off[g + 1];
    const int n = b1 - b0;
    if (n <= 0) {
      out_row[g] = -1;
      continue;
    }
    if (n == 1) {
      out_row[g] = b0;
      continue;
    }
    dist.assign(static_cast<size_t>(n) * n, 0);
    for (int i = 0; i < n; ++i) {
      const uint64_t* di = d64 + 4 * (b0 + i);
      for (int j = i + 1; j < n; ++j) {
        const uint64_t* dj = d64 + 4 * (b0 + j);
        const int32_t d = __builtin_popcountll(di[0] ^ dj[0]) +
                          __builtin_popcountll(di[1] ^ dj[1]) +
                          __builtin_popcountll(di[2] ^ dj[2]) +
                          __builtin_popcountll(di[3] ^ dj[3]);
        dist[i * n + j] = d;
        dist[j * n + i] = d;
      }
    }
    const int m = (n - 1) / 2;
    int best_med = 1 << 30, best_i = -1;
    for (int i = 0; i < n; ++i) {
      row.assign(dist.begin() + i * n, dist.begin() + (i + 1) * n);
      std::nth_element(row.begin(), row.begin() + m, row.end());
      if (row[m] < best_med) {
        best_med = row[m];
        best_i = i;
      }
    }
    out_row[g] = b0 + best_i;
  }
}

// full pairwise Hamming matrix (na x nb)
void hamming_matrix(const uint8_t* a, int na, const uint8_t* b, int nb,
                    int32_t* out) {
  const uint64_t* a64 = reinterpret_cast<const uint64_t*>(a);
  const uint64_t* b64 = reinterpret_cast<const uint64_t*>(b);
  for (int i = 0; i < na; ++i) {
    const uint64_t* ai = a64 + 4 * i;
    for (int j = 0; j < nb; ++j) {
      const uint64_t* bj = b64 + 4 * j;
      out[i * nb + j] = __builtin_popcountll(ai[0] ^ bj[0]) +
                        __builtin_popcountll(ai[1] ^ bj[1]) +
                        __builtin_popcountll(ai[2] ^ bj[2]) +
                        __builtin_popcountll(ai[3] ^ bj[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// TrackLocalMap projection matcher (the host tracking loop's hottest inner
// loop; mirrors slam/matchers.search_by_projection_local_map bit-for-bit:
// same 64x48 grid walk order, same two-best same-level nn-ratio logic, same
// sequential slot-occupancy semantics).
// ---------------------------------------------------------------------------

int project_match_local(
    const float* proj,        // (M, 5): u, v, ur, level, view_cos
    const uint8_t* mp_desc,   // (M, 32)
    const uint8_t* mp_obs,    // (M,) 1 if the map point has observations
    int m,
    const float* kp_xy,       // (K, 2) undistorted
    const int32_t* kp_level,  // (K,)
    const uint8_t* kp_desc,   // (K, 32)
    const float* kp_ur,       // (K,)
    uint8_t* occupied,        // (K,) in/out: 1 = slot holds a tracked point
    int k,
    const float* scale_factors, int n_levels,
    float th, float ratio, int match_th,
    float min_x, float min_y, float grid_w, float grid_h,
    int32_t* out_idx          // (M,) matched frame slot or -1
) {
  constexpr int GRID_COLS = 64, GRID_ROWS = 48;
  // build the cell buckets exactly as Frame._build_grid (stable by index)
  std::vector<std::vector<int>> cells(GRID_COLS * GRID_ROWS);
  for (int i = 0; i < k; ++i) {
    int cx = int((kp_xy[2 * i] - min_x) / grid_w);
    int cy = int((kp_xy[2 * i + 1] - min_y) / grid_h);
    if (cx >= 0 && cx < GRID_COLS && cy >= 0 && cy < GRID_ROWS)
      cells[cy * GRID_COLS + cx].push_back(i);
  }
  const uint64_t* kd64 = reinterpret_cast<const uint64_t*>(kp_desc);
  const uint64_t* md64 = reinterpret_cast<const uint64_t*>(mp_desc);
  int n_matched = 0;
  for (int p = 0; p < m; ++p) {
    out_idx[p] = -1;
    const float u = proj[5 * p], v = proj[5 * p + 1], ur = proj[5 * p + 2];
    const int level = int(proj[5 * p + 3]);
    const float view_cos = proj[5 * p + 4];
    float r = (view_cos > 0.998f) ? 2.5f : 4.0f;
    r *= th * scale_factors[level];
    const int min_level = level - 1, max_level = level;
    int cx0 = std::max(0, int((u - min_x - r) / grid_w));
    int cx1 = std::min(GRID_COLS - 1, int((u - min_x + r) / grid_w));
    int cy0 = std::max(0, int((v - min_y - r) / grid_h));
    int cy1 = std::min(GRID_ROWS - 1, int((v - min_y + r) / grid_h));
    if (cx1 < cx0 || cy1 < cy0) continue;
    const uint64_t* dp = md64 + 4 * p;
    int best = 256, best2 = 256, best_i = -1, best_lvl = -1, best2_lvl = -1;
    for (int cy = cy0; cy <= cy1; ++cy)
      for (int cx = cx0; cx <= cx1; ++cx)
        for (int i : cells[cy * GRID_COLS + cx]) {
          if (std::fabs(kp_xy[2 * i] - u) >= r) continue;
          if (std::fabs(kp_xy[2 * i + 1] - v) >= r) continue;
          const int lv = kp_level[i];
          if (min_level >= 0 && lv < min_level) continue;
          if (max_level >= 0 && lv > max_level) continue;
          if (occupied[i]) continue;
          if (kp_ur[i] >= 0 && ur >= 0 && std::fabs(ur - kp_ur[i]) > r)
            continue;
          const uint64_t* di = kd64 + 4 * i;
          const int d = __builtin_popcountll(dp[0] ^ di[0]) +
                        __builtin_popcountll(dp[1] ^ di[1]) +
                        __builtin_popcountll(dp[2] ^ di[2]) +
                        __builtin_popcountll(dp[3] ^ di[3]);
          if (d < best) {
            best2 = best; best2_lvl = best_lvl;
            best = d; best_i = i; best_lvl = lv;
          } else if (d < best2) {
            best2 = d; best2_lvl = lv;
          }
        }
    if (best <= match_th && best_i >= 0) {
      if (best_lvl == best2_lvl && float(best) > ratio * float(best2)) continue;
      out_idx[p] = best_i;
      if (mp_obs[p]) occupied[best_i] = 1;
      ++n_matched;
    }
  }
  return n_matched;
}

// ---------------------------------------------------------------------------
// Motion-model projection matcher (SearchByProjection last-frame overload;
// mirrors slam/matchers.search_by_projection_last_frame's gates and walk
// order; the rotation-consistency histogram stays in Python on the
// returned pairs).  Pinhole cameras only.
// ---------------------------------------------------------------------------

int project_match_last(
    const double* pw,         // (M, 3) world positions of last-frame points
    const uint8_t* mp_desc,   // (M, 32)
    const int32_t* mp_oct,    // (M,) last-frame keypoint octave
    const uint8_t* mp_valid,  // (M,) 1 = has map point, not bad/outlier
    const uint8_t* mp_obs,    // (M,) 1 = n_obs > 0
    int m,
    const double* Rcw, const double* tcw,   // current pose
    double fx, double fy, double cx, double cy, double mbf,
    double min_x, double max_x, double min_y, double max_y,
    const float* kp_xy, const int32_t* kp_level, const uint8_t* kp_desc,
    const float* kp_ur, uint8_t* occupied, int k,
    const float* scale_factors, int n_levels,
    float th, int match_th, int same_octave_first,
    int forward, int backward,
    float grid_min_x, float grid_min_y, float grid_w, float grid_h,
    int32_t* out_idx          // (M,) matched cur slot or -1
) {
  constexpr int GRID_COLS = 64, GRID_ROWS = 48;
  std::vector<std::vector<int>> cells(GRID_COLS * GRID_ROWS);
  for (int i = 0; i < k; ++i) {
    int cx_ = int((kp_xy[2 * i] - grid_min_x) / grid_w);
    int cy_ = int((kp_xy[2 * i + 1] - grid_min_y) / grid_h);
    if (cx_ >= 0 && cx_ < GRID_COLS && cy_ >= 0 && cy_ < GRID_ROWS)
      cells[cy_ * GRID_COLS + cx_].push_back(i);
  }
  const uint64_t* kd64 = reinterpret_cast<const uint64_t*>(kp_desc);
  const uint64_t* md64 = reinterpret_cast<const uint64_t*>(mp_desc);

  // returns whether any candidate passed the POSITION+LEVEL filters (the
  // Python widens on raw window emptiness, before the occupancy/ur gates)
  auto window = [&](double u, double v, float r, int min_lv, int max_lv,
                    double ur_pred, const uint64_t* dp,
                    int* best_out, int* bestd_out) -> bool {
    int cx0 = std::max(0, int((u - grid_min_x - r) / grid_w));
    int cx1 = std::min(GRID_COLS - 1, int((u - grid_min_x + r) / grid_w));
    int cy0 = std::max(0, int((v - grid_min_y - r) / grid_h));
    int cy1 = std::min(GRID_ROWS - 1, int((v - grid_min_y + r) / grid_h));
    int best = 256, best_i = -1;
    bool any = false;
    *best_out = -1; *bestd_out = 256;
    if (cx1 < cx0 || cy1 < cy0) return false;
    for (int cy_ = cy0; cy_ <= cy1; ++cy_)
      for (int cx_ = cx0; cx_ <= cx1; ++cx_)
        for (int i : cells[cy_ * GRID_COLS + cx_]) {
          if (std::fabs(kp_xy[2 * i] - u) >= r) continue;
          if (std::fabs(kp_xy[2 * i + 1] - v) >= r) continue;
          const int lv = kp_level[i];
          if (min_lv >= 0 && lv < min_lv) continue;
          if (max_lv >= 0 && lv > max_lv) continue;
          any = true;
          if (occupied[i]) continue;
          if (kp_ur[i] >= 0 && ur_pred >= 0 &&
              std::fabs(ur_pred - kp_ur[i]) > r)
            continue;
          const uint64_t* di = kd64 + 4 * i;
          const int d = __builtin_popcountll(dp[0] ^ di[0]) +
                        __builtin_popcountll(dp[1] ^ di[1]) +
                        __builtin_popcountll(dp[2] ^ di[2]) +
                        __builtin_popcountll(dp[3] ^ di[3]);
          if (d < best) { best = d; best_i = i; }
        }
    *best_out = best_i;
    *bestd_out = best;
    return any;
  };

  int n_matched = 0;
  for (int p = 0; p < m; ++p) {
    out_idx[p] = -1;
    if (!mp_valid[p]) continue;
    const double* q = pw + 3 * p;
    const double x = Rcw[0]*q[0] + Rcw[1]*q[1] + Rcw[2]*q[2] + tcw[0];
    const double y = Rcw[3]*q[0] + Rcw[4]*q[1] + Rcw[5]*q[2] + tcw[1];
    const double z = Rcw[6]*q[0] + Rcw[7]*q[1] + Rcw[8]*q[2] + tcw[2];
    if (z < 0) continue;
    const double u = fx * x / z + cx;
    const double v = fy * y / z + cy;
    if (!(min_x < u && u < max_x && min_y < v && v < max_y)) continue;
    const int last_oct = mp_oct[p];
    const float r = th * scale_factors[last_oct];
    const double ur_pred = mbf > 0 ? u - mbf / z : -1.0;
    const uint64_t* dp = md64 + 4 * p;
    int best_i = -1, best = 256;
    bool any = false;
    if (same_octave_first)
      any = window(u, v, r, last_oct, last_oct, ur_pred, dp, &best_i, &best);
    if (!any) {
      if (forward)
        window(u, v, r, last_oct, -1, ur_pred, dp, &best_i, &best);
      else if (backward)
        window(u, v, r, 0, last_oct, ur_pred, dp, &best_i, &best);
      else
        window(u, v, r, last_oct - 1, last_oct + 1, ur_pred, dp, &best_i, &best);
    }
    if (best <= match_th && best_i >= 0) {
      out_idx[p] = best_i;
      if (mp_obs[p]) occupied[best_i] = 1;
      ++n_matched;
    }
  }
  return n_matched;
}

// ---------------------------------------------------------------------------
// Motion-only pose optimization (PoseOptimization role): a faithful C++
// port of optim/pose_optimization.py's vectorized LM — same annealed Huber
// schedule, same trial-step loop, same chi2 reclassification — for the
// pinhole camera.  Runs every frame (twice), so the Python/NumPy overhead
// (~46 ms/call at 600 points) mattered; this runs in <1 ms.
// ---------------------------------------------------------------------------

namespace {

void so3_exp_(const double w[3], double R[9]) {
  const double th2 = w[0]*w[0] + w[1]*w[1] + w[2]*w[2];
  const double th = std::sqrt(th2);
  double a, b;
  if (th < 1e-10) { a = 1.0 - th2 / 6.0; b = 0.5 - th2 / 24.0; }
  else { a = std::sin(th) / th; b = (1.0 - std::cos(th)) / th2; }
  const double K[9] = {0, -w[2], w[1], w[2], 0, -w[0], -w[1], w[0], 0};
  double K2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double acc = 0;
      for (int k = 0; k < 3; ++k) acc += K[3*i+k] * K[3*k+j];
      K2[3*i+j] = acc;
    }
  for (int i = 0; i < 9; ++i)
    R[i] = (i % 4 == 0 ? 1.0 : 0.0) + a * K[i] + b * K2[i];
}

void se3_exp_(const double xi[6], double R[9], double t[3]) {
  // matches utils/lie.SE3.exp: xi = [rho(3), phi(3)], t = V(phi) rho
  const double* rho = xi;
  const double* phi = xi + 3;
  so3_exp_(phi, R);
  const double th2 = phi[0]*phi[0] + phi[1]*phi[1] + phi[2]*phi[2];
  const double th = std::sqrt(th2);
  double b, c;
  if (th < 1e-10) { b = 0.5 - th2 / 24.0; c = 1.0/6.0 - th2 / 120.0; }
  else { b = (1.0 - std::cos(th)) / th2; c = (th - std::sin(th)) / (th2 * th); }
  const double K[9] = {0, -phi[2], phi[1], phi[2], 0, -phi[0], -phi[1], phi[0], 0};
  double K2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double acc = 0;
      for (int k = 0; k < 3; ++k) acc += K[3*i+k] * K[3*k+j];
      K2[3*i+j] = acc;
    }
  double V[9];
  for (int i = 0; i < 9; ++i)
    V[i] = (i % 4 == 0 ? 1.0 : 0.0) + b * K[i] + c * K2[i];
  for (int i = 0; i < 3; ++i)
    t[i] = V[3*i] * rho[0] + V[3*i+1] * rho[1] + V[3*i+2] * rho[2];
}

struct PoseObs {
  const double* pw;        // (n, 3)
  const double* uv;        // (n, 2)
  const double* ur;        // (n,)
  const double* is2;       // (n,)
  int n;
  double fx, fy, cx, cy, mbf;
};

// residual rows [du, dv, dur] and (optionally) Jacobian rows for pose (R, t)
inline void residual_row(const PoseObs& o, const double R[9], const double t[3],
                         int i, double res[3], bool* stereo) {
  const double* p = o.pw + 3 * i;
  const double x = R[0]*p[0] + R[1]*p[1] + R[2]*p[2] + t[0];
  const double y = R[3]*p[0] + R[4]*p[1] + R[5]*p[2] + t[1];
  const double z = R[6]*p[0] + R[7]*p[1] + R[8]*p[2] + t[2];
  const double u = o.fx * x / z + o.cx;
  const double v = o.fy * y / z + o.cy;
  res[0] = o.uv[2*i] - u;
  res[1] = o.uv[2*i+1] - v;
  const bool st = o.ur[i] >= 0;
  *stereo = st;
  res[2] = st ? (o.ur[i] - (u - o.mbf / std::max(z, 1e-9))) : 0.0;
}

inline double chi2_row(const double res[3], double is2, bool stereo) {
  double e2 = res[0]*res[0] + res[1]*res[1];
  if (stereo) e2 += res[2]*res[2];
  return e2 * is2;
}

// Per-call SoA scratch for the vectorized passes below (each OS thread —
// tracker, mapper, GBA — gets its own).
struct PoseScratch {
  std::vector<double> contrib;  // (n,)
  std::vector<double> J;        // (18, n): [row*6+col][i]
  std::vector<double> res;      // (3, n)
  std::vector<double> w;        // (n,)
};
thread_local PoseScratch g_pose_scratch;

// Robust cost, restructured for auto-vectorization: a branchless
// elementwise pass into `contrib` (inactive lanes masked to 0.0; z forced
// to 1.0 there so every lane stays finite), then an in-order scalar sum —
// bit-identical to the scalar loop (x + 0.0 == x; per-point arithmetic
// unchanged).
double robust_cost(const PoseObs& o, const double R[9], const double t[3],
                   const uint8_t* inlier, double delta_m, double delta_s,
                   bool use_huber) {
  const int n = o.n;
  std::vector<double>& contrib = g_pose_scratch.contrib;
  if ((int)contrib.size() < n) contrib.resize(n);
  const double* pw = o.pw; const double* uv = o.uv;
  const double* ur = o.ur; const double* is2 = o.is2;
  const double fx = o.fx, fy = o.fy, cx = o.cx, cy = o.cy, mbf = o.mbf;
  for (int i = 0; i < n; ++i) {
    const double act = inlier[i] ? 1.0 : 0.0;
    const double* p = pw + 3 * i;
    const double x = R[0]*p[0] + R[1]*p[1] + R[2]*p[2] + t[0];
    const double y = R[3]*p[0] + R[4]*p[1] + R[5]*p[2] + t[1];
    double z = R[6]*p[0] + R[7]*p[1] + R[8]*p[2] + t[2];
    z = inlier[i] ? z : 1.0;
    const double u = fx * x / z + cx;
    const double v = fy * y / z + cy;
    const double r0 = uv[2*i] - u;
    const double r1 = uv[2*i+1] - v;
    const bool st = ur[i] >= 0;
    const double r2 = st ? (ur[i] - (u - mbf / std::max(z, 1e-9))) : 0.0;
    const double c2 = (r0*r0 + r1*r1 + r2*r2) * is2[i];
    double c = c2;
    if (use_huber) {
      const double delta = st ? delta_s : delta_m;
      const double e = std::sqrt(std::max(c2, 0.0));
      c = (e <= delta) ? c2 : (2 * delta * e - delta * delta);
    }
    contrib[i] = act * c;
  }
  double total = 0;
  for (int i = 0; i < n; ++i) total += contrib[i];
  return total;
}

}  // namespace

int pose_optimize(const double* pw, const double* uv, const double* ur,
                  const double* is2, int n,
                  double fx, double fy, double cx, double cy, double mbf,
                  double* Rio, double* tio,   // in/out pose (row-major R, t)
                  uint8_t* inlier,            // (n,) out
                  int n_rounds, int n_iters) {
  const double CHI2_M = 5.991, CHI2_S = 7.815;
  const double DELTA_SCALE[4] = {3.0, 1.5, 1.0, 1.0};
  const double CHI2_SCALE[4] = {6.0, 2.5, 1.0, 1.0};
  PoseObs o{pw, uv, ur, is2, n, fx, fy, cx, cy, mbf};
  double R[9], t[3];
  std::copy(Rio, Rio + 9, R);
  std::copy(tio, tio + 3, t);
  for (int i = 0; i < n; ++i) inlier[i] = 1;

  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool use_huber = rnd < 3;
    const int sidx = std::min(rnd, 3);
    const double delta_m = std::sqrt(CHI2_M) * DELTA_SCALE[sidx];
    const double delta_s = std::sqrt(CHI2_S) * DELTA_SCALE[sidx];
    double lam = 1e-4;
    double Rr[9], tr[3];
    std::copy(R, R + 9, Rr);
    std::copy(t, t + 3, tr);
    double cost_prev = robust_cost(o, Rr, tr, inlier, delta_m, delta_s, use_huber);
    for (int it = 0; it < n_iters; ++it) {
      // assemble normal equations with IRLS weights — phase 1: branchless
      // elementwise pass into SoA scratch (auto-vectorizes; inactive lanes
      // get w=0 and z forced to 1 so every lane stays finite), phase 2:
      // SIMD reductions with 8-lane partial accumulators.
      PoseScratch& S = g_pose_scratch;
      if ((int)S.w.size() < n) {
        S.w.resize(n);
        S.res.resize(3 * (size_t)n);
        S.J.resize(18 * (size_t)n);
      }
      double* wv = S.w.data();
      double* rs = S.res.data();
      double* JJ = S.J.data();
      for (int i = 0; i < n; ++i) {
        const bool act = inlier[i] != 0;
        const double* p = pw + 3 * i;
        const double x = Rr[0]*p[0] + Rr[1]*p[1] + Rr[2]*p[2] + tr[0];
        const double y = Rr[3]*p[0] + Rr[4]*p[1] + Rr[5]*p[2] + tr[1];
        double z = Rr[6]*p[0] + Rr[7]*p[1] + Rr[8]*p[2] + tr[2];
        z = act ? z : 1.0;
        const double zi = 1.0 / z;
        const double u = fx * x * zi + cx;
        const double v = fy * y * zi + cy;
        const double r0 = uv[2*i] - u;
        const double r1 = uv[2*i+1] - v;
        const bool st = ur[i] >= 0;
        const double r2 = st ? (ur[i] - (u - mbf / std::max(z, 1e-9))) : 0.0;
        const double c2 = (r0*r0 + r1*r1 + r2*r2) * is2[i];
        double w = is2[i];
        if (use_huber) {
          const double delta = st ? delta_s : delta_m;
          const double e = std::sqrt(std::max(c2, 1e-18));
          w *= (e > delta) ? delta / e : 1.0;
        }
        wv[i] = act ? w : 0.0;
        rs[0*(size_t)n + i] = r0;
        rs[1*(size_t)n + i] = r1;
        rs[2*(size_t)n + i] = r2;
        // Jacobian rows (negated: res = obs - pred): row r, col c at
        // JJ[(r*6+c)*n + i]
        const double zi2 = zi * zi;
        const double g00 = fx * zi, g02 = -fx * x * zi2;
        const double g11 = fy * zi, g12 = -fy * y * zi2;
        JJ[0*(size_t)n + i] = -g00;
        JJ[1*(size_t)n + i] = 0.0;
        JJ[2*(size_t)n + i] = -g02;
        JJ[3*(size_t)n + i] = -(g02 * y);
        JJ[4*(size_t)n + i] = -(g00 * z + g02 * (-x));
        JJ[5*(size_t)n + i] = -(g00 * (-y));
        JJ[6*(size_t)n + i] = 0.0;
        JJ[7*(size_t)n + i] = -g11;
        JJ[8*(size_t)n + i] = -g12;
        JJ[9*(size_t)n + i] = -(g11 * (-z) + g12 * y);
        JJ[10*(size_t)n + i] = -(g12 * (-x));
        JJ[11*(size_t)n + i] = -(g11 * x);
        const double zc = std::max(z, 1e-9);
        const double mz2 = st ? mbf / (zc * zc) : 0.0;
        const double stm = st ? 1.0 : 0.0;
        JJ[12*(size_t)n + i] = stm * JJ[0*(size_t)n + i];
        JJ[13*(size_t)n + i] = 0.0;
        JJ[14*(size_t)n + i] = stm * (JJ[2*(size_t)n + i] - mz2);
        JJ[15*(size_t)n + i] = stm * (JJ[3*(size_t)n + i] - mz2 * y);
        JJ[16*(size_t)n + i] = stm * (JJ[4*(size_t)n + i] + mz2 * x);
        JJ[17*(size_t)n + i] = stm * JJ[5*(size_t)n + i];
      }
      double H[36] = {0}, b[6] = {0};
      for (int a_ = 0; a_ < 6; ++a_) {
        const double* j0a = JJ + (0*6 + a_) * (size_t)n;
        const double* j1a = JJ + (1*6 + a_) * (size_t)n;
        const double* j2a = JJ + (2*6 + a_) * (size_t)n;
        for (int b_ = a_; b_ < 6; ++b_) {
          const double* j0b = JJ + (0*6 + b_) * (size_t)n;
          const double* j1b = JJ + (1*6 + b_) * (size_t)n;
          const double* j2b = JJ + (2*6 + b_) * (size_t)n;
          double acc[8] = {0};
          int i = 0;
          for (; i + 8 <= n; i += 8)
            for (int l = 0; l < 8; ++l)
              acc[l] += wv[i+l] * (j0a[i+l]*j0b[i+l] + j1a[i+l]*j1b[i+l] +
                                   j2a[i+l]*j2b[i+l]);
          double s = ((acc[0]+acc[1])+(acc[2]+acc[3])) +
                     ((acc[4]+acc[5])+(acc[6]+acc[7]));
          for (; i < n; ++i)
            s += wv[i] * (j0a[i]*j0b[i] + j1a[i]*j1b[i] + j2a[i]*j2b[i]);
          H[6*a_ + b_] = s;
        }
        double acc[8] = {0};
        int i = 0;
        for (; i + 8 <= n; i += 8)
          for (int l = 0; l < 8; ++l)
            acc[l] += wv[i+l] * (j0a[i+l]*rs[i+l] + j1a[i+l]*rs[(size_t)n+i+l] +
                                 j2a[i+l]*rs[2*(size_t)n+i+l]);
        double s = ((acc[0]+acc[1])+(acc[2]+acc[3])) +
                   ((acc[4]+acc[5])+(acc[6]+acc[7]));
        for (; i < n; ++i)
          s += wv[i] * (j0a[i]*rs[i] + j1a[i]*rs[(size_t)n+i] +
                        j2a[i]*rs[2*(size_t)n+i]);
        b[a_] = s;
      }
      for (int a_ = 0; a_ < 6; ++a_)
        for (int b_ = 0; b_ < a_; ++b_) H[6*a_ + b_] = H[6*b_ + a_];
      // trial-step loop (8 attempts, same lambda schedule as the Python)
      bool ok_step = false;
      for (int trial = 0; trial < 8; ++trial) {
        double A[36];
        for (int i = 0; i < 36; ++i) A[i] = H[i];
        for (int d_ = 0; d_ < 6; ++d_) A[7*d_] += lam * H[7*d_] + 1e-12;
        // solve A dx = -b via Cholesky-ish Gaussian elimination
        double M[6][7];
        for (int r_ = 0; r_ < 6; ++r_) {
          for (int c_ = 0; c_ < 6; ++c_) M[r_][c_] = A[6*r_ + c_];
          M[r_][6] = -b[r_];
        }
        bool singular = false;
        for (int col = 0; col < 6; ++col) {
          int piv = col;
          for (int r_ = col + 1; r_ < 6; ++r_)
            if (std::fabs(M[r_][col]) > std::fabs(M[piv][col])) piv = r_;
          if (std::fabs(M[piv][col]) < 1e-300) { singular = true; break; }
          if (piv != col)
            for (int c_ = col; c_ < 7; ++c_) std::swap(M[piv][c_], M[col][c_]);
          for (int r_ = col + 1; r_ < 6; ++r_) {
            const double f = M[r_][col] / M[col][col];
            for (int c_ = col; c_ < 7; ++c_) M[r_][c_] -= f * M[col][c_];
          }
        }
        if (singular) { lam *= 10; continue; }
        double dx[6];
        for (int r_ = 5; r_ >= 0; --r_) {
          double acc = M[r_][6];
          for (int c_ = r_ + 1; c_ < 6; ++c_) acc -= M[r_][c_] * dx[c_];
          dx[r_] = acc / M[r_][r_];
        }
        double Rd[9], td[3], Rn[9], tn[3];
        se3_exp_(dx, Rd, td);
        for (int i_ = 0; i_ < 3; ++i_)
          for (int j_ = 0; j_ < 3; ++j_) {
            double acc = 0;
            for (int k_ = 0; k_ < 3; ++k_) acc += Rd[3*i_+k_] * Rr[3*k_+j_];
            Rn[3*i_+j_] = acc;
          }
        for (int i_ = 0; i_ < 3; ++i_)
          tn[i_] = Rd[3*i_]*tr[0] + Rd[3*i_+1]*tr[1] + Rd[3*i_+2]*tr[2] + td[i_];
        const double cost_new =
            robust_cost(o, Rn, tn, inlier, delta_m, delta_s, use_huber);
        if (cost_new < cost_prev) {
          std::copy(Rn, Rn + 9, Rr);
          std::copy(tn, tn + 3, tr);
          cost_prev = cost_new;
          lam = std::max(lam / 3, 1e-9);
          ok_step = true;
          break;
        }
        lam *= 10;
      }
      if (!ok_step) break;
    }
    std::copy(Rr, Rr + 9, R);
    std::copy(tr, tr + 3, t);
    // chi2 reclassification over ALL edges
    const double cth = CHI2_SCALE[sidx];
    int n_in = 0;
    for (int i = 0; i < n; ++i) {
      double res[3]; bool st;
      residual_row(o, R, t, i, res, &st);
      const double c2 = chi2_row(res, is2[i], st);
      inlier[i] = c2 <= (st ? CHI2_S : CHI2_M) * cth ? 1 : 0;
      n_in += inlier[i];
    }
    if (n_in < 10) break;
  }
  std::copy(R, R + 9, Rio);
  std::copy(t, t + 3, tio);
  int n_in = 0;
  for (int i = 0; i < n; ++i) n_in += inlier[i];
  return n_in;
}

// ---------------------------------------------------------------------------
// Schur-complement bundle adjustment (Local/Global BA core): a faithful C++
// port of optim/bundle_adjustment.py's vectorized LM — same residual model
// (mono 2-dof + stereo 3-dof pinhole reprojection), Huber deltas, per-point
// 3x3 damping, reduced-camera-system damping, trial-step accept/reject —
// for the pinhole camera.  The NumPy implementation remains the spec and
// the fallback (and the only path for fisheye).  Reference role:
// Optimizer::LocalBundleAdjustment (/root/reference/src/Optimizer2.cc:350)
// and BundleAdjustment (Optimizer1.cc:56) on g2o; here the whole graph is
// flat arrays and the reduced system is solved densely per iteration.
// ---------------------------------------------------------------------------

namespace {

const double BA_CHI2_M = 5.991, BA_CHI2_S = 7.815;

// 3x3 inverse; returns false if singular
inline bool inv3(const double a[9], double out[9]) {
  const double d = a[0] * (a[4] * a[8] - a[5] * a[7]) -
                   a[1] * (a[3] * a[8] - a[5] * a[6]) +
                   a[2] * (a[3] * a[7] - a[4] * a[6]);
  if (std::fabs(d) < 1e-300) return false;
  const double di = 1.0 / d;
  out[0] = (a[4] * a[8] - a[5] * a[7]) * di;
  out[1] = (a[2] * a[7] - a[1] * a[8]) * di;
  out[2] = (a[1] * a[5] - a[2] * a[4]) * di;
  out[3] = (a[5] * a[6] - a[3] * a[8]) * di;
  out[4] = (a[0] * a[8] - a[2] * a[6]) * di;
  out[5] = (a[2] * a[3] - a[0] * a[5]) * di;
  out[6] = (a[3] * a[7] - a[4] * a[6]) * di;
  out[7] = (a[1] * a[6] - a[0] * a[7]) * di;
  out[8] = (a[0] * a[4] - a[1] * a[3]) * di;
  return true;
}

// dense symmetric solve (Gaussian elimination, partial pivot).  A is n x n
// row-major and is destroyed; b in/out becomes x.  Returns false if singular.
bool dense_solve(std::vector<double>& A, std::vector<double>& b, int n) {
  for (int col = 0; col < n; ++col) {
    int piv = col;
    for (int r = col + 1; r < n; ++r)
      if (std::fabs(A[(size_t)r * n + col]) > std::fabs(A[(size_t)piv * n + col]))
        piv = r;
    if (std::fabs(A[(size_t)piv * n + col]) < 1e-300) return false;
    if (piv != col) {
      for (int c = col; c < n; ++c)
        std::swap(A[(size_t)piv * n + c], A[(size_t)col * n + c]);
      std::swap(b[piv], b[col]);
    }
    const double pv = 1.0 / A[(size_t)col * n + col];
    for (int r = col + 1; r < n; ++r) {
      const double f = A[(size_t)r * n + col] * pv;
      if (f == 0.0) continue;
      for (int c = col; c < n; ++c) A[(size_t)r * n + c] -= f * A[(size_t)col * n + c];
      b[r] -= f * b[col];
    }
  }
  for (int r = n - 1; r >= 0; --r) {
    double acc = b[r];
    for (int c = r + 1; c < n; ++c) acc -= A[(size_t)r * n + c] * b[c];
    b[r] = acc / A[(size_t)r * n + r];
  }
  return true;
}

struct BAIn {
  const int32_t *cam_idx, *pt_idx;
  const double *obs_uv, *obs_ur, *is2;
  const uint8_t* active;
  int C, P, O;
  double fx, fy, cx, cy, mbf;
};

// residuals + robust cost over active observations.  poses: (C, 12) row-major
// [R(9), t(3)]; chi2/res/stereo are (O,) / (O,3) / (O,) outputs.
double ba_cost(const BAIn& in, const double* poses, const double* points,
               bool use_huber, double* res, uint8_t* stereo, double* chi2) {
  double total = 0;
  for (int o = 0; o < in.O; ++o) {
    const double* T = poses + 12 * in.cam_idx[o];
    const double* p = points + 3 * in.pt_idx[o];
    const double x = T[0] * p[0] + T[1] * p[1] + T[2] * p[2] + T[9];
    const double y = T[3] * p[0] + T[4] * p[1] + T[5] * p[2] + T[10];
    const double z = T[6] * p[0] + T[7] * p[1] + T[8] * p[2] + T[11];
    const double u = in.fx * x / z + in.cx;
    const double v = in.fy * y / z + in.cy;
    double* r = res + 3 * o;
    r[0] = in.obs_uv[2 * o] - u;
    r[1] = in.obs_uv[2 * o + 1] - v;
    const bool st = in.obs_ur[o] >= 0;
    stereo[o] = st;
    r[2] = st ? (in.obs_ur[o] - (u - in.mbf / std::max(z, 1e-9))) : 0.0;
    double e2 = r[0] * r[0] + r[1] * r[1];
    if (st) e2 += r[2] * r[2];
    const double c2 = e2 * in.is2[o];
    chi2[o] = c2;
    if (!in.active[o]) continue;
    if (use_huber) {
      const double d2 = st ? BA_CHI2_S : BA_CHI2_M;
      const double delta = std::sqrt(d2);
      const double e = std::sqrt(std::max(c2, 0.0));
      total += (e <= delta) ? c2 : (2 * delta * e - d2);
    } else {
      total += c2;
    }
  }
  return total;
}

}  // namespace

// Schur LM over (poses, points).  poses (C, 12 = R row-major + t) and
// points (P, 3) are updated in place for free cams / all points; chi2_out
// (O,) receives final unrobust chi2.  Returns 0 on success.
int ba_schur(double* poses, double* points,
             const int32_t* cam_idx, const int32_t* pt_idx,
             const double* obs_uv, const double* obs_ur, const double* is2,
             const uint8_t* fixed_cams, const uint8_t* active,
             int C, int P, int O,
             double fx, double fy, double cx, double cy, double mbf,
             int n_iters, int use_huber, double* chi2_out,
             const uint8_t* abort_flag) {
  // abort_flag (nullable): polled before every LM iteration — another
  // thread (the tracker inserting a keyframe) sets it to interrupt a
  // running local BA, the reference's g2o setForceStopFlag(&mbAbortBA)
  // mechanism (/root/reference/src/LocalMapping.cc:288, Optimizer2.cc).
  BAIn in{cam_idx, pt_idx, obs_uv, obs_ur, is2, active,
          C,       P,      O,      fx,     fy,  cx,    cy, mbf};
  // free-camera slots
  std::vector<int> c_slot(C, -1), free_idx;
  for (int c = 0; c < C; ++c)
    if (!fixed_cams[c]) {
      c_slot[c] = (int)free_idx.size();
      free_idx.push_back(c);
    }
  const int nf = (int)free_idx.size();
  const int ns = 6 * nf;
  // observations grouped by point (counting sort)
  std::vector<int> starts(P + 1, 0), order(O);
  for (int o = 0; o < O; ++o) starts[pt_idx[o] + 1]++;
  for (int p = 0; p < P; ++p) starts[p + 1] += starts[p];
  {
    std::vector<int> cur(starts.begin(), starts.end() - 1);
    for (int o = 0; o < O; ++o) order[cur[pt_idx[o]]++] = o;
  }

  std::vector<double> res(3 * O), chi2(O);
  std::vector<uint8_t> stereo(O);
  std::vector<double> hcc(36 * C), gc(6 * C), hpp(9 * P), gp(3 * P);
  std::vector<double> vinv(9 * P), wblk(18 * O), yall(18 * O);
  std::vector<double> S((size_t)ns * ns), rhs(ns);
  std::vector<double> poses_new(12 * C), points_new(3 * P);

  double lam = 1e-5;
  double cost = ba_cost(in, poses, points, use_huber, res.data(),
                        stereo.data(), chi2.data());

  for (int it = 0; it < n_iters; ++it) {
    if (abort_flag && *(volatile const uint8_t*)abort_flag) break;
    ba_cost(in, poses, points, use_huber, res.data(), stereo.data(),
            chi2.data());
    std::fill(hcc.begin(), hcc.end(), 0.0);
    std::fill(gc.begin(), gc.end(), 0.0);
    std::fill(hpp.begin(), hpp.end(), 0.0);
    std::fill(gp.begin(), gp.end(), 0.0);

    for (int o = 0; o < O; ++o) {
      const double* T = poses + 12 * cam_idx[o];
      const double* p = points + 3 * pt_idx[o];
      const double x = T[0] * p[0] + T[1] * p[1] + T[2] * p[2] + T[9];
      const double y = T[3] * p[0] + T[4] * p[1] + T[5] * p[2] + T[10];
      const double z = T[6] * p[0] + T[7] * p[1] + T[8] * p[2] + T[11];
      const double zi = 1.0 / z;
      const double zi2 = zi * zi;
      // Huber IRLS weight (matches _weights)
      double w = is2[o];
      if (use_huber) {
        const double d2 = stereo[o] ? BA_CHI2_S : BA_CHI2_M;
        const double delta = std::sqrt(d2);
        const double e = std::sqrt(std::max(chi2[o], 1e-18));
        if (e > delta) w *= delta / e;
      }
      const double wa = active[o] ? w : 0.0;
      // Jacobian rows (d res): mono rows 0-1, stereo row 2
      const double jproj[6] = {fx * zi, 0.0, -fx * x * zi2,
                               0.0,     fy * zi, -fy * y * zi2};
      double Jc[18], Jp[9];
      for (int rr = 0; rr < 2; ++rr) {
        const double* g = jproj + 3 * rr;
        Jc[6 * rr + 0] = g[0];
        Jc[6 * rr + 1] = g[1];
        Jc[6 * rr + 2] = g[2];
        Jc[6 * rr + 3] = g[1] * (-z) + g[2] * y;
        Jc[6 * rr + 4] = g[0] * z + g[2] * (-x);
        Jc[6 * rr + 5] = g[0] * (-y) + g[1] * x;
        // point jacobian: jproj @ R
        for (int cc = 0; cc < 3; ++cc)
          Jp[3 * rr + cc] = g[0] * T[cc] + g[1] * T[3 + cc] + g[2] * T[6 + cc];
      }
      if (stereo[o]) {
        // z clamped like the NumPy spec's mz = mbf / max(z,1e-9)^2
        const double zc = std::max(z, 1e-9);
        const double mz2 = mbf / (zc * zc);
        const double dzc[6] = {0, 0, 1, y, -x, 0};
        for (int cc = 0; cc < 6; ++cc) Jc[12 + cc] = Jc[cc] + mz2 * dzc[cc];
        for (int cc = 0; cc < 3; ++cc)
          Jp[6 + cc] = Jp[cc] + mz2 * T[6 + cc];
      } else {
        for (int cc = 0; cc < 6; ++cc) Jc[12 + cc] = 0.0;
        for (int cc = 0; cc < 3; ++cc) Jp[6 + cc] = 0.0;
      }
      for (int i = 0; i < 18; ++i) Jc[i] = -Jc[i];
      for (int i = 0; i < 9; ++i) Jp[i] = -Jp[i];

      // block products (weighted by wa)
      double* A = hcc.data() + 36 * cam_idx[o];
      double* B = hpp.data() + 9 * pt_idx[o];
      double* W = wblk.data() + 18 * o;  // (6, 3) = Jc^T w Jp
      const double* r = res.data() + 3 * o;
      for (int a = 0; a < 6; ++a) {
        double gsum = 0;
        for (int rr = 0; rr < 3; ++rr) gsum += wa * Jc[6 * rr + a] * r[rr];
        gc[6 * cam_idx[o] + a] += gsum;
        for (int b = 0; b < 6; ++b) {
          double acc = 0;
          for (int rr = 0; rr < 3; ++rr)
            acc += wa * Jc[6 * rr + a] * Jc[6 * rr + b];
          A[6 * a + b] += acc;
        }
        for (int b = 0; b < 3; ++b) {
          double acc = 0;
          for (int rr = 0; rr < 3; ++rr)
            acc += wa * Jc[6 * rr + a] * Jp[3 * rr + b];
          W[3 * a + b] = acc;
        }
      }
      for (int a = 0; a < 3; ++a) {
        double gsum = 0;
        for (int rr = 0; rr < 3; ++rr) gsum += wa * Jp[3 * rr + a] * r[rr];
        gp[3 * pt_idx[o] + a] += gsum;
        for (int b = 0; b < 3; ++b) {
          double acc = 0;
          for (int rr = 0; rr < 3; ++rr)
            acc += wa * Jp[3 * rr + a] * Jp[3 * rr + b];
          B[3 * a + b] += acc;
        }
      }
    }

    // damped point-block inverses
    for (int p = 0; p < P; ++p) {
      double hb[9];
      std::copy(hpp.data() + 9 * p, hpp.data() + 9 * p + 9, hb);
      for (int d = 0; d < 3; ++d)
        hb[4 * d] += lam * std::max(std::fabs(hb[4 * d]), 1e-9) + 1e-12;
      if (!inv3(hb, vinv.data() + 9 * p)) {
        // fall back to a strongly damped identity
        std::fill(vinv.data() + 9 * p, vinv.data() + 9 * p + 9, 0.0);
        vinv[9 * p] = vinv[9 * p + 4] = vinv[9 * p + 8] = 1e-9;
      }
    }

    // reduced camera system
    std::fill(S.begin(), S.end(), 0.0);
    std::fill(rhs.begin(), rhs.end(), 0.0);
    for (int fi = 0; fi < nf; ++fi) {
      const int ci = free_idx[fi];
      for (int a = 0; a < 6; ++a) {
        rhs[6 * fi + a] = -gc[6 * ci + a];
        for (int b = 0; b < 6; ++b)
          S[(size_t)(6 * fi + a) * ns + 6 * fi + b] = hcc[36 * ci + 6 * a + b];
      }
    }
    for (int d = 0; d < ns; ++d)
      S[(size_t)d * ns + d] += lam * std::max(S[(size_t)d * ns + d], 1e-9);

    // Y = W Vinv per observation; rhs += Y g_p; S -= Y W^T over observer pairs
    for (int o = 0; o < O; ++o) {
      const double* W = wblk.data() + 18 * o;
      const double* V = vinv.data() + 9 * pt_idx[o];
      double* Y = yall.data() + 18 * o;
      for (int a = 0; a < 6; ++a)
        for (int b = 0; b < 3; ++b) {
          double acc = 0;
          for (int k = 0; k < 3; ++k) acc += W[3 * a + k] * V[3 * k + b];
          Y[3 * a + b] = acc;
        }
      const int sl = c_slot[cam_idx[o]];
      if (sl >= 0) {
        const double* g = gp.data() + 3 * pt_idx[o];
        for (int a = 0; a < 6; ++a)
          rhs[6 * sl + a] += Y[3 * a] * g[0] + Y[3 * a + 1] * g[1] + Y[3 * a + 2] * g[2];
      }
    }
    for (int p = 0; p < P; ++p) {
      for (int ia = starts[p]; ia < starts[p + 1]; ++ia) {
        const int oa = order[ia];
        const int sa = c_slot[cam_idx[oa]];
        if (sa < 0) continue;
        const double* Ya = yall.data() + 18 * oa;
        for (int ib = starts[p]; ib < starts[p + 1]; ++ib) {
          const int ob = order[ib];
          const int sb = c_slot[cam_idx[ob]];
          if (sb < 0) continue;
          const double* Wb = wblk.data() + 18 * ob;
          for (int a = 0; a < 6; ++a)
            for (int b = 0; b < 6; ++b) {
              double acc = 0;
              for (int k = 0; k < 3; ++k) acc += Ya[3 * a + k] * Wb[3 * b + k];
              S[(size_t)(6 * sa + a) * ns + 6 * sb + b] -= acc;
            }
        }
      }
    }

    std::vector<double> A(S);
    std::vector<double> dxc(rhs);
    for (int d = 0; d < ns; ++d) A[(size_t)d * ns + d] += 1e-12;
    if (ns > 0 && !dense_solve(A, dxc, ns)) {
      lam *= 10;
      continue;
    }

    // back-substitute points: dp = Vinv (-g_p - W^T dxc)
    std::vector<double> wtdx(3 * P, 0.0);
    for (int o = 0; o < O; ++o) {
      const int sl = c_slot[cam_idx[o]];
      if (sl < 0) continue;
      const double* W = wblk.data() + 18 * o;
      const double* dx = dxc.data() + 6 * sl;
      double* acc = wtdx.data() + 3 * pt_idx[o];
      for (int b = 0; b < 3; ++b) {
        double s = 0;
        for (int a = 0; a < 6; ++a) s += W[3 * a + b] * dx[a];
        acc[b] += s;
      }
    }
    std::copy(points, points + 3 * P, points_new.begin());
    for (int p = 0; p < P; ++p) {
      const double* V = vinv.data() + 9 * p;
      const double b0 = -gp[3 * p] - wtdx[3 * p];
      const double b1 = -gp[3 * p + 1] - wtdx[3 * p + 1];
      const double b2 = -gp[3 * p + 2] - wtdx[3 * p + 2];
      points_new[3 * p] += V[0] * b0 + V[1] * b1 + V[2] * b2;
      points_new[3 * p + 1] += V[3] * b0 + V[4] * b1 + V[5] * b2;
      points_new[3 * p + 2] += V[6] * b0 + V[7] * b1 + V[8] * b2;
    }

    // tentative pose update: T_new = exp(dx) * T for free cams
    std::copy(poses, poses + 12 * C, poses_new.begin());
    for (int fi = 0; fi < nf; ++fi) {
      const int ci = free_idx[fi];
      double Rd[9], td[3];
      se3_exp_(dxc.data() + 6 * fi, Rd, td);
      const double* T = poses + 12 * ci;
      double* Tn = poses_new.data() + 12 * ci;
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          double acc = 0;
          for (int k = 0; k < 3; ++k) acc += Rd[3 * i + k] * T[3 * k + j];
          Tn[3 * i + j] = acc;
        }
      for (int i = 0; i < 3; ++i)
        Tn[9 + i] = Rd[3 * i] * T[9] + Rd[3 * i + 1] * T[10] +
                    Rd[3 * i + 2] * T[11] + td[i];
    }

    const double cost_n = ba_cost(in, poses_new.data(), points_new.data(),
                                  use_huber, res.data(), stereo.data(),
                                  chi2.data());
    if (cost_n < cost) {
      std::copy(poses_new.begin(), poses_new.end(), poses);
      std::copy(points_new.begin(), points_new.end(), points);
      cost = cost_n;
      lam = std::max(lam / 3, 1e-9);
    } else {
      lam *= 10;
    }
  }

  // final unrobust chi2 over all observations
  ba_cost(in, poses, points, false, res.data(), stereo.data(), chi2_out);
  return 0;
}

}  // extern "C"
