// mcpt native runtime helpers (C++17, C ABI for ctypes).
//
// The device compute path is JAX/XLA/Pallas; this library is the *host-side*
// native tier, covering what the reference implements natively:
//   - Wavefront .obj/.mtl loading (replaces vendored tinyobjloader +
//     thirdpartywrapper.cpp:25-99, same positions-only triangulation and
//     4-way material classification),
//   - CPU LBVH construction (replaces BVH/hlbvh.cpp:92-200: 30-bit Morton
//     quantization, sorted build, Karras topology, AABB refit — here with the
//     parallel per-node range/split formulation instead of the reference's
//     sequential work queue),
//   - CPU treelet SAH restructuring (replaces BVH/treeletBVH.cpp:15-365:
//     greedy 7-leaf treelets, subset-partition DP, node-reuse rebuild).
//
// Python bindings live in mcpt/native/__init__.py (ctypes); every entry point
// has a pure-Python fallback so the library is an accelerator, not a
// dependency.
//
// Layout contract (BVH/hlbvh.cpp:164-193): 2N-1 nodes, internals [0, N-2],
// leaves [N-1, 2N-2], leaf.left == leaf.right == triangle id, root parent -1.

#include <algorithm>
#include <array>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <numeric>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  float x = 0, y = 0, z = 0;
};

struct RawMat {
  std::string name;
  float Ka[3] = {0, 0, 0};
  float Kd[3] = {0, 0, 0};
  float Ks[3] = {0, 0, 0};
  float Ns = 1.0f;  // tinyobj defaults: shininess 1, ior 1
  float Ni = 1.0f;
};

struct Loaded {
  std::vector<float> verts;   // N*9
  std::vector<int> mat_id;    // N
  std::vector<int> mtype;     // M
  std::vector<float> kd, ks, ka;  // M*3
  std::vector<float> ns, ni;      // M
};

enum MType { DIFFUSE = 1, GLOSSY = 2, TRANSPARENT = 3, LIGHT = 4 };

std::vector<RawMat> parse_mtl(const std::string& path) {
  std::vector<RawMat> mats;
  std::ifstream f(path);
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream ss(line);
    std::string key;
    if (!(ss >> key) || key[0] == '#') continue;
    if (key == "newmtl") {
      RawMat m;
      ss >> m.name;
      mats.push_back(m);
    } else if (!mats.empty()) {
      RawMat& m = mats.back();
      if (key == "Ka") ss >> m.Ka[0] >> m.Ka[1] >> m.Ka[2];
      else if (key == "Kd") ss >> m.Kd[0] >> m.Kd[1] >> m.Kd[2];
      else if (key == "Ks") ss >> m.Ks[0] >> m.Ks[1] >> m.Ks[2];
      else if (key == "Ns") ss >> m.Ns;
      else if (key == "Ni") ss >> m.Ni;
    }
  }
  return mats;
}

// Reference classification (thirdpartywrapper.cpp:65-97): Ni≠1 → TRANSPARENT,
// else Ka>0 → LIGHT, else Ns≠1 → GLOSSY, else DIFFUSE.  Raw (unprescaled)
// coefficients are kept; normalization lives in the BSDF code.
void classify(const std::vector<RawMat>& raw, Loaded& out) {
  for (const auto& m : raw) {
    int t;
    if (m.Ni != 1.0f) t = TRANSPARENT;
    else if (m.Ka[0] > 0 || m.Ka[1] > 0 || m.Ka[2] > 0) t = LIGHT;
    else if (m.Ns != 1.0f) t = GLOSSY;
    else t = DIFFUSE;
    out.mtype.push_back(t);
    for (int i = 0; i < 3; ++i) {
      out.kd.push_back((t == DIFFUSE || t == GLOSSY) ? m.Kd[i] : 0.0f);
      out.ks.push_back(t == GLOSSY ? m.Ks[i] : 0.0f);
      out.ka.push_back(t == LIGHT ? m.Ka[i] : 0.0f);
    }
    out.ns.push_back(t == GLOSSY ? m.Ns : 0.0f);
    out.ni.push_back(t == TRANSPARENT ? m.Ni : 1.0f);
  }
}

Loaded* load_obj_impl(const char* dir, const char* objname) {
  std::string base(dir);
  if (!base.empty() && base.back() != '/') base += '/';
  std::ifstream f(base + objname);
  if (!f) return nullptr;

  auto* out = new Loaded();
  std::vector<float> pos;  // flat xyz
  std::vector<RawMat> raw;
  std::unordered_map<std::string, int> mat_index;
  int cur_mat = -1;

  std::string line, key, tok;
  std::vector<long> face;
  while (std::getline(f, line)) {
    if (line.empty()) continue;
    std::istringstream ss(line);
    if (!(ss >> key) || key[0] == '#') continue;
    if (key == "v") {
      float x, y, z;
      ss >> x >> y >> z;
      pos.push_back(x); pos.push_back(y); pos.push_back(z);
    } else if (key == "f") {
      face.clear();
      while (ss >> tok) {
        // "v", "v/vt", "v//vn", "v/vt/vn" — positions only
        long v = std::strtol(tok.c_str(), nullptr, 10);
        long nverts = static_cast<long>(pos.size()) / 3;
        face.push_back(v > 0 ? v - 1 : nverts + v);
      }
      for (size_t k = 1; k + 1 < face.size(); ++k) {  // fan triangulation
        long ids[3] = {face[0], face[k], face[k + 1]};
        for (long id : ids)
          for (int j = 0; j < 3; ++j) out->verts.push_back(pos[id * 3 + j]);
        out->mat_id.push_back(cur_mat);
      }
    } else if (key == "usemtl") {
      std::string name;
      ss >> name;
      auto it = mat_index.find(name);
      cur_mat = it == mat_index.end() ? -1 : it->second;
    } else if (key == "mtllib") {
      std::string mtl;
      while (ss >> mtl) {
        for (auto& m : parse_mtl(base + mtl)) {
          mat_index[m.name] = static_cast<int>(raw.size());
          raw.push_back(m);
        }
      }
    }
  }
  classify(raw, *out);
  return out;
}

// ---------------------------------------------------------------------------
// LBVH (Morton + Karras topology + refit)
// ---------------------------------------------------------------------------

inline uint32_t expand_bits_10(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

struct BuildCtx {
  const uint64_t* keys;  // (morton << 32) | sorted-position tiebreak
  int n;
  int delta(int i, int j) const {
    if (j < 0 || j >= n) return -1;
    uint64_t x = keys[i] ^ keys[j];
    return x == 0 ? 64 : __builtin_clzll(x);
  }
};

}  // namespace

extern "C" {

void* mcpt_load_obj(const char* dir, const char* objname, int* n_tris,
                    int* n_mats) {
  Loaded* l = load_obj_impl(dir, objname);
  if (!l) return nullptr;
  *n_tris = static_cast<int>(l->mat_id.size());
  *n_mats = static_cast<int>(l->mtype.size());
  return l;
}

void mcpt_get_tris(void* h, float* verts, int* mat_id) {
  auto* l = static_cast<Loaded*>(h);
  std::memcpy(verts, l->verts.data(), l->verts.size() * sizeof(float));
  std::memcpy(mat_id, l->mat_id.data(), l->mat_id.size() * sizeof(int));
}

void mcpt_get_mats(void* h, float* kd, float* ks, float* ka, float* ns,
                   float* ni, int* mtype) {
  auto* l = static_cast<Loaded*>(h);
  std::memcpy(kd, l->kd.data(), l->kd.size() * sizeof(float));
  std::memcpy(ks, l->ks.data(), l->ks.size() * sizeof(float));
  std::memcpy(ka, l->ka.data(), l->ka.size() * sizeof(float));
  std::memcpy(ns, l->ns.data(), l->ns.size() * sizeof(float));
  std::memcpy(ni, l->ni.data(), l->ni.size() * sizeof(float));
  std::memcpy(mtype, l->mtype.data(), l->mtype.size() * sizeof(int));
}

void mcpt_free(void* h) { delete static_cast<Loaded*>(h); }

// verts: N*9 floats.  Outputs sized 2N-1 (bbmin/bbmax: *3).
void mcpt_build_lbvh(const float* verts, int n, float* bbmin, float* bbmax,
                     int* left, int* right, int* parent) {
  if (n <= 0) return;
  const int n_nodes = 2 * n - 1;
  const int leaf_base = n - 1;
  if (n == 1) {
    for (int j = 0; j < 3; ++j) {
      float lo = std::min({verts[j], verts[3 + j], verts[6 + j]});
      float hi = std::max({verts[j], verts[3 + j], verts[6 + j]});
      bbmin[j] = lo;
      bbmax[j] = hi;
    }
    left[0] = right[0] = 0;
    parent[0] = -1;
    return;
  }

  std::vector<float> tmin(n * 3), tmax(n * 3), cent(n * 3);
  float cmin[3] = {1e30f, 1e30f, 1e30f}, cmax[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < 3; ++j) {
      float a = verts[i * 9 + j], b = verts[i * 9 + 3 + j],
            c = verts[i * 9 + 6 + j];
      float lo = std::min({a, b, c}), hi = std::max({a, b, c});
      tmin[i * 3 + j] = lo;
      tmax[i * 3 + j] = hi;
      float ce = 0.5f * (lo + hi);
      cent[i * 3 + j] = ce;
      cmin[j] = std::min(cmin[j], ce);
      cmax[j] = std::max(cmax[j], ce);
    }
  }
  // 10-bit quantization ×1024 (hlbvh.cpp:118-136 math)
  std::vector<std::pair<uint32_t, int>> mp(n);
  for (int i = 0; i < n; ++i) {
    uint32_t code = 0;
    uint32_t q[3];
    for (int j = 0; j < 3; ++j) {
      float ext = std::max(cmax[j] - cmin[j], 1e-20f);
      float u = (cent[i * 3 + j] - cmin[j]) / ext * 1024.0f;
      q[j] = static_cast<uint32_t>(std::min(std::max(u, 0.0f), 1023.0f));
    }
    code = (expand_bits_10(q[0]) << 2) | (expand_bits_10(q[1]) << 1) |
           expand_bits_10(q[2]);
    mp[i] = {code, i};
  }
  std::stable_sort(mp.begin(), mp.end(),
                   [](auto& a, auto& b) { return a.first < b.first; });

  std::vector<uint64_t> keys(n);
  for (int p = 0; p < n; ++p)
    keys[p] = (static_cast<uint64_t>(mp[p].first) << 32) |
              static_cast<uint32_t>(p);
  BuildCtx ctx{keys.data(), n};

  // Karras parallel per-node range/split (embarrassingly parallel; serial
  // here is already sort-dominated)
  for (int i = 0; i < n - 1; ++i) {
    int d = ctx.delta(i, i + 1) >= ctx.delta(i, i - 1) ? 1 : -1;
    int dmin = ctx.delta(i, i - d);
    int lmax = 2;
    while (ctx.delta(i, i + lmax * d) > dmin) lmax <<= 1;
    int l = 0;
    for (int t = lmax >> 1; t >= 1; t >>= 1)
      if (ctx.delta(i, i + (l + t) * d) > dmin) l += t;
    int j = i + l * d;
    int dnode = ctx.delta(i, j);
    int s = 0;
    for (int div = 2;; div <<= 1) {
      int t = (l + div - 1) / div;
      if (ctx.delta(i, i + (s + t) * d) > dnode) s += t;
      if (t <= 1) break;
    }
    int gamma = i + s * d + std::min(d, 0);
    int lo = std::min(i, j), hi = std::max(i, j);
    int lc = (lo == gamma) ? leaf_base + gamma : gamma;
    int rc = (hi == gamma + 1) ? leaf_base + gamma + 1 : gamma + 1;
    left[i] = lc;
    right[i] = rc;
    parent[lc] = i;
    parent[rc] = i;
  }
  parent[0] = -1;
  for (int p = 0; p < n; ++p) {
    int tri = mp[p].second;
    left[leaf_base + p] = tri;
    right[leaf_base + p] = tri;
    for (int j = 0; j < 3; ++j) {
      bbmin[(leaf_base + p) * 3 + j] = tmin[tri * 3 + j];
      bbmax[(leaf_base + p) * 3 + j] = tmax[tri * 3 + j];
    }
  }
  // refit: iterative post-order (children before parents via reverse
  // topological pass — repeat until stable, depth ≤ 64)
  std::vector<int> order(n - 1);
  std::iota(order.begin(), order.end(), 0);
  // compute heights to get a single-pass order
  std::vector<int> height(n_nodes, 0);
  bool changed = true;
  while (changed) {
    changed = false;
    for (int i = n - 2; i >= 0; --i) {
      int h = 1 + std::max(height[left[i]], height[right[i]]);
      if (h != height[i]) {
        height[i] = h;
        changed = true;
      }
    }
  }
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return height[a] < height[b]; });
  for (int i : order) {
    for (int j = 0; j < 3; ++j) {
      bbmin[i * 3 + j] =
          std::min(bbmin[left[i] * 3 + j], bbmin[right[i] * 3 + j]);
      bbmax[i * 3 + j] =
          std::max(bbmax[left[i] * 3 + j], bbmax[right[i] * 3 + j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Treelet restructuring (Karras & Aila 2013) — same algorithm as
// mcpt/bvh/treelet.py, in-place on the flat arrays.
// ---------------------------------------------------------------------------

static const float C_INN = 1.2f, C_TRI = 1.0f;

void mcpt_treelet_optimize(int n, float* bbmin, float* bbmax, int* left,
                           int* right, int* parent) {
  if (n < 4) return;
  const int n_nodes = 2 * n - 1;
  const int leaf_base = n - 1;
  auto area = [&](int i) {
    float dx = std::max(bbmax[i * 3] - bbmin[i * 3], 0.0f);
    float dy = std::max(bbmax[i * 3 + 1] - bbmin[i * 3 + 1], 0.0f);
    float dz = std::max(bbmax[i * 3 + 2] - bbmin[i * 3 + 2], 0.0f);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
  };

  std::vector<int> height(n_nodes, 0);
  bool changed = true;
  while (changed) {
    changed = false;
    for (int i = n - 2; i >= 0; --i) {
      int h = 1 + std::max(height[left[i]], height[right[i]]);
      if (h != height[i]) { height[i] = h; changed = true; }
    }
  }
  std::vector<int> order(n - 1);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return height[a] < height[b]; });

  std::vector<double> cost(n_nodes);
  for (int i = leaf_base; i < n_nodes; ++i) cost[i] = C_TRI * area(i);
  for (int r : order) cost[r] = C_INN * area(r) + cost[left[r]] + cost[right[r]];

  constexpr int MAXL = 7;
  int leaves[MAXL];
  int internals[MAXL - 1];
  float smin[1 << MAXL][3], smax[1 << MAXL][3];
  double sarea[1 << MAXL], csub[1 << MAXL];
  int part[1 << MAXL];

  for (int r : order) {
    int nl = 2, ni_ = 1;
    leaves[0] = left[r];
    leaves[1] = right[r];
    internals[0] = r;
    while (nl < MAXL) {
      int best = -1;
      float best_a = -1.0f;
      for (int i = 0; i < nl; ++i)
        if (leaves[i] < leaf_base && area(leaves[i]) > best_a) {
          best = i;
          best_a = area(leaves[i]);
        }
      if (best < 0) break;
      int x = leaves[best];
      internals[ni_++] = x;
      leaves[best] = left[x];
      leaves[nl++] = right[x];
    }
    if (nl < 3) continue;
    const int full = (1 << nl) - 1;

    for (int s = 1; s <= full; ++s) {
      int low = s & (-s);
      int bit = __builtin_ctz(low);
      int rest = s ^ low;
      for (int j = 0; j < 3; ++j) {
        float lo = bbmin[leaves[bit] * 3 + j];
        float hi = bbmax[leaves[bit] * 3 + j];
        smin[s][j] = rest ? std::min(smin[rest][j], lo) : lo;
        smax[s][j] = rest ? std::max(smax[rest][j], hi) : hi;
      }
      float dx = std::max(smax[s][0] - smin[s][0], 0.0f);
      float dy = std::max(smax[s][1] - smin[s][1], 0.0f);
      float dz = std::max(smax[s][2] - smin[s][2], 0.0f);
      sarea[s] = 2.0 * (dx * dy + dy * dz + dz * dx);
    }

    for (int i = 0; i < nl; ++i) csub[1 << i] = cost[leaves[i]];
    for (int s = 1; s <= full; ++s) {
      if ((s & (s - 1)) == 0) continue;
      double best = 1e300;
      int bestp = 0;
      for (int p = (s - 1) & s; p; p = (p - 1) & s) {
        if (p < (s ^ p)) {
          double c = csub[p] + csub[s ^ p];
          if (c < best) { best = c; bestp = p; }
        }
      }
      csub[s] = best + C_INN * sarea[s];
      part[s] = bestp;
    }
    if (csub[full] >= cost[r] - 1e-7) continue;

    int pool[MAXL];  // stack; r on top so the rebuilt root is r
    int np = 0;
    for (int i = 1; i < ni_; ++i) pool[np++] = internals[i];
    pool[np++] = r;

    // iterative reconstruction (explicit stack of subsets)
    struct Item { int s, node; };
    Item stack[2 * MAXL];
    int sp = 0;
    int root_id = pool[--np];
    stack[sp++] = {full, root_id};
    while (sp) {
      Item it = stack[--sp];
      int s = it.s, nid = it.node;
      int p = part[s], c = s ^ p;
      int lch = ((p & (p - 1)) == 0) ? leaves[__builtin_ctz(p)] : pool[--np];
      int rch = ((c & (c - 1)) == 0) ? leaves[__builtin_ctz(c)] : pool[--np];
      left[nid] = lch;
      right[nid] = rch;
      parent[lch] = nid;
      parent[rch] = nid;
      for (int j = 0; j < 3; ++j) {
        bbmin[nid * 3 + j] = smin[s][j];
        bbmax[nid * 3 + j] = smax[s][j];
      }
      if ((p & (p - 1)) != 0) stack[sp++] = {p, lch};
      if ((c & (c - 1)) != 0) stack[sp++] = {c, rch};
    }
    // refit costs bottom-up within the treelet: recompute via subsets is
    // already exact (csub), so just set the root's cost
    // (children costs set below during stack pops would be out of order, so
    // recompute all reused internals' costs in one local pass)
    for (int pass = 0; pass < ni_; ++pass)
      for (int i = 0; i < ni_; ++i) {
        int nid = internals[i];
        cost[nid] = C_INN * area(nid) + cost[left[nid]] + cost[right[nid]];
      }
  }
}

// --- EPO (Expected Projected Overlap) -------------------------------------
// Native twin of mcpt/bvh/metrics.py::epo (reference bvhtest.cpp:221-284 +
// the GPU clip kernel EPO.cl:133-197, re-implemented from the definition):
// for every leaf's triangle, walk the tree from the root; non-ancestor nodes
// whose box clips a positive area of the triangle contribute
// area x (C_INN | C_TRI), descending only while the clip stays positive.
// Ancestry is an interval test over subtree leaf ranges.  Parallel over
// leaves with std::thread.
double mcpt_epo(const float* verts, int n, const float* bbmin,
                const float* bbmax, const int* left, const int* right,
                double c_inn, double c_tri, int n_threads) {
  if (n <= 1) return 0.0;
  const int leaf_base = n - 1;
  const int n_nodes = 2 * n - 1;

  // subtree leaf ranges, bottom-up over a height ordering
  std::vector<int> lo(n_nodes), hi(n_nodes), height(n_nodes, 0);
  for (int i = 0; i < n; ++i) lo[leaf_base + i] = hi[leaf_base + i] = i;
  std::vector<int> order(leaf_base);
  {
    bool changed = true;
    while (changed) {
      changed = false;
      for (int v = leaf_base - 1; v >= 0; --v) {
        int h = 1 + std::max(height[left[v]], height[right[v]]);
        if (h != height[v]) { height[v] = h; changed = true; }
      }
    }
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(),
              [&](int a, int b) { return height[a] < height[b]; });
    for (int v : order) {
      lo[v] = std::min(lo[left[v]], lo[right[v]]);
      hi[v] = std::max(hi[left[v]], hi[right[v]]);
    }
  }

  // Sutherland-Hodgman triangle-vs-AABB clip area
  auto clip_area = [&](const double tri[3][3], const float* bmin,
                       const float* bmax) -> double {
    double poly[16][3], tmp[16][3];
    int np = 3;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) poly[i][j] = tri[i][j];
    for (int axis = 0; axis < 3 && np >= 3; ++axis) {
      for (int side = 0; side < 2 && np >= 3; ++side) {
        const double plane = side ? bmax[axis] : bmin[axis];
        const double sgn = side ? -1.0 : 1.0;
        int m = 0;
        for (int i = 0; i < np; ++i) {
          const double* a = poly[i];
          const double* b = poly[(i + 1) % np];
          double da = sgn * (a[axis] - plane);
          double db = sgn * (b[axis] - plane);
          if (da >= 0.0) {
            for (int j = 0; j < 3; ++j) tmp[m][j] = a[j];
            ++m;
          }
          if ((da >= 0.0) != (db >= 0.0)) {
            double t = da / (da - db);
            for (int j = 0; j < 3; ++j) tmp[m][j] = a[j] + t * (b[j] - a[j]);
            ++m;
          }
        }
        np = m;
        for (int i = 0; i < np; ++i)
          for (int j = 0; j < 3; ++j) poly[i][j] = tmp[i][j];
      }
    }
    if (np < 3) return 0.0;
    double cx = 0, cy = 0, cz = 0;
    for (int i = 1; i + 1 < np; ++i) {
      double u[3], w[3];
      for (int j = 0; j < 3; ++j) {
        u[j] = poly[i][j] - poly[0][j];
        w[j] = poly[i + 1][j] - poly[0][j];
      }
      cx += u[1] * w[2] - u[2] * w[1];
      cy += u[2] * w[0] - u[0] * w[2];
      cz += u[0] * w[1] - u[1] * w[0];
    }
    return 0.5 * std::sqrt(cx * cx + cy * cy + cz * cz);
  };

  auto walk_range = [&](int p0, int p1) -> double {
    double acc = 0.0;
    std::vector<int> stack(128);
    for (int pos = p0; pos < p1; ++pos) {
      const int tri = left[leaf_base + pos];
      double tv[3][3];
      float tmin[3], tmax[3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) tv[i][j] = verts[tri * 9 + i * 3 + j];
      for (int j = 0; j < 3; ++j) {
        tmin[j] = (float)std::min({tv[0][j], tv[1][j], tv[2][j]});
        tmax[j] = (float)std::max({tv[0][j], tv[1][j], tv[2][j]});
      }
      int sp = 0;
      stack[sp++] = 0;
      while (sp) {
        const int node = stack[--sp];
        const bool anc = lo[node] <= pos && pos <= hi[node];
        if (!anc) {
          bool overlap = true;
          for (int j = 0; j < 3 && overlap; ++j)
            overlap = tmin[j] <= bbmax[node * 3 + j] &&
                      tmax[j] >= bbmin[node * 3 + j];
          if (!overlap) continue;
          double a = clip_area(tv, bbmin + node * 3, bbmax + node * 3);
          if (a <= 0.0) continue;
          acc += a * (node >= leaf_base ? c_tri : c_inn);
        }
        if (node < leaf_base) {
          stack[sp++] = left[node];
          stack[sp++] = right[node];
          if (sp + 2 > (int)stack.size()) stack.resize(stack.size() * 2);
        }
      }
    }
    return acc;
  };

  double total = 0.0;
  if (n_threads <= 1) {
    total = walk_range(0, n);
  } else {
    std::vector<std::thread> threads;
    std::vector<double> partial(n_threads, 0.0);
    const int per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int p0 = t * per, p1 = std::min(n, p0 + per);
      if (p0 >= p1) break;
      threads.emplace_back(
          [&, t, p0, p1]() { partial[t] = walk_range(p0, p1); });
    }
    for (auto& th : threads) th.join();
    for (double p : partial) total += p;
  }

  double tarea = 0.0;
  for (int t = 0; t < n; ++t) {
    double e1[3], e2[3];
    for (int j = 0; j < 3; ++j) {
      e1[j] = (double)verts[t * 9 + 3 + j] - verts[t * 9 + j];
      e2[j] = (double)verts[t * 9 + 6 + j] - verts[t * 9 + j];
    }
    double cx = e1[1] * e2[2] - e1[2] * e2[1];
    double cy = e1[2] * e2[0] - e1[0] * e2[2];
    double cz = e1[0] * e2[1] - e1[1] * e2[0];
    tarea += 0.5 * std::sqrt(cx * cx + cy * cy + cz * cz);
  }
  return total / std::max(tarea, 1e-30);
}

}  // extern "C"
