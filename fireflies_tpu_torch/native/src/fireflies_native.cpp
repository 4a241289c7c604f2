// fireflies native host-side helpers (the port's copy of the JAX package's
// fireflies_tpu/native/src/fireflies_native.cpp; the code is the same, so
// that Bridson draws the same points from the same seed).
//
// Host components the reference delegated to native dependencies: OBJ
// parsing (pywavefront), Poisson-disk sampling (numpy Bridson loop),
// connected components (OpenCV), plus the Morton ordering of faces into
// clusters for the intersection kernels.  Exposed as a C ABI consumed via
// ctypes (fireflies_tpu_torch/native/__init__.py); every entry point has a
// plain Python or numpy version beside its caller, which
// FIREFLIES_NO_NATIVE=1 selects.
//
// Build: at first use, g++ -O2 -std=c++17 -fPIC -Wall -shared, into
// build/fireflies_tpu_torch/ at the root of the checkout.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------------

struct ObjMesh {
  float* vertices;   // V*3
  int32_t* faces;    // F*3
  float* uvs;        // T*2 (may be null)
  int32_t* face_uvs; // F*3 (may be null)
  float* normals;    // N*3 (may be null)
  int64_t n_vertices;
  int64_t n_faces;
  int64_t n_uvs;
  int64_t n_normals;
  int32_t has_face_uvs;
};

static int parse_index(const char* tok, int64_t count) {
  int idx = atoi(tok);
  if (idx > 0) return idx - 1;
  if (idx < 0) return static_cast<int>(count) + idx;
  return 0;
}

ObjMesh* ff_parse_obj(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;

  std::vector<float> verts, uvs, normals;
  std::vector<int32_t> faces, face_uvs;
  bool has_face_uvs = true;

  char line[8192];
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      float x, y, z;
      if (sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        verts.push_back(x);
        verts.push_back(y);
        verts.push_back(z);
      }
    } else if (line[0] == 'v' && line[1] == 't') {
      float u_, v_;
      if (sscanf(line + 3, "%f %f", &u_, &v_) == 2) {
        uvs.push_back(u_);
        uvs.push_back(v_);
      }
    } else if (line[0] == 'v' && line[1] == 'n') {
      float x, y, z;
      if (sscanf(line + 3, "%f %f %f", &x, &y, &z) == 3) {
        normals.push_back(x);
        normals.push_back(y);
        normals.push_back(z);
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      // Tokenize the polygon, fan-triangulate.
      std::vector<int32_t> vi, ti;
      char* save = nullptr;
      for (char* tok = strtok_r(line + 2, " \t\r\n", &save); tok;
           tok = strtok_r(nullptr, " \t\r\n", &save)) {
        if (!isdigit(static_cast<unsigned char>(tok[0])) && tok[0] != '-') continue;
        vi.push_back(parse_index(tok, verts.size() / 3));
        char* slash = strchr(tok, '/');
        if (slash && slash[1] && slash[1] != '/') {
          ti.push_back(parse_index(slash + 1, uvs.size() / 2));
        } else {
          ti.push_back(-1);
          has_face_uvs = false;
        }
      }
      for (size_t j = 1; j + 1 < vi.size(); ++j) {
        faces.push_back(vi[0]);
        faces.push_back(vi[j]);
        faces.push_back(vi[j + 1]);
        face_uvs.push_back(ti[0]);
        face_uvs.push_back(ti[j]);
        face_uvs.push_back(ti[j + 1]);
      }
    }
  }
  fclose(f);

  auto* mesh = new ObjMesh();
  auto copy_f = [](const std::vector<float>& v) -> float* {
    if (v.empty()) return nullptr;
    float* p = static_cast<float*>(malloc(v.size() * sizeof(float)));
    memcpy(p, v.data(), v.size() * sizeof(float));
    return p;
  };
  auto copy_i = [](const std::vector<int32_t>& v) -> int32_t* {
    if (v.empty()) return nullptr;
    int32_t* p = static_cast<int32_t*>(malloc(v.size() * sizeof(int32_t)));
    memcpy(p, v.data(), v.size() * sizeof(int32_t));
    return p;
  };
  mesh->vertices = copy_f(verts);
  mesh->faces = copy_i(faces);
  mesh->uvs = copy_f(uvs);
  mesh->face_uvs = (has_face_uvs && !uvs.empty()) ? copy_i(face_uvs) : nullptr;
  mesh->normals = copy_f(normals);
  mesh->n_vertices = static_cast<int64_t>(verts.size() / 3);
  mesh->n_faces = static_cast<int64_t>(faces.size() / 3);
  mesh->n_uvs = static_cast<int64_t>(uvs.size() / 2);
  mesh->n_normals = static_cast<int64_t>(normals.size() / 3);
  mesh->has_face_uvs = mesh->face_uvs != nullptr;
  return mesh;
}

void ff_free_obj(ObjMesh* mesh) {
  if (!mesh) return;
  free(mesh->vertices);
  free(mesh->faces);
  free(mesh->uvs);
  free(mesh->face_uvs);
  free(mesh->normals);
  delete mesh;
}

// ---------------------------------------------------------------------------
// Bridson Poisson-disk sampling with a spatially varying radius map
// (reference fireflies/sampling/poisson.py:16-117).
// ---------------------------------------------------------------------------

int64_t ff_bridson(const float* radius_map, int64_t height, int64_t width,
                   int32_t k, uint64_t seed, float* out_points,
                   int64_t max_points) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);

  double r_min = 1e30;
  for (int64_t i = 0; i < height * width; ++i)
    r_min = std::min(r_min, static_cast<double>(radius_map[i]));
  r_min = std::max(r_min, 1e-3);

  const double cell = r_min / std::sqrt(2.0);
  const int64_t gh = static_cast<int64_t>(std::ceil(height / cell)) + 1;
  const int64_t gw = static_cast<int64_t>(std::ceil(width / cell)) + 1;
  std::vector<int64_t> grid(gh * gw, -1);

  std::vector<double> py, px;
  std::vector<int64_t> active;

  auto radius_at = [&](double y, double x) {
    int64_t iy = std::min<int64_t>(static_cast<int64_t>(y), height - 1);
    int64_t ix = std::min<int64_t>(static_cast<int64_t>(x), width - 1);
    return std::max(static_cast<double>(radius_map[iy * width + ix]), r_min);
  };

  auto fits = [&](double y, double x, double radius) {
    int64_t gy = static_cast<int64_t>(y / cell);
    int64_t gx = static_cast<int64_t>(x / cell);
    int64_t reach = static_cast<int64_t>(std::ceil(radius / cell)) + 1;
    for (int64_t yy = std::max<int64_t>(gy - reach, 0);
         yy <= std::min(gy + reach, gh - 1); ++yy) {
      for (int64_t xx = std::max<int64_t>(gx - reach, 0);
           xx <= std::min(gx + reach, gw - 1); ++xx) {
        int64_t idx = grid[yy * gw + xx];
        if (idx < 0) continue;
        double dy = py[idx] - y, dx = px[idx] - x;
        if (dy * dy + dx * dx < radius * radius) return false;
      }
    }
    return true;
  };

  auto insert = [&](double y, double x) {
    py.push_back(y);
    px.push_back(x);
    int64_t id = static_cast<int64_t>(py.size()) - 1;
    grid[static_cast<int64_t>(y / cell) * gw + static_cast<int64_t>(x / cell)] = id;
    active.push_back(id);
  };

  insert(uni(rng) * height, uni(rng) * width);

  while (!active.empty() &&
         static_cast<int64_t>(py.size()) < max_points) {
    size_t pick = static_cast<size_t>(uni(rng) * active.size());
    if (pick >= active.size()) pick = active.size() - 1;
    int64_t base = active[pick];
    double radius = radius_at(py[base], px[base]);

    bool placed = false;
    for (int32_t attempt = 0; attempt < k; ++attempt) {
      double rho = radius * (1.0 + uni(rng));
      double theta = uni(rng) * 2.0 * M_PI;
      double cy = py[base] + rho * std::sin(theta);
      double cx = px[base] + rho * std::cos(theta);
      if (cy < 0 || cy >= height || cx < 0 || cx >= width) continue;
      if (fits(cy, cx, radius_at(cy, cx))) {
        insert(cy, cx);
        placed = true;
        break;
      }
    }
    if (!placed) {
      active[pick] = active.back();
      active.pop_back();
    }
  }

  int64_t n = static_cast<int64_t>(py.size());
  for (int64_t i = 0; i < n; ++i) {
    out_points[2 * i] = static_cast<float>(py[i]);
    out_points[2 * i + 1] = static_cast<float>(px[i]);
  }
  return n;
}

// ---------------------------------------------------------------------------
// Connected components (4-connectivity) — replaces
// cv2.connectedComponentsWithStats in the rejection filter (main.py:175).
// ---------------------------------------------------------------------------

int32_t ff_connected_components(const uint8_t* mask, int64_t height,
                                int64_t width) {
  std::vector<int32_t> labels(height * width, 0);
  std::vector<int64_t> stack;
  int32_t current = 0;
  for (int64_t sy = 0; sy < height; ++sy) {
    for (int64_t sx = 0; sx < width; ++sx) {
      int64_t si = sy * width + sx;
      if (!mask[si] || labels[si]) continue;
      ++current;
      labels[si] = current;
      stack.push_back(si);
      while (!stack.empty()) {
        int64_t i = stack.back();
        stack.pop_back();
        int64_t y = i / width, x = i % width;
        const int64_t ns[4][2] = {{y - 1, x}, {y + 1, x}, {y, x - 1}, {y, x + 1}};
        for (auto& nb : ns) {
          if (nb[0] < 0 || nb[0] >= height || nb[1] < 0 || nb[1] >= width) continue;
          int64_t j = nb[0] * width + nb[1];
          if (mask[j] && !labels[j]) {
            labels[j] = current;
            stack.push_back(j);
          }
        }
      }
    }
  }
  return current;
}

// ---------------------------------------------------------------------------
// Morton ordering of face centroids (Pallas cluster packing).
// ---------------------------------------------------------------------------

static uint64_t spread10(uint64_t x) {
  x = (x | (x << 16)) & 0x030000FFull;
  x = (x | (x << 8)) & 0x0300F00Full;
  x = (x | (x << 4)) & 0x030C30C3ull;
  x = (x | (x << 2)) & 0x09249249ull;
  return x;
}

void ff_morton_order(const float* centroids, int64_t n, int32_t* out_order) {
  double lo[3] = {1e30, 1e30, 1e30}, hi[3] = {-1e30, -1e30, -1e30};
  for (int64_t i = 0; i < n; ++i) {
    for (int j = 0; j < 3; ++j) {
      lo[j] = std::min(lo[j], static_cast<double>(centroids[3 * i + j]));
      hi[j] = std::max(hi[j], static_cast<double>(centroids[3 * i + j]));
    }
  }
  std::vector<std::pair<uint64_t, int32_t>> keyed(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t q[3];
    for (int j = 0; j < 3; ++j) {
      double span = std::max(hi[j] - lo[j], 1e-12);
      double t = (centroids[3 * i + j] - lo[j]) / span;
      q[j] = static_cast<uint64_t>(std::min(std::max(t * 1023.0, 0.0), 1023.0));
    }
    keyed[i] = {(spread10(q[0]) << 2) | (spread10(q[1]) << 1) | spread10(q[2]),
                static_cast<int32_t>(i)};
  }
  std::stable_sort(keyed.begin(), keyed.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  for (int64_t i = 0; i < n; ++i) out_order[i] = keyed[i].second;
}

}  // extern "C"
