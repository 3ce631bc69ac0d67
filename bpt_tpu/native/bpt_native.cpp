// Native host runtime for bpt_tpu: BVH builder + OBJ parser.
//
// The device never sees this code — it is the host-side scene compiler
// (the analog of the reference's C++ scene_loader.h + bvh.h startup path),
// exposed to Python through a plain C ABI via ctypes.
//
// The BVH build implements EXACTLY the policy of the reference
// (src/acceleration/bvh.h:20-48) and of scene/bvh.py (the numpy fallback):
// node bbox = union of member bboxes padded to min width 1e-4 per axis
// (src/acceleration/aabb.h:81-88), split axis = longest axis of the node
// bbox, stable sort of the span by per-triangle bbox min on that axis,
// median split; spans of 1-2 are leaves.  Output is the same threaded-DFS
// preorder (skip links) the Python builder emits; the test suite asserts
// array-for-array equality between the two builders.
//
// Build: g++ -O3 -march=native -shared -fPIC bpt_native.cpp -o libbpt_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

constexpr double kPadDelta = 1e-4;  // aabb.h:84

struct BuildCtx {
    const double* tri_min;  // [T][3]
    const double* tri_max;  // [T][3]
    std::vector<double> node_min;
    std::vector<double> node_max;
    std::vector<int32_t> node_skip;
    std::vector<int32_t> node_first;
    std::vector<int32_t> node_count;
    std::vector<int64_t> order;
};

void build_rec(BuildCtx& c, int64_t* idx, int64_t n) {
    const int64_t my_pos = static_cast<int64_t>(c.node_skip.size());

    double bmin[3] = {1e300, 1e300, 1e300};
    double bmax[3] = {-1e300, -1e300, -1e300};
    for (int64_t k = 0; k < n; ++k) {
        const double* lo = c.tri_min + 3 * idx[k];
        const double* hi = c.tri_max + 3 * idx[k];
        for (int a = 0; a < 3; ++a) {
            bmin[a] = std::min(bmin[a], lo[a]);
            bmax[a] = std::max(bmax[a], hi[a]);
        }
    }
    for (int a = 0; a < 3; ++a) {
        if (bmax[a] - bmin[a] < kPadDelta) {
            bmin[a] -= kPadDelta / 2.0;
            bmax[a] += kPadDelta / 2.0;
        }
    }
    for (int a = 0; a < 3; ++a) {
        c.node_min.push_back(bmin[a]);
        c.node_max.push_back(bmax[a]);
    }
    c.node_skip.push_back(-1);  // patched after the subtree is emitted

    if (n <= 2) {
        c.node_first.push_back(static_cast<int32_t>(c.order.size()));
        c.node_count.push_back(static_cast<int32_t>(n));
        for (int64_t k = 0; k < n; ++k) c.order.push_back(idx[k]);
    } else {
        c.node_first.push_back(0);
        c.node_count.push_back(0);
        int axis = 0;
        double best = bmax[0] - bmin[0];
        for (int a = 1; a < 3; ++a) {
            const double s = bmax[a] - bmin[a];
            if (s > best) {
                best = s;
                axis = a;
            }
        }
        std::stable_sort(idx, idx + n, [&](int64_t a, int64_t b) {
            return c.tri_min[3 * a + axis] < c.tri_min[3 * b + axis];
        });
        // median rounded to a 32-multiple: nearly every leaf then holds
        // 2 triangles (fewer nodes, a faster GPU traversal; see
        // scene/bvh.py rec(), which this must match exactly — parity
        // asserted by test_native)
        const int64_t kPack = 32;
        int64_t mid;
        if (n > kPack) {
            double r = static_cast<double>(n) / (2.0 * kPack);
            int64_t m = std::llround(r) * kPack;
            mid = std::min(std::max(m, kPack), n - 1);
        } else {
            mid = n / 2;  // bvh.h:43
        }
        build_rec(c, idx, mid);
        build_rec(c, idx + mid, n - mid);
    }
    c.node_skip[my_pos] = static_cast<int32_t>(c.node_skip.size());
}

}  // namespace

extern "C" {

// Returns the node count (<= 2*T).  Caller allocates:
//   node_min/node_max: [2*T+1][3] doubles
//   node_skip/node_first/node_count: [2*T+1] int32
//   order: [T] int64
int64_t bpt_build_bvh(const double* tri_min, const double* tri_max,
                      int64_t n_tris, double* node_min, double* node_max,
                      int32_t* node_skip, int32_t* node_first,
                      int32_t* node_count, int64_t* order) {
    if (n_tris <= 0) return 0;
    BuildCtx c;
    c.tri_min = tri_min;
    c.tri_max = tri_max;
    c.node_min.reserve(6 * n_tris);
    c.node_max.reserve(6 * n_tris);
    c.node_skip.reserve(2 * n_tris);
    c.node_first.reserve(2 * n_tris);
    c.node_count.reserve(2 * n_tris);
    c.order.reserve(n_tris);

    std::vector<int64_t> idx(n_tris);
    std::iota(idx.begin(), idx.end(), 0);
    build_rec(c, idx.data(), n_tris);

    const int64_t n_nodes = static_cast<int64_t>(c.node_skip.size());
    std::memcpy(node_min, c.node_min.data(), sizeof(double) * 3 * n_nodes);
    std::memcpy(node_max, c.node_max.data(), sizeof(double) * 3 * n_nodes);
    std::memcpy(node_skip, c.node_skip.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(node_first, c.node_first.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(node_count, c.node_count.data(), sizeof(int32_t) * n_nodes);
    std::memcpy(order, c.order.data(), sizeof(int64_t) * n_tris);
    return n_nodes;
}

// Minimal OBJ parse (reference semantics, scene_loader.h:345-397):
// only 'v'/'f' lines, token forms vi|vi/vt|vi/vt/vn|vi//vn, 1-based and
// negative indices, fan triangulation, malformed tokens skipped.
// Returns triangle count; *tris_out is malloc'd [n][3][3] doubles
// (release with bpt_free).  Returns -1 if the file cannot be opened.
int64_t bpt_parse_obj(const char* path, double** tris_out) {
    FILE* f = std::fopen(path, "r");
    if (!f) return -1;

    std::vector<double> verts;  // xyz triples
    std::vector<double> tris;   // 9 doubles per triangle
    std::vector<int64_t> fidx;

    char line[8192];
    while (std::fgets(line, sizeof(line), f)) {
        char* s = line;
        while (*s == ' ' || *s == '\t') ++s;
        if (s[0] == 'v' && (s[1] == ' ' || s[1] == '\t')) {
            double x, y, z;
            if (std::sscanf(s + 1, "%lf %lf %lf", &x, &y, &z) == 3) {
                verts.push_back(x);
                verts.push_back(y);
                verts.push_back(z);
            }
        } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
            fidx.clear();
            char* tok = std::strtok(s + 1, " \t\r\n");
            while (tok) {
                char* slash = std::strchr(tok, '/');
                if (slash) *slash = '\0';
                char* end = nullptr;
                const long vi = std::strtol(tok, &end, 10);
                if (end != tok && *end == '\0') {
                    const int64_t nv = static_cast<int64_t>(verts.size() / 3);
                    const int64_t id = vi > 0 ? vi - 1 : nv + vi;
                    fidx.push_back(id);
                }
                tok = std::strtok(nullptr, " \t\r\n");
            }
            if (fidx.size() >= 3) {
                for (size_t k = 2; k < fidx.size(); ++k) {
                    const int64_t ids[3] = {fidx[0], fidx[k - 1], fidx[k]};
                    for (int64_t id : ids) {
                        tris.push_back(verts[3 * id + 0]);
                        tris.push_back(verts[3 * id + 1]);
                        tris.push_back(verts[3 * id + 2]);
                    }
                }
            }
        }
    }
    std::fclose(f);

    const int64_t n = static_cast<int64_t>(tris.size() / 9);
    double* out = static_cast<double*>(std::malloc(tris.size() * sizeof(double)));
    std::memcpy(out, tris.data(), tris.size() * sizeof(double));
    *tris_out = out;
    return n;
}

void bpt_free(void* p) { std::free(p); }

}  // extern "C"
