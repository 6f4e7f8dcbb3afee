// Host mesh processing, exposed to Python through ctypes
// (`mvedit_tpu_torch/native/__init__.py`). A copy of the vertex weld and the
// decimation in `mvedit_tpu/native/mesh_native.cpp`, so that both packages
// weld and simplify a mesh to the same vertices and faces: the decimation
// stands in for Open3D's simplify_quadric_decimation after the DMTet
// extraction.
//
// Exposed C API (plain arrays, the caller allocates the outputs at the
// input's sizes):
//   weld_vertices: spatial-hash merge of the vertices that fall into one
//                  cell of edge eps; returns the new vertex count.
//   decimate_qem:  edge-collapse simplification to ~target_faces; returns
//                  (face count << 32) | vertex count.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <unordered_map>
#include <algorithm>
#include <functional>

extern "C" {

// ---------------------------------------------------------------------------
// weld_vertices: merge vertices closer than eps. Returns new vertex count.
// remap[v_old] = v_new index into out_verts, in first-seen order.
// ---------------------------------------------------------------------------
int64_t weld_vertices(const float* verts, int64_t n_verts, float eps,
                      float* out_verts, int64_t* remap) {
    struct Key { int64_t x, y, z; };
    struct KeyHash {
        size_t operator()(const Key& k) const {
            return (size_t)(k.x * 73856093LL ^ k.y * 19349663LL
                            ^ k.z * 83492791LL);
        }
    };
    struct KeyEq {
        bool operator()(const Key& a, const Key& b) const {
            return a.x == b.x && a.y == b.y && a.z == b.z;
        }
    };
    const float inv = eps > 0 ? 1.0f / eps : 1e12f;
    std::unordered_map<Key, int64_t, KeyHash, KeyEq> grid;
    grid.reserve((size_t)n_verts);
    int64_t n_out = 0;
    for (int64_t i = 0; i < n_verts; ++i) {
        const float* p = verts + 3 * i;
        Key k{(int64_t)std::floor(p[0] * inv),
              (int64_t)std::floor(p[1] * inv),
              (int64_t)std::floor(p[2] * inv)};
        auto it = grid.find(k);
        if (it == grid.end()) {
            grid.emplace(k, n_out);
            std::memcpy(out_verts + 3 * n_out, p, 3 * sizeof(float));
            remap[i] = n_out++;
        } else {
            remap[i] = it->second;
        }
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// Quadric-error-metric decimation (Garland-Heckbert). Simplifies in place
// to ~target_faces; out arrays sized for the input.
// ---------------------------------------------------------------------------
namespace {

struct Quadric {
    double m[10];  // symmetric 4x4: a2 ab ac ad b2 bc bd c2 cd d2
    Quadric() { std::memset(m, 0, sizeof(m)); }
    void add_plane(double a, double b, double c, double d) {
        m[0] += a * a; m[1] += a * b; m[2] += a * c; m[3] += a * d;
        m[4] += b * b; m[5] += b * c; m[6] += b * d;
        m[7] += c * c; m[8] += c * d; m[9] += d * d;
    }
    void add(const Quadric& o) {
        for (int i = 0; i < 10; ++i) m[i] += o.m[i];
    }
    double eval(const double* v) const {
        double x = v[0], y = v[1], z = v[2];
        return m[0]*x*x + 2*m[1]*x*y + 2*m[2]*x*z + 2*m[3]*x
             + m[4]*y*y + 2*m[5]*y*z + 2*m[6]*y
             + m[7]*z*z + 2*m[8]*z + m[9];
    }
};

struct Collapse {
    double cost;
    int64_t u, v;        // collapse u -> v
    uint64_t stamp;      // validity stamp of u and v at push time
    bool operator<(const Collapse& o) const { return cost > o.cost; }
};

}  // namespace

int64_t decimate_qem(const float* verts_in, int64_t n_verts,
                     const int32_t* faces_in, int64_t n_faces,
                     int64_t target_faces,
                     float* verts_out, int32_t* faces_out) {
    std::vector<double> V(3 * n_verts);
    for (int64_t i = 0; i < 3 * n_verts; ++i) V[i] = verts_in[i];
    std::vector<int32_t> F(faces_in, faces_in + 3 * n_faces);
    std::vector<Quadric> Q(n_verts);
    std::vector<uint64_t> stamp(n_verts, 0);
    std::vector<char> face_dead(n_faces, 0);
    // vertex -> incident faces
    std::vector<std::vector<int32_t>> vfaces(n_verts);
    for (int64_t f = 0; f < n_faces; ++f)
        for (int j = 0; j < 3; ++j) vfaces[F[3*f+j]].push_back((int32_t)f);

    auto face_quadric = [&](int64_t f, Quadric& q) {
        const double* a = &V[3 * F[3*f]];
        const double* b = &V[3 * F[3*f+1]];
        const double* c = &V[3 * F[3*f+2]];
        double ux = b[0]-a[0], uy = b[1]-a[1], uz = b[2]-a[2];
        double vx = c[0]-a[0], vy = c[1]-a[1], vz = c[2]-a[2];
        double nx = uy*vz - uz*vy, ny = uz*vx - ux*vz, nz = ux*vy - uy*vx;
        double len = std::sqrt(nx*nx + ny*ny + nz*nz);
        if (len < 1e-20) return;
        nx /= len; ny /= len; nz /= len;
        double d = -(nx*a[0] + ny*a[1] + nz*a[2]);
        q.add_plane(nx, ny, nz, d);
    };
    for (int64_t f = 0; f < n_faces; ++f) {
        Quadric q;
        face_quadric(f, q);
        for (int j = 0; j < 3; ++j) Q[F[3*f+j]].add(q);
    }

    std::priority_queue<Collapse> heap;
    auto push_edge = [&](int64_t u, int64_t v) {
        if (u == v) return;
        Quadric q = Q[u]; q.add(Q[v]);
        // candidate position: midpoint vs endpoints (cheap, robust)
        double mid[3] = {(V[3*u]+V[3*v])/2, (V[3*u+1]+V[3*v+1])/2,
                         (V[3*u+2]+V[3*v+2])/2};
        double cu = q.eval(&V[3*u]), cv = q.eval(&V[3*v]), cm = q.eval(mid);
        double cost = std::min(cm, std::min(cu, cv));
        heap.push({cost, u, v, stamp[u] + (stamp[v] << 32)});
    };
    for (int64_t f = 0; f < n_faces; ++f)
        for (int j = 0; j < 3; ++j)
            push_edge(F[3*f+j], F[3*f+(j+1)%3]);

    std::vector<int64_t> parent(n_verts);
    for (int64_t i = 0; i < n_verts; ++i) parent[i] = i;
    std::function<int64_t(int64_t)> find = [&](int64_t x) {
        while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
        return x;
    };

    int64_t live_faces = n_faces;
    while (live_faces > target_faces && !heap.empty()) {
        Collapse c = heap.top(); heap.pop();
        int64_t u = find(c.u), v = find(c.v);
        if (u == v) continue;
        if (c.stamp != (stamp[c.u] + (stamp[c.v] << 32))) continue;
        // choose best position
        Quadric q = Q[u]; q.add(Q[v]);
        double mid[3] = {(V[3*u]+V[3*v])/2, (V[3*u+1]+V[3*v+1])/2,
                         (V[3*u+2]+V[3*v+2])/2};
        double cu = q.eval(&V[3*u]), cv = q.eval(&V[3*v]), cm = q.eval(mid);
        const double* best = cm <= cu && cm <= cv ? mid
                           : (cu <= cv ? &V[3*u] : &V[3*v]);
        double pos[3] = {best[0], best[1], best[2]};
        // collapse u into v
        parent[u] = v;
        V[3*v] = pos[0]; V[3*v+1] = pos[1]; V[3*v+2] = pos[2];
        Q[v] = q;
        stamp[u]++; stamp[v]++;
        // update faces
        auto& fu = vfaces[u];
        auto& fv = vfaces[v];
        for (int32_t f : fu) {
            if (face_dead[f]) continue;
            int32_t a = (int32_t)find(F[3*f]);
            int32_t b = (int32_t)find(F[3*f+1]);
            int32_t cc = (int32_t)find(F[3*f+2]);
            if (a == b || b == cc || a == cc) {
                face_dead[f] = 1;
                --live_faces;
            } else {
                fv.push_back(f);
            }
        }
        fu.clear();
        // re-push edges around v
        for (int32_t f : fv) {
            if (face_dead[f]) continue;
            for (int j = 0; j < 3; ++j) {
                int64_t a = find(F[3*f+j]), b = find(F[3*f+(j+1)%3]);
                if (a == v || b == v) push_edge(a, b);
            }
        }
    }

    // compact output
    std::vector<int64_t> new_id(n_verts, -1);
    int64_t nv = 0, nf = 0;
    for (int64_t f = 0; f < n_faces; ++f) {
        if (face_dead[f]) continue;
        int64_t a = find(F[3*f]), b = find(F[3*f+1]), c2 = find(F[3*f+2]);
        if (a == b || b == c2 || a == c2) continue;
        int64_t ids[3] = {a, b, c2};
        for (int j = 0; j < 3; ++j) {
            if (new_id[ids[j]] < 0) {
                new_id[ids[j]] = nv;
                verts_out[3*nv] = (float)V[3*ids[j]];
                verts_out[3*nv+1] = (float)V[3*ids[j]+1];
                verts_out[3*nv+2] = (float)V[3*ids[j]+2];
                ++nv;
            }
            faces_out[3*nf+j] = (int32_t)new_id[ids[j]];
        }
        ++nf;
    }
    // (face count << 32) | vertex count
    return (nf << 32) | (int64_t)nv;
}

}  // extern "C"
