// tpurt native runtime components.
//
// Reference analog: the reference's entire runtime is C++ (SURVEY.md §2);
// here the HOT HOST-SIDE pre-render work gets native implementations while
// the compute path stays JAX/XLA:
//   - SAH BVH build (accelerators/bvh.cpp:236-402 equivalent: 12-bucket
//     SAH over primitive bounds, 1-prim leaves, depth-first flattening
//     with right-child offsets) — the numpy builder takes ~5 s on the
//     66k-triangle killeroo mesh, this takes ~0.1 s.
//   - Halton scrambling-permutation generation (PCG32 + Fisher-Yates,
//     bit-exact with core/rng.h:61-144 + sampling.h:151) — ~3.7M
//     sequential draws that cost ~40 s in Python.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libtpurt_native.so
//            tpurt_native.cpp
// Loaded via ctypes (tpurt/native.py) with a pure-Python fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PCG32 (bit-exact with the reference's core/rng.h)
// ---------------------------------------------------------------------------

struct Pcg32 {
    uint64_t state = 0x853c49e6748fea9bULL;
    uint64_t inc = 0xda3e39cb94b95bdbULL;

    uint32_t next() {
        uint64_t old = state;
        state = old * 0x5851f42d4c957f2dULL + inc;
        uint32_t xorshifted = (uint32_t)(((old >> 18u) ^ old) >> 27u);
        uint32_t rot = (uint32_t)(old >> 59u);
        return (xorshifted >> rot) | (xorshifted << ((~rot + 1u) & 31));
    }
    uint32_t bounded(uint32_t b) {
        uint32_t threshold = (~b + 1u) % b;
        for (;;) {
            uint32_t r = next();
            if (r >= threshold) return r % b;
        }
    }
};

// Fills perms with the concatenated digit permutations for the given prime
// bases (ComputeRadicalInversePermutations, lowdiscrepancy.cpp:2490).
void gen_halton_perms(uint16_t* perms, const int32_t* primes, int n_primes) {
    Pcg32 rng;  // default stream, like the reference's RNG()
    size_t off = 0;
    for (int i = 0; i < n_primes; ++i) {
        int p = primes[i];
        for (int j = 0; j < p; ++j) perms[off + j] = (uint16_t)j;
        // Shuffle (sampling.h:151): swap i with i + U(count - i)
        for (int j = 0; j < p; ++j) {
            int other = j + (int)rng.bounded((uint32_t)(p - j));
            std::swap(perms[off + j], perms[off + other]);
        }
        off += (size_t)p;
    }
}

// ---------------------------------------------------------------------------
// SAH BVH build (12 buckets, 1-prim leaves, DFS layout)
// ---------------------------------------------------------------------------

namespace {

constexpr int kBuckets = 12;
constexpr double kTraversalCost = 1.0 / 8.0;

struct BuildCtx {
    const float* lo;     // (n, 3)
    const float* hi;     // (n, 3)
    std::vector<double> cx, cy, cz;  // centroids
    // outputs
    float* nb_lo;        // (cap, 3)
    float* nb_hi;
    int32_t* right;
    int32_t* prim_off;
    int32_t* n_prims;
    int32_t* axis;
    int32_t* order;      // (n,)
    int next_node = 0;
    int order_len = 0;
    int max_leaf = 1;
};

double area3(const double b_lo[3], const double b_hi[3]) {
    double d0 = std::max(0.0, b_hi[0] - b_lo[0]);
    double d1 = std::max(0.0, b_hi[1] - b_lo[1]);
    double d2 = std::max(0.0, b_hi[2] - b_lo[2]);
    return 2.0 * (d0 * d1 + d0 * d2 + d1 * d2);
}

int build_range(BuildCtx& c, int32_t* prims, int count) {
    int node = c.next_node++;
    double b_lo[3] = {1e300, 1e300, 1e300};
    double b_hi[3] = {-1e300, -1e300, -1e300};
    for (int i = 0; i < count; ++i) {
        const float* plo = c.lo + 3 * prims[i];
        const float* phi = c.hi + 3 * prims[i];
        for (int k = 0; k < 3; ++k) {
            b_lo[k] = std::min(b_lo[k], (double)plo[k]);
            b_hi[k] = std::max(b_hi[k], (double)phi[k]);
        }
    }
    for (int k = 0; k < 3; ++k) {
        c.nb_lo[3 * node + k] = std::nextafterf((float)b_lo[k],
                                                -std::numeric_limits<float>::infinity());
        c.nb_hi[3 * node + k] = std::nextafterf((float)b_hi[k],
                                                std::numeric_limits<float>::infinity());
    }

    auto make_leaf = [&]() {
        c.prim_off[node] = c.order_len;
        c.n_prims[node] = count;
        for (int i = 0; i < count; ++i) c.order[c.order_len++] = prims[i];
        c.right[node] = 0;
        c.axis[node] = 0;
        return node;
    };

    if (count == 1) return make_leaf();

    const double* cent[3] = {c.cx.data(), c.cy.data(), c.cz.data()};
    double c_lo[3] = {1e300, 1e300, 1e300}, c_hi[3] = {-1e300, -1e300, -1e300};
    for (int i = 0; i < count; ++i)
        for (int k = 0; k < 3; ++k) {
            double v = cent[k][prims[i]];
            c_lo[k] = std::min(c_lo[k], v);
            c_hi[k] = std::max(c_hi[k], v);
        }
    int dim = 0;
    double ext = c_hi[0] - c_lo[0];
    for (int k = 1; k < 3; ++k)
        if (c_hi[k] - c_lo[k] > ext) { ext = c_hi[k] - c_lo[k]; dim = k; }

    int mid;
    if (c_hi[dim] == c_lo[dim]) {
        if (count <= c.max_leaf) return make_leaf();
        mid = count / 2;  // degenerate: arbitrary halving (numpy parity)
    } else if (count <= 2) {
        mid = count / 2;
        std::nth_element(prims, prims + mid, prims + count,
                         [&](int a, int b) { return cent[dim][a] < cent[dim][b]; });
    } else {
        // 12-bucket SAH sweep
        double inv_ext = 1.0 / (c_hi[dim] - c_lo[dim]);
        int counts[kBuckets] = {0};
        double blo[kBuckets][3], bhi[kBuckets][3];
        for (int b = 0; b < kBuckets; ++b)
            for (int k = 0; k < 3; ++k) { blo[b][k] = 1e300; bhi[b][k] = -1e300; }
        auto bucket_of = [&](int p) {
            int b = (int)(kBuckets * (cent[dim][p] - c_lo[dim]) * inv_ext);
            return std::min(b, kBuckets - 1);
        };
        for (int i = 0; i < count; ++i) {
            int p = prims[i];
            int b = bucket_of(p);
            counts[b]++;
            for (int k = 0; k < 3; ++k) {
                blo[b][k] = std::min(blo[b][k], (double)c.lo[3 * p + k]);
                bhi[b][k] = std::max(bhi[b][k], (double)c.hi[3 * p + k]);
            }
        }
        double best_cost = 1e300;
        int best = 0;
        double total_area = std::max(area3(b_lo, b_hi), 1e-30);
        for (int split = 0; split < kBuckets - 1; ++split) {
            double l_lo[3] = {1e300, 1e300, 1e300}, l_hi[3] = {-1e300, -1e300, -1e300};
            double r_lo[3] = {1e300, 1e300, 1e300}, r_hi[3] = {-1e300, -1e300, -1e300};
            int nl = 0, nr = 0;
            for (int b = 0; b <= split; ++b) {
                nl += counts[b];
                for (int k = 0; k < 3; ++k) {
                    l_lo[k] = std::min(l_lo[k], blo[b][k]);
                    l_hi[k] = std::max(l_hi[k], bhi[b][k]);
                }
            }
            for (int b = split + 1; b < kBuckets; ++b) {
                nr += counts[b];
                for (int k = 0; k < 3; ++k) {
                    r_lo[k] = std::min(r_lo[k], blo[b][k]);
                    r_hi[k] = std::max(r_hi[k], bhi[b][k]);
                }
            }
            double cost = kTraversalCost
                + (nl * (nl ? area3(l_lo, l_hi) : 0.0)
                   + nr * (nr ? area3(r_lo, r_hi) : 0.0)) / total_area;
            if (cost < best_cost) { best_cost = cost; best = split; }
        }
        if (count <= c.max_leaf && best_cost >= (double)count) return make_leaf();
        int32_t* m = std::partition(prims, prims + count, [&](int p) {
            return bucket_of(p) <= best;
        });
        mid = (int)(m - prims);
        if (mid == 0 || mid == count) {
            mid = count / 2;
            std::nth_element(prims, prims + mid, prims + count,
                             [&](int a, int b) { return cent[dim][a] < cent[dim][b]; });
        }
    }

    c.n_prims[node] = 0;
    c.axis[node] = dim;
    build_range(c, prims, mid);
    c.right[node] = build_range(c, prims + mid, count - mid);
    return node;
}

}  // namespace

// ---------------------------------------------------------------------------
// SAH kd-tree build (accelerators/kdtreeaccel.cpp:44-349 semantics:
// per-axis edge-event sweep, empty bonus, bad-refine retries, prim
// duplication across leaves).  Nodes are emitted depth-first with the
// below child adjacent (node+1) and the above child recorded, matching
// the reference's flat layout (kdtreeaccel.h:55-92).
// ---------------------------------------------------------------------------

namespace kd {

struct Edge {
    float t;
    int prim;
    bool start;
    bool operator<(const Edge& o) const {
        if (t == o.t) return (int)start > (int)o.start;  // starts first
        return t < o.t;
    }
};

struct Ctx {
    const float* lo;
    const float* hi;
    int isect_cost, trav_cost, max_prims, max_depth;
    double empty_bonus;
    // outputs
    std::vector<float> split;
    std::vector<int32_t> axis;     // 0..2 interior, 3 leaf
    std::vector<int32_t> above;    // above-child node id (interior)
    std::vector<int32_t> prim_off;
    std::vector<int32_t> n_prims;
    std::vector<int32_t> indices;
};

double sa(const double b[6]) {
    double d0 = std::max(0.0, b[3] - b[0]);
    double d1 = std::max(0.0, b[4] - b[1]);
    double d2 = std::max(0.0, b[5] - b[2]);
    return 2.0 * (d0 * d1 + d0 * d2 + d1 * d2);
}

int make_leaf(Ctx& c, const int32_t* prims, int n) {
    int node = (int)c.split.size();
    c.split.push_back(0.f);
    c.axis.push_back(3);
    c.above.push_back(-1);
    c.prim_off.push_back((int32_t)c.indices.size());
    c.n_prims.push_back(n);
    for (int i = 0; i < n; ++i) c.indices.push_back(prims[i]);
    return node;
}

int build(Ctx& c, const double bounds[6], const int32_t* prims, int n,
          int depth, std::vector<Edge>& edges, int bad_refines) {
    if (n <= c.max_prims || depth == 0) return make_leaf(c, prims, n);

    // pick best split: start at the largest extent, retry other axes
    int best_axis = -1, best_edge = -1;
    double best_cost = 1e300;
    double old_cost = (double)c.isect_cost * n;
    double inv_sa = 1.0 / std::max(sa(bounds), 1e-300);
    double d[3] = {bounds[3] - bounds[0], bounds[4] - bounds[1],
                   bounds[5] - bounds[2]};
    int axis0 = 0;
    if (d[1] > d[axis0]) axis0 = 1;
    if (d[2] > d[axis0]) axis0 = 2;
    std::vector<Edge> best_edges;
    for (int retry = 0; retry < 3; ++retry) {
        int axis = (axis0 + retry) % 3;
        edges.clear();
        edges.reserve(2 * n);
        for (int i = 0; i < n; ++i) {
            int p = prims[i];
            edges.push_back({c.lo[3 * p + axis], p, true});
            edges.push_back({c.hi[3 * p + axis], p, false});
        }
        std::sort(edges.begin(), edges.end());
        int n_below = 0, n_above = n;
        for (int i = 0; i < 2 * n; ++i) {
            if (!edges[i].start) --n_above;
            double t = edges[i].t;
            if (t > bounds[axis] && t < bounds[3 + axis]) {
                int o1 = (axis + 1) % 3, o2 = (axis + 2) % 3;
                double bsa = 2.0 * (d[o1] * d[o2]
                             + (t - bounds[axis]) * (d[o1] + d[o2]));
                double asa = 2.0 * (d[o1] * d[o2]
                             + (bounds[3 + axis] - t) * (d[o1] + d[o2]));
                double pb = bsa * inv_sa, pa = asa * inv_sa;
                double eb = (n_above == 0 || n_below == 0) ? c.empty_bonus
                                                           : 0.0;
                double cost = c.trav_cost + c.isect_cost * (1.0 - eb)
                              * (pb * n_below + pa * n_above);
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_edge = i;
                }
            }
            if (edges[i].start) ++n_below;
        }
        if (best_axis != -1) {
            if (best_axis == axis) best_edges = edges;
            break;
        }
    }
    if (best_cost > old_cost) ++bad_refines;
    if ((best_cost > 4.0 * old_cost && n < 16) || best_axis == -1 ||
        bad_refines == 3)
        return make_leaf(c, prims, n);

    // classify prims against the chosen edge
    std::vector<int32_t> below;
    std::vector<int32_t> above_p;
    for (int i = 0; i < best_edge; ++i)
        if (best_edges[i].start) below.push_back(best_edges[i].prim);
    for (int i = best_edge + 1; i < 2 * n; ++i)
        if (!best_edges[i].start) above_p.push_back(best_edges[i].prim);

    float tsplit = best_edges[best_edge].t;
    int node = (int)c.split.size();
    c.split.push_back(tsplit);
    c.axis.push_back(best_axis);
    c.above.push_back(-1);
    c.prim_off.push_back(0);
    c.n_prims.push_back(0);

    double b0[6], b1[6];
    std::memcpy(b0, bounds, sizeof b0);
    std::memcpy(b1, bounds, sizeof b1);
    b0[3 + best_axis] = tsplit;
    b1[best_axis] = tsplit;
    build(c, b0, below.data(), (int)below.size(), depth - 1, edges,
          bad_refines);
    c.above[node] = build(c, b1, above_p.data(), (int)above_p.size(),
                          depth - 1, edges, bad_refines);
    return node;
}

}  // namespace kd

// SAH kd-tree over n primitive bounds.  Node outputs are capped at
// node_cap entries and leaf prim indices at idx_cap; returns the node
// count, or -(needed_nodes) when a cap is too small (caller retries with
// bigger buffers).  n_indices_out receives the index count.
int32_t build_kdtree_sah(const float* lo, const float* hi, int32_t n,
                         int32_t isect_cost, int32_t trav_cost,
                         float empty_bonus, int32_t max_prims,
                         int32_t max_depth, int32_t node_cap,
                         int32_t idx_cap, float* split_out,
                         int32_t* axis_out, int32_t* above_out,
                         int32_t* prim_off_out, int32_t* n_prims_out,
                         int32_t* indices_out, float* bounds_out,
                         int32_t* n_indices_out) {
    if (n <= 0) return -1;
    kd::Ctx c;
    c.lo = lo;
    c.hi = hi;
    c.isect_cost = isect_cost;
    c.trav_cost = trav_cost;
    c.empty_bonus = empty_bonus;
    c.max_prims = std::max(1, (int)max_prims);
    c.max_depth = max_depth > 0
        ? max_depth
        : (int)std::lround(8.0 + 1.3 * std::log2((double)n));

    double bounds[6] = {1e300, 1e300, 1e300, -1e300, -1e300, -1e300};
    for (int i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k) {
            bounds[k] = std::min(bounds[k], (double)lo[3 * i + k]);
            bounds[3 + k] = std::max(bounds[3 + k], (double)hi[3 * i + k]);
        }
    std::vector<int32_t> prims(n);
    for (int i = 0; i < n; ++i) prims[i] = i;
    std::vector<kd::Edge> edges;
    kd::build(c, bounds, prims.data(), n, c.max_depth, edges, 0);

    int m = (int)c.split.size();
    if (m > node_cap || (int)c.indices.size() > idx_cap)
        return -std::max(m, (int)c.indices.size());
    std::memcpy(split_out, c.split.data(), m * sizeof(float));
    std::memcpy(axis_out, c.axis.data(), m * sizeof(int32_t));
    std::memcpy(above_out, c.above.data(), m * sizeof(int32_t));
    std::memcpy(prim_off_out, c.prim_off.data(), m * sizeof(int32_t));
    std::memcpy(n_prims_out, c.n_prims.data(), m * sizeof(int32_t));
    std::memcpy(indices_out, c.indices.data(),
                c.indices.size() * sizeof(int32_t));
    for (int k = 0; k < 6; ++k) bounds_out[k] = (float)bounds[k];
    *n_indices_out = (int32_t)c.indices.size();
    return m;
}

// Returns the number of nodes written, or -1 on error.  Output buffers must
// have capacity for 2*n nodes; order for n entries.
int32_t build_bvh_sah(const float* lo, const float* hi, int32_t n,
                      int32_t max_leaf, float* nb_lo, float* nb_hi,
                      int32_t* right, int32_t* prim_off, int32_t* n_prims,
                      int32_t* axis, int32_t* order) {
    if (n <= 0) return -1;
    BuildCtx c;
    c.lo = lo;
    c.hi = hi;
    c.cx.resize(n);
    c.cy.resize(n);
    c.cz.resize(n);
    for (int i = 0; i < n; ++i) {
        c.cx[i] = 0.5 * ((double)lo[3 * i] + hi[3 * i]);
        c.cy[i] = 0.5 * ((double)lo[3 * i + 1] + hi[3 * i + 1]);
        c.cz[i] = 0.5 * ((double)lo[3 * i + 2] + hi[3 * i + 2]);
    }
    c.nb_lo = nb_lo;
    c.nb_hi = nb_hi;
    c.right = right;
    c.prim_off = prim_off;
    c.n_prims = n_prims;
    c.axis = axis;
    c.order = order;
    c.max_leaf = std::max(1, (int)max_leaf);

    std::vector<int32_t> prims(n);
    for (int i = 0; i < n; ++i) prims[i] = i;
    build_range(c, prims.data(), n);
    return c.next_node;
}

}  // extern "C"
