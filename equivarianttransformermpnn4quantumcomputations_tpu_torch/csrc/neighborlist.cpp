// Host neighbour-list builder of the data pipeline (the port's copy of the
// JAX package's csrc/neighborlist.cpp, bound by ctypes in data/native.py).
//
// It returns the edges of data/graph.py's numpy path, in the numpy path's
// order:
//  * edges point src -> dst; for PBC, dst is the imaged atom:
//      dvec = pos[dst] + shift @ cell - pos[src];
//  * the 27 first-shell images in numpy's meshgrid order (the first shift
//    component slowest), and within an image src-major, dst-minor (the order
//    of np.nonzero over the [src, dst] distance matrix);
//  * an edge is kept when its distance d = sqrt(dx*dx + dy*dy + dz*dz) is
//    below the cutoff; self-pairs are dropped in the central image only,
//    where d <= 1e-8 (non-PBC) or d <= 1e-6 (PBC);
//  * per-dst cap: keep the max_neighbors closest sources (ties to the edge
//    enumerated first, as numpy's stable lexsort), in enumeration order.
// The distances are computed in numpy's order of operations; build with
// -ffp-contract=off so that no fused multiply-add changes a rounding.
//
// Build:  g++ -O3 -ffp-contract=off -shared -fPIC -o libneighborlist.so neighborlist.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Edge {
    int64_t src;
    int64_t dst;
    int32_t shift[3];
    double dist;
};

}  // namespace

extern "C" {

// Returns the number of edges found; writes them when that number is at most
// `capacity` (else nothing is written and the caller retries larger).
int64_t etq_neighbor_list(
    const double* pos,      // [n, 3]
    int64_t n,
    const double* cell,     // [3, 3] row-major (read only when pbc)
    int32_t pbc,
    double cutoff,
    int64_t max_neighbors,  // -1 = no cap
    int64_t* out_src,       // [capacity]
    int64_t* out_dst,       // [capacity]
    int32_t* out_shift,     // [capacity, 3]
    int64_t capacity) {
    std::vector<Edge> edges;
    const int s_lo = pbc ? -1 : 0;
    const int s_hi = pbc ? 1 : 0;
    const double lo = pbc ? 1e-6 : 1e-8;

    for (int sa = s_lo; sa <= s_hi; ++sa) {
        for (int sb = s_lo; sb <= s_hi; ++sb) {
            for (int sc = s_lo; sc <= s_hi; ++sc) {
                double off[3] = {0.0, 0.0, 0.0};
                if (pbc) {
                    for (int k = 0; k < 3; ++k) {
                        off[k] = sa * cell[0 * 3 + k] + sb * cell[1 * 3 + k] +
                                 sc * cell[2 * 3 + k];
                    }
                }
                const bool central = (sa == 0 && sb == 0 && sc == 0);
                for (int64_t i = 0; i < n; ++i) {          // src
                    for (int64_t j = 0; j < n; ++j) {      // dst
                        const double dx = (pos[j * 3 + 0] + off[0]) - pos[i * 3 + 0];
                        const double dy = (pos[j * 3 + 1] + off[1]) - pos[i * 3 + 1];
                        const double dz = (pos[j * 3 + 2] + off[2]) - pos[i * 3 + 2];
                        const double d = std::sqrt(dx * dx + dy * dy + dz * dz);
                        if (!(d < cutoff)) continue;
                        if (central && !(d > lo)) continue;
                        edges.push_back({i, j, {sa, sb, sc}, d});
                    }
                }
            }
        }
    }

    if (max_neighbors >= 0 && !edges.empty()) {
        std::vector<int64_t> order(edges.size());
        std::iota(order.begin(), order.end(), 0);
        std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
            if (edges[a].dst != edges[b].dst) return edges[a].dst < edges[b].dst;
            return edges[a].dist < edges[b].dist;
        });
        std::vector<char> keep(edges.size(), 0);
        int64_t rank = 0;
        for (size_t r = 0; r < order.size(); ++r) {
            rank = (r > 0 && edges[order[r]].dst == edges[order[r - 1]].dst) ? rank + 1 : 0;
            keep[order[r]] = rank < max_neighbors;
        }
        size_t w = 0;
        for (size_t e = 0; e < edges.size(); ++e) {
            if (keep[e]) edges[w++] = edges[e];
        }
        edges.resize(w);
    }

    const int64_t total = static_cast<int64_t>(edges.size());
    if (total > capacity) return total;
    for (int64_t e = 0; e < total; ++e) {
        out_src[e] = edges[e].src;
        out_dst[e] = edges[e].dst;
        out_shift[e * 3 + 0] = edges[e].shift[0];
        out_shift[e * 3 + 1] = edges[e].shift[1];
        out_shift[e * 3 + 2] = edges[e].shift[2];
    }
    return total;
}

}  // extern "C"
