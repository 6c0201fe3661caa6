// graphcore: host-side graph structure kernels of the PyTorch port.
//
// The build-time structure work that the reference does with python loops
// over scipy sparse matrices: K-hop BFS neighborhoods (graphTools.py:
// 378-527), Graclus matching for multilevel coarsening (graphTools.py:
// 1337-1614), and the dense -> band / dense -> BCSR tilings that feed the
// CUDA graph-shift kernels (spmm.cu). For large graphs these dominate
// model build time, so they are C++ with a ctypes binding
// (graph_neural_networks_torch/utils/native.py, which compiles this file
// with the host C++ compiler at first use) and numpy plain versions in
// utils/graph.py and ops/spmm.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// K-hop BFS from each of the first n_rows nodes over a CSR adjacency
// (indptr/indices), keeping only neighbors with index < nb.
// Writes per-node neighbor counts into counts[n_rows].
// Two-pass API: call with out == nullptr to get counts (and the max
// count via return value), then with out sized n_rows x max_count
// (padded with the row's own index, the reference's self-padding
// contract).
int64_t bfs_khop(const int64_t* indptr, const int64_t* indices,
                 int64_t n_nodes, int64_t k_hops, int64_t n_rows,
                 int64_t nb, int64_t* counts, int64_t* out,
                 int64_t max_count) {
    std::vector<int32_t> visited(n_nodes, -1);
    std::vector<int64_t> frontier, next_frontier, reached;
    int64_t global_max = 1;
    for (int64_t r = 0; r < n_rows; ++r) {
        frontier.clear();
        reached.clear();
        visited[r] = (int32_t)r;
        frontier.push_back(r);
        reached.push_back(r);
        for (int64_t hop = 0; hop < k_hops; ++hop) {
            next_frontier.clear();
            for (int64_t u : frontier) {
                for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
                    int64_t v = indices[e];
                    if (visited[v] != (int32_t)r) {
                        visited[v] = (int32_t)r;
                        next_frontier.push_back(v);
                        reached.push_back(v);
                    }
                }
            }
            frontier.swap(next_frontier);
            if (frontier.empty()) break;
        }
        // trim to < nb and sort
        std::vector<int64_t> kept;
        kept.reserve(reached.size());
        for (int64_t v : reached)
            if (v < nb) kept.push_back(v);
        std::sort(kept.begin(), kept.end());
        int64_t c = (int64_t)kept.size();
        counts[r] = c;
        if (c > global_max) global_max = c;
        if (out != nullptr) {
            for (int64_t i = 0; i < max_count; ++i)
                out[r * max_count + i] = (i < c) ? kept[i] : r;
        }
        // reset visited lazily via the marker trick (visited stores row id)
    }
    return global_max;
}

// One level of greedy Graclus matching (normalized-cut gain) over a CSR
// graph. visit_order: n_nodes permutation; weights: per-node degree-ish
// weights; writes cluster ids (0..n_clusters-1) and returns n_clusters.
int64_t graclus_match(const int64_t* indptr, const int64_t* indices,
                      const double* data, const double* weights,
                      const int64_t* visit_order, int64_t n_nodes,
                      int64_t* cluster_id) {
    std::vector<uint8_t> marked(n_nodes, 0);
    int64_t n_clusters = 0;
    for (int64_t t = 0; t < n_nodes; ++t) {
        int64_t u = visit_order[t];
        if (marked[u]) continue;
        marked[u] = 1;
        double best_gain = 0.0;
        int64_t best = -1;
        double wu = weights[u] != 0.0 ? 1.0 / weights[u] : 0.0;
        for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
            int64_t v = indices[e];
            if (marked[v]) continue;
            double wv = weights[v] != 0.0 ? 1.0 / weights[v] : 0.0;
            double gain = data[e] * (wu + wv);
            if (gain > best_gain) {
                best_gain = gain;
                best = v;
            }
        }
        cluster_id[u] = n_clusters;
        if (best >= 0) {
            cluster_id[best] = n_clusters;
            marked[best] = 1;
        }
        ++n_clusters;
    }
    return n_clusters;
}

// Tile a dense row-major N x N matrix into the band slab consumed by
// ops.spmm.band_matmul: out (nb, (2w+1)*bs, bs), given w. Returns the
// minimal block bandwidth of the matrix (so callers can check w).
int64_t band_extract(const float* S, int64_t n, int64_t bs, int64_t w,
                     float* out) {
    int64_t nb = (n + bs - 1) / bs;
    int64_t W = 2 * w + 1;
    std::memset(out, 0, sizeof(float) * nb * W * bs * bs);
    int64_t max_bw = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t bi = i / bs;
        for (int64_t j = 0; j < n; ++j) {
            float v = S[i * n + j];
            if (v == 0.0f) continue;
            int64_t bj = j / bs;
            int64_t d = bi > bj ? bi - bj : bj - bi;
            if (d > max_bw) max_bw = d;
            if (d <= w) {
                // slab row index inside block column bj
                int64_t k = bi - (bj - w);             // 0 .. 2w
                int64_t r = k * bs + (i - bi * bs);
                int64_t c = j - bj * bs;
                out[(bj * W * bs + r) * bs + c] = v;
            }
        }
    }
    return max_bw;
}

// Count nonzero bs x bs tiles of a dense N x N matrix (pass 1 of BCSR).
int64_t bcsr_count(const float* S, int64_t n, int64_t bs) {
    int64_t nb = (n + bs - 1) / bs;
    std::vector<uint8_t> nz(nb * nb, 0);
    for (int64_t i = 0; i < n; ++i)
        for (int64_t j = 0; j < n; ++j)
            if (S[i * n + j] != 0.0f) nz[(i / bs) * nb + (j / bs)] = 1;
    int64_t cnt = 0;
    for (uint8_t b : nz) cnt += b;
    return cnt > 0 ? cnt : 1;
}

// Pass 2: extract nonzero tiles sorted by (col, row); fills
// blocks (nnzb, bs, bs), rows (nnzb,), cols (nnzb,).
void bcsr_extract(const float* S, int64_t n, int64_t bs, float* blocks,
                  int32_t* rows, int32_t* cols) {
    int64_t nb = (n + bs - 1) / bs;
    std::vector<uint8_t> nz(nb * nb, 0);
    for (int64_t i = 0; i < n; ++i)
        for (int64_t j = 0; j < n; ++j)
            if (S[i * n + j] != 0.0f) nz[(i / bs) * nb + (j / bs)] = 1;
    int64_t idx = 0;
    bool any = false;
    for (int64_t bj = 0; bj < nb; ++bj) {
        for (int64_t bi = 0; bi < nb; ++bi) {
            if (!nz[bi * nb + bj]) continue;
            any = true;
            rows[idx] = (int32_t)bi;
            cols[idx] = (int32_t)bj;
            float* dst = blocks + idx * bs * bs;
            for (int64_t r = 0; r < bs; ++r) {
                int64_t i = bi * bs + r;
                for (int64_t c = 0; c < bs; ++c) {
                    int64_t j = bj * bs + c;
                    dst[r * bs + c] =
                        (i < n && j < n) ? S[i * n + j] : 0.0f;
                }
            }
            ++idx;
        }
    }
    if (!any) {  // keep one zero block for static shapes
        rows[0] = 0;
        cols[0] = 0;
        std::memset(blocks, 0, sizeof(float) * bs * bs);
    }
}

}  // extern "C"
