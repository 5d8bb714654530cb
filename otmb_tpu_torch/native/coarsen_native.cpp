// Native core of the LUMP/SPRAY coarsening: the sequential block-labeling
// loop of utils/coarsen.py (reference semantics: extratools.jl:55-82).
//
// The Python loop walks every grid cell and, at each unassigned in-mask
// cell, splits the (dk x dj x di) block of wet cells into connected
// components of the transport operator's sparsity pattern. At ACCESS-scale
// grids (5.4M cells) the Python version takes minutes; this C++ core with
// a small union-find per block runs in well under a second.
//
// A copy of otmb_tpu/native/coarsen_native.cpp, compiled on demand by
// otmb_tpu_torch/utils/coarsen.py (g++ -O3 -shared -fPIC -std=c++17) into
// otmb_tpu_torch/_build/; the Python labeller there is the semantics
// oracle in tests, never a silent fallback.

#include <cstdint>
#include <vector>

namespace {

// Union-find over at most block_size elements (block_size = di*dj*dk,
// typically 4-27).
struct TinyUF {
    int parent[512];
    void init(int n) {
        for (int i = 0; i < n; ++i) parent[i] = i;
    }
    int find(int a) {
        while (parent[a] != a) {
            parent[a] = parent[parent[a]];
            a = parent[a];
        }
        return a;
    }
    void unite(int a, int b) {
        a = find(a);
        b = find(b);
        if (a != b) parent[b] = a;
    }
};

}  // namespace

extern "C" {

// Returns the number of coarse ids assigned (next_id - 1).
// lump_idx must be zero-initialized, size ez*ey*ex.
int64_t assign_lump_labels(
    int64_t nz, int64_t ny, int64_t nx,
    int64_t dk, int64_t dj, int64_t di,
    const uint8_t* wet_ext,   // (ez, ey, ex) C-order
    const int64_t* lwet_ext,  // (ez, ey, ex) wet index or -1
    const uint8_t* mask,      // (nz, ny, nx)
    const int64_t* indptr,    // CSR over wet cells, symmetrized pattern
    const int64_t* indices,
    int64_t* lump_idx         // (ez, ey, ex), out
) {
    const int64_t ey = ny + dj - 1;
    const int64_t ex = nx + di - 1;

    const int block_size = static_cast<int>(dk * dj * di);
    if (block_size > 512) return -1;

    std::vector<int64_t> cell_lin(block_size);   // extended linear index
    std::vector<int64_t> cell_wet(block_size);   // wet index or -1
    TinyUF uf;

    int64_t next_id = 2;  // 1 is reserved for dry cells

    for (int64_t k = 0; k < nz; ++k) {
        for (int64_t j = 0; j < ny; ++j) {
            for (int64_t i = 0; i < nx; ++i) {
                const int64_t lin = (k * ey + j) * ex + i;
                const int64_t mlin = (k * ny + j) * nx + i;
                const bool in_mask = mask[mlin] != 0;
                if (lump_idx[lin] > 0 && in_mask) continue;
                if (!in_mask) {
                    lump_idx[lin] = next_id++;
                    continue;
                }
                // Gather the block anchored at (k, j, i).
                int nb = 0;
                int n_wet = 0;
                for (int64_t ok = 0; ok < dk; ++ok)
                    for (int64_t oj = 0; oj < dj; ++oj)
                        for (int64_t oi = 0; oi < di; ++oi) {
                            const int64_t l =
                                ((k + ok) * ey + (j + oj)) * ex + (i + oi);
                            cell_lin[nb] = l;
                            cell_wet[nb] = wet_ext[l] ? lwet_ext[l] : -1;
                            if (cell_wet[nb] < 0) {
                                lump_idx[l] = 1;  // dry id
                            } else {
                                ++n_wet;
                            }
                            ++nb;
                        }
                if (n_wet == 0) continue;
                // Union-find over the wet block cells via the pattern.
                uf.init(nb);
                for (int a = 0; a < nb; ++a) {
                    const int64_t wa = cell_wet[a];
                    if (wa < 0) continue;
                    for (int64_t p = indptr[wa]; p < indptr[wa + 1]; ++p) {
                        const int64_t wb = indices[p];
                        for (int b = 0; b < nb; ++b) {
                            if (cell_wet[b] == wb) {
                                uf.unite(a, b);
                                break;
                            }
                        }
                    }
                }
                // Assign one coarse id per component, in first-seen order.
                int64_t comp_id[512];
                for (int a = 0; a < nb; ++a) comp_id[a] = -1;
                for (int a = 0; a < nb; ++a) {
                    if (cell_wet[a] < 0) continue;
                    const int root = uf.find(a);
                    if (comp_id[root] < 0) comp_id[root] = next_id++;
                    lump_idx[cell_lin[a]] = comp_id[root];
                }
            }
        }
    }
    return next_id - 1;
}

}  // extern "C"
