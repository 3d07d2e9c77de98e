// Host-side screening block packer.
//
// Emits the flat sub-block/block/pair arrays consumed by the device
// pair-score kernel (pharmaconet_tpu_torch/scoring/batch_screen.py::build_batch)
// at native speed. The Python implementation is the semantic reference and
// the fallback; this translation unit must produce byte-identical arrays
// (tests enforce equality).
//
// Build: g++ -O3 -march=native -shared -fPIC block_packer.cpp -o libblockpacker.so

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int NUM_TYPES = 7;

struct Outputs {
    float* sub_mu;
    float* sub_std;
    float* sub_w;
    int32_t* sub_d;
    int32_t* sub_block;
    int32_t* block_mn;
    int32_t* block_pair;
    int32_t* block_cross;
    float* pair_threshold;
    int32_t* pair_meta;  // [np, 6]
    int64_t cap_ns, cap_nb, cap_np;
    int64_t ns = 0, nb = 0, np = 0;
    int32_t P;
    bool overflow = false;
};

struct ModelTables {
    int32_t M, Mn;
    const int32_t* ct_offsets;  // [M*NUM_TYPES + 1]
    const int32_t* ct_nodes;
    const float* mu;      // [Mn, Mn]
    const float* stdv;    // [Mn, Mn]
    const float* weight;  // [Mn]
};

// matched model nodes for (ligand node typemask, model cluster)
inline void matched_nodes(const ModelTables& m, int32_t mask, int32_t cluster,
                          std::vector<int32_t>& out) {
    out.clear();
    const int32_t base = cluster * NUM_TYPES;
    for (int t = 0; t < NUM_TYPES; ++t) {
        if (mask & (1 << t)) {
            const int32_t lo = m.ct_offsets[base + t];
            const int32_t hi = m.ct_offsets[base + t + 1];
            for (int32_t k = lo; k < hi; ++k) out.push_back(m.ct_nodes[k]);
        }
    }
}

inline bool emit_block(const ModelTables& m, Outputs& o, int32_t d_idx,
                       const std::vector<int32_t>& a_nodes,
                       const std::vector<int32_t>& b_nodes,
                       int32_t pair_id, int32_t cross) {
    const int64_t mn = (int64_t)a_nodes.size() * (int64_t)b_nodes.size();
    if (o.nb >= o.cap_nb) { o.overflow = true; return false; }
    const int32_t block_id = (int32_t)o.nb;
    o.block_mn[o.nb] = (int32_t)mn;
    o.block_pair[o.nb] = pair_id;
    o.block_cross[o.nb] = cross;
    o.nb += 1;

    int64_t k = 0;  // flat (p, q) index within the block
    int64_t row = -1;
    for (int32_t p : a_nodes) {
        const float wp = m.weight[p];
        const float* mu_row = m.mu + (int64_t)p * m.Mn;
        const float* std_row = m.stdv + (int64_t)p * m.Mn;
        for (int32_t q : b_nodes) {
            if (k % o.P == 0) {
                if (o.ns >= o.cap_ns) { o.overflow = true; return false; }
                row = o.ns;
                o.ns += 1;
                float* mu_out = o.sub_mu + row * o.P;
                float* std_out = o.sub_std + row * o.P;
                float* w_out = o.sub_w + row * o.P;
                for (int i = 0; i < o.P; ++i) { mu_out[i] = 0.f; std_out[i] = 1.f; w_out[i] = 0.f; }
                o.sub_d[row] = d_idx;
                o.sub_block[row] = block_id;
            }
            const int64_t slot = row * o.P + (k % o.P);
            o.sub_mu[slot] = mu_row[q];
            o.sub_std[slot] = std_row[q];
            o.sub_w[slot] = wp * m.weight[q];
            ++k;
        }
    }
    return true;
}

}  // namespace

extern "C" int32_t build_blocks(
    // model tables
    int32_t M, int32_t Mn,
    const int32_t* ct_offsets, const int32_t* ct_nodes,
    const float* mu, const float* stdv, const float* weight,
    // ligand batch (flattened)
    int32_t B, int32_t ln,
    const int32_t* lig_cluster_offsets,   // [B+1] -> range of global cluster ids
    const int32_t* cluster_node_offsets,  // [C_total+1]
    const int32_t* cluster_nodes,         // node local ids within ligand
    const int32_t* node_mask_offsets,     // [B+1]
    const int32_t* node_masks,            // per-node typemask
    const int32_t* active_offsets,        // [B+1] -> range in `active`
    const int32_t* active,                // LOCAL cluster index within ligand
    const int32_t* cand_offsets,          // [C_total+1] -> range in `cands`
    const int32_t* cands,                 // model cluster ids
    // outputs
    int32_t P,
    int64_t cap_ns, int64_t cap_nb, int64_t cap_np,
    float* sub_mu, float* sub_std, float* sub_w,
    int32_t* sub_d, int32_t* sub_block,
    int32_t* block_mn, int32_t* block_pair, int32_t* block_cross,
    float* pair_threshold, int32_t* pair_meta,
    int64_t* pair_slices,  // [B*2]
    int64_t* out_counts    // [3]: ns, nb, np
) {
    ModelTables model{M, Mn, ct_offsets, ct_nodes, mu, stdv, weight};
    Outputs o;
    o.sub_mu = sub_mu; o.sub_std = sub_std; o.sub_w = sub_w;
    o.sub_d = sub_d; o.sub_block = sub_block;
    o.block_mn = block_mn; o.block_pair = block_pair; o.block_cross = block_cross;
    o.pair_threshold = pair_threshold; o.pair_meta = pair_meta;
    o.cap_ns = cap_ns; o.cap_nb = cap_nb; o.cap_np = cap_np;
    o.P = P;

    std::vector<int32_t> scratch;
    // per-(cluster-slot, candidate-slot) matched node lists for one ligand
    std::vector<std::vector<std::pair<int32_t, std::vector<int32_t>>>> matched;

    const float INF = std::numeric_limits<float>::infinity();

    for (int32_t li = 0; li < B; ++li) {
        pair_slices[li * 2] = o.np;
        const int32_t clus_base = lig_cluster_offsets[li];
        const int32_t node_base = node_mask_offsets[li];
        const int32_t a_lo = active_offsets[li];
        const int32_t a_hi = active_offsets[li + 1];
        const int32_t n_active = a_hi - a_lo;

        // precompute matched lists: matched[i][j] = (u_local, A(u, cand_j))
        matched.assign((size_t)n_active, {});
        // per active cluster: list over candidates of per-node matches
        // layout: matchlists[i] = vector over (cand slot) of vector of
        // (u, nodes) — flattened below per use
        std::vector<std::vector<std::vector<std::pair<int32_t, std::vector<int32_t>>>>>
            matchlists((size_t)n_active);
        for (int32_t i = 0; i < n_active; ++i) {
            const int32_t l = active[a_lo + i];
            const int32_t gc = clus_base + l;
            const int32_t c_lo = cand_offsets[gc];
            const int32_t c_hi = cand_offsets[gc + 1];
            matchlists[i].resize((size_t)(c_hi - c_lo));
            for (int32_t cj = c_lo; cj < c_hi; ++cj) {
                const int32_t mcluster = cands[cj];
                auto& per_cand = matchlists[i][(size_t)(cj - c_lo)];
                const int32_t n_lo = cluster_node_offsets[gc];
                const int32_t n_hi = cluster_node_offsets[gc + 1];
                for (int32_t nk = n_lo; nk < n_hi; ++nk) {
                    const int32_t u = cluster_nodes[nk];
                    matched_nodes(model, node_masks[node_base + u], mcluster, scratch);
                    if (!scratch.empty()) per_cand.emplace_back(u, scratch);
                }
            }
        }

        // self pairs
        for (int32_t i = 0; i < n_active; ++i) {
            const int32_t l = active[a_lo + i];
            const int32_t gc = clus_base + l;
            const int32_t c_lo = cand_offsets[gc];
            const int32_t c_hi = cand_offsets[gc + 1];
            for (int32_t cj = c_lo; cj < c_hi; ++cj) {
                if (o.np >= o.cap_np) return -1;
                const int32_t pair_id = (int32_t)o.np;
                pair_threshold[o.np] = INF;
                int32_t* meta = pair_meta + o.np * 6;
                meta[0] = li; meta[1] = l; meta[2] = l;
                meta[3] = cands[cj]; meta[4] = cands[cj]; meta[5] = 1;
                o.np += 1;
                const auto& mlist = matchlists[i][(size_t)(cj - c_lo)];
                for (size_t a = 0; a < mlist.size(); ++a) {
                    for (size_t b = a + 1; b < mlist.size(); ++b) {
                        const int32_t u = mlist[a].first, v = mlist[b].first;
                        const int32_t d_idx = li * ln * ln + u * ln + v;
                        if (!emit_block(model, o, d_idx, mlist[a].second,
                                        mlist[b].second, pair_id, 0))
                            return -1;
                    }
                }
            }
        }

        // cross pairs
        for (int32_t i1 = 0; i1 < n_active; ++i1) {
            const int32_t l1 = active[a_lo + i1];
            const int32_t gc1 = clus_base + l1;
            for (int32_t i2 = i1 + 1; i2 < n_active; ++i2) {
                const int32_t l2 = active[a_lo + i2];
                const int32_t gc2 = clus_base + l2;
                const int32_t c1_lo = cand_offsets[gc1], c1_hi = cand_offsets[gc1 + 1];
                const int32_t c2_lo = cand_offsets[gc2], c2_hi = cand_offsets[gc2 + 1];
                for (int32_t cj1 = c1_lo; cj1 < c1_hi; ++cj1) {
                    const auto& mlist1 = matchlists[i1][(size_t)(cj1 - c1_lo)];
                    for (int32_t cj2 = c2_lo; cj2 < c2_hi; ++cj2) {
                        const auto& mlist2 = matchlists[i2][(size_t)(cj2 - c2_lo)];
                        if (o.np >= o.cap_np) return -1;
                        const int32_t pair_id = (int32_t)o.np;
                        pair_threshold[o.np] =
                            0.5f * (float)mlist1.size() * (float)mlist2.size();
                        int32_t* meta = pair_meta + o.np * 6;
                        meta[0] = li; meta[1] = l1; meta[2] = l2;
                        meta[3] = cands[cj1]; meta[4] = cands[cj2]; meta[5] = 0;
                        o.np += 1;
                        for (const auto& mu_ : mlist1) {
                            for (const auto& mv : mlist2) {
                                const int32_t d_idx =
                                    li * ln * ln + mu_.first * ln + mv.first;
                                if (!emit_block(model, o, d_idx, mu_.second,
                                                mv.second, pair_id, 1))
                                    return -1;
                            }
                        }
                    }
                }
            }
        }
        pair_slices[li * 2 + 1] = o.np;
    }

    out_counts[0] = o.ns;
    out_counts[1] = o.nb;
    out_counts[2] = o.np;
    return o.overflow ? -1 : 0;
}
