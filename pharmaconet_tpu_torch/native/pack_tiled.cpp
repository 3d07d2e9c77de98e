// Fused host pack: ligand batch -> final tiled Pallas screening layout.
//
// Replaces the three-pass host pipeline (block_packer [NS,P] row-major
// emission -> prep_args lane-major transpose -> screen_tiles.py numpy
// scatter) with ONE enumeration pass that writes the device arrays in
// their final tiled form:
//
//   gtab  [T, 3, P, tile] f32   (mu, 1/std, w/std lanes, per tile)
//   aux   [T, 7, tile]    f32   (flags_block, flags_pair, end_mn_inv,
//                                end_mn_half, end_fail_gate, thr, is_self)
//   uv    [T, tile]       i32   (u_slot * cap + v_slot into the tile's
//                                node table; 0 on neutral rows)
//   pos   [T, 3*cmax, cap] f32  (per-tile node position table, slots in
//                                ascending global-node order, unused = 0)
//
// Semantics (block/pair enumeration order, thresholds, reciprocals) are
// identical to block_packer.cpp + prep_args.cpp + screen_tiles.py; tests
// enforce array equality against that reference path. Layout rules match
// scoring/screen_tiles.py: per-ligand node budget (conservative), tiles
// pair-aligned so no scan segment crosses a tile boundary.
//
// Threading: ligands are split into contiguous chunks, one SegBuf per
// thread (each segment starts and ends on a tile boundary, so merged
// segments remain a valid layout); the merge is a handful of memcpys.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread pack_tiled.cpp -o libpacktiled.so

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr int NUM_TYPES = 7;
constexpr float INF = std::numeric_limits<float>::infinity();

// aux row indices
enum { AUX_FB = 0, AUX_FP, AUX_MNINV, AUX_MNHALF, AUX_GATE, AUX_THR, AUX_SELF };

struct ModelTables {
    int32_t M, Mn;
    const int32_t* ct_offsets;  // [M*NUM_TYPES + 1]
    const int32_t* ct_nodes;
    const float* mu;      // [Mn, Mn]
    const float* stdv;    // [Mn, Mn]
    const float* weight;  // [Mn]
    // precomputed once per call (the emit loop otherwise pays a ~14-cycle
    // division per emitted entry — millions per batch):
    //   inv_stdv[p,q]  = 1 / stdv[p,q]
    //   winv_tab[p,q]  = weight[p] * weight[q] / stdv[p,q]
    std::vector<float> inv_stdv, winv_tab;
    void precompute() {
        const size_t n = (size_t)Mn * (size_t)Mn;
        inv_stdv.resize(n);
        winv_tab.resize(n);
        for (int32_t p = 0; p < Mn; ++p) {
            const float wp = weight[p];
            for (int32_t q = 0; q < Mn; ++q) {
                const size_t i = (size_t)p * Mn + q;
                const float inv = 1.0f / stdv[i];
                inv_stdv[i] = inv;
                winv_tab[i] = wp * weight[q] * inv;
            }
        }
    }
};

struct LigandBatch {
    int32_t B, ln, cmax;
    const int32_t* lig_cluster_offsets;
    const int32_t* cluster_node_offsets;
    const int32_t* cluster_nodes;
    const int32_t* node_mask_offsets;
    const int32_t* node_masks;
    const int32_t* active_offsets;
    const int32_t* active;
    const int32_t* cand_offsets;
    const int32_t* cands;
    const float* node_pos;  // [B*ln, cmax*3]
};

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

// One thread's output segment (tile-aligned at both ends). Device-array
// writes go straight into caller-provided memory (the final numpy arrays
// for a single thread / the first thread, malloc'd staging for the rest)
// with a fixed tile capacity — overflow sets rc=-1 and the Python caller
// retries with a bigger allocation.
struct SegBuf {
    int tile = 0, P = 0, cap = 0, threec = 0;
    float* gtab = nullptr;   // [cap_tiles][3][P][tile]
    float* aux = nullptr;    // [cap_tiles][7][tile]
    int32_t* uv = nullptr;   // [cap_tiles][tile]
    float* pos = nullptr;    // [cap_tiles][3c][cap]
    int64_t cap_tiles = 0;
    std::vector<float> pthr;
    std::vector<int32_t> pmeta;       // [np][6]
    std::vector<int64_t> pend;        // [np] segment-local row or -1
    std::vector<int64_t> pslices;     // [ligs][2] segment-local pair ids
    int64_t nst = 0;                  // rows used (tile-aligned when done)
    int64_t maxb = 1, maxp = 1;
    int rc = 0;  // 0 ok, -1 tile overflow, -3 semantic error

    // current-tile scratch: global node id per row side (-1 = neutral)
    std::vector<int32_t> row_u, row_v;
    // row-major staging for the open tile: the device layout wants
    // [3*P][tile] / [7][tile] (per-row writes 4 KB apart — every store a
    // cache miss); rows are emitted contiguously here ([tile][3*P] /
    // [tile][7], 96+28 B per row) and transposed once per tile while the
    // ~100 KB staging block is cache-resident (measured ~2x whole-pack)
    std::vector<float> gstage, astage;
    int64_t tile_base = 0;  // first row of the open tile
    // O(1) per-row node registration: stamp[g] == tile_counter means g is
    // already in the open tile's node list
    std::vector<int32_t> stamp;
    std::vector<int32_t> tile_nodes;
    int32_t tile_counter = 0;

    inline void register_node(int32_t g) {
        if (stamp[(size_t)g] != tile_counter) {
            stamp[(size_t)g] = tile_counter;
            tile_nodes.push_back(g);
        }
    }

    void neutral_row(int64_t row) {
        const int64_t off = row % tile;
        float* g = &gstage[off * (3 * P)];
        for (int p = 0; p < P; ++p) {
            g[p] = 0.f;          // mu
            g[P + p] = 1.f;      // inv
            g[2 * P + p] = 0.f;  // winv
        }
        float* a = &astage[off * 7];
        a[AUX_FB] = 1.f;
        a[AUX_FP] = 1.f;
        a[AUX_MNINV] = 0.f;
        a[AUX_MNHALF] = 0.f;
        a[AUX_GATE] = 0.f;
        a[AUX_THR] = INF;
        a[AUX_SELF] = 1.f;
        row_u[row - tile_base] = -1;
        row_v[row - tile_base] = -1;
    }

    // assign slots (ascending global node id), write uv + pos table
    void close_tile(const LigandBatch& lb) {
        const int64_t t = tile_base / tile;
        const int64_t rows = nst - tile_base;
        // flush staging -> device layout: per output stream j the writes
        // are contiguous (one 4 KB run), reads stride the cache-resident
        // staging block
        {
            const int R = 3 * P;
            float* gt = &gtab[(t * 3 * P) * tile];
            for (int j = 0; j < R; ++j) {
                float* dst = gt + (int64_t)j * tile;
                const float* src = gstage.data() + j;
                for (int64_t r = 0; r < tile; ++r) dst[r] = src[r * R];
            }
            float* at = &aux[(t * 7) * tile];
            for (int j = 0; j < 7; ++j) {
                float* dst = at + (int64_t)j * tile;
                const float* src = astage.data() + j;
                for (int64_t r = 0; r < tile; ++r) dst[r] = src[r * 7];
            }
        }
        std::vector<int32_t>& nodes = tile_nodes;  // registered at emit time
        if ((int)nodes.size() > cap) { rc = -3; return; }
        std::sort(nodes.begin(), nodes.end());
        int32_t* uv_row = &uv[t * tile];
        for (int64_t r = 0; r < rows; ++r) {
            if (row_u[r] < 0) { uv_row[r] = 0; continue; }
            const int32_t su = (int32_t)(std::lower_bound(nodes.begin(), nodes.end(), row_u[r]) - nodes.begin());
            const int32_t sv = (int32_t)(std::lower_bound(nodes.begin(), nodes.end(), row_v[r]) - nodes.begin());
            uv_row[r] = su * cap + sv;
        }
        for (int64_t r = rows; r < tile; ++r) uv_row[r] = 0;
        float* pos_t = &pos[t * threec * cap];
        std::memset(pos_t, 0, sizeof(float) * threec * cap);
        for (size_t s = 0; s < nodes.size(); ++s) {
            const float* src = lb.node_pos + (int64_t)nodes[s] * threec;
            for (int k = 0; k < threec; ++k) pos_t[k * cap + s] = src[k];
        }
        tile_base += tile;
        std::fill(row_u.begin(), row_u.end(), -1);
        std::fill(row_v.begin(), row_v.end(), -1);
        tile_nodes.clear();
        ++tile_counter;
    }

    // pad (neutral rows) to the next tile boundary and close the tile
    void pad_to_boundary(const LigandBatch& lb) {
        const int64_t in_tile = nst % tile;
        if (in_tile == 0) return;
        for (int64_t k = in_tile; k < tile; ++k) neutral_row(tile_base + k);
        nst = tile_base + tile;
        close_tile(lb);
    }
};

// Flat matched-node arena for one ligand (reused across ligands): entry
// e = (ligand node u, matched model nodes nodes[e_lo[e]..e_hi[e]));
// matchlist (active cluster i, candidate j) = entries [ml_lo..ml_hi).
struct MatchArena {
    std::vector<int32_t> nodes;
    std::vector<int32_t> e_u, e_lo, e_hi;
    std::vector<int32_t> ml_lo, ml_hi;
    std::vector<int32_t> ml_base;  // per active cluster: first ml slot
    void clear() {
        nodes.clear(); e_u.clear(); e_lo.clear(); e_hi.clear();
        ml_lo.clear(); ml_hi.clear(); ml_base.clear();
    }
};

void pack_range(const ModelTables& m, const LigandBatch& lb, int P, int tile,
                int cap, int32_t b0, int32_t b1, SegBuf& o) {
    o.row_u.assign(tile, -1);
    o.row_v.assign(tile, -1);
    o.gstage.assign((size_t)tile * (size_t)(3 * P), 0.f);
    o.astage.assign((size_t)tile * 7, 0.f);
    o.stamp.assign((size_t)lb.B * (size_t)lb.ln, -1);
    o.tile_nodes.reserve((size_t)cap + 8);
    MatchArena ma;
    std::vector<char> marked;
    std::vector<int64_t> spans;  // per emitted-order pair
    int64_t nodes_in_tile = 0;

    for (int32_t li = b0; li < b1 && o.rc == 0; ++li) {
        o.pslices.push_back((int64_t)o.pthr.size());
        const int32_t clus_base = lb.lig_cluster_offsets[li];
        const int32_t node_base = lb.node_mask_offsets[li];
        const int32_t a_lo = lb.active_offsets[li];
        const int32_t a_hi = lb.active_offsets[li + 1];
        const int32_t n_active = a_hi - a_lo;

        // matched model-node lists per (active cluster, candidate)
        ma.clear();
        for (int32_t i = 0; i < n_active; ++i) {
            const int32_t l = lb.active[a_lo + i];
            const int32_t gc = clus_base + l;
            const int32_t c_lo = lb.cand_offsets[gc];
            const int32_t c_hi = lb.cand_offsets[gc + 1];
            ma.ml_base.push_back((int32_t)ma.ml_lo.size());
            for (int32_t cj = c_lo; cj < c_hi; ++cj) {
                const int32_t mcluster = lb.cands[cj];
                const int32_t ct_base = mcluster * NUM_TYPES;
                ma.ml_lo.push_back((int32_t)ma.e_u.size());
                const int32_t n_lo = lb.cluster_node_offsets[gc];
                const int32_t n_hi = lb.cluster_node_offsets[gc + 1];
                for (int32_t nk = n_lo; nk < n_hi; ++nk) {
                    const int32_t u = lb.cluster_nodes[nk];
                    const int32_t mask = lb.node_masks[node_base + u];
                    const int32_t lo0 = (int32_t)ma.nodes.size();
                    for (int t = 0; t < NUM_TYPES; ++t) {
                        if (mask & (1 << t)) {
                            const int32_t lo = m.ct_offsets[ct_base + t];
                            const int32_t hi = m.ct_offsets[ct_base + t + 1];
                            for (int32_t k = lo; k < hi; ++k)
                                ma.nodes.push_back(m.ct_nodes[k]);
                        }
                    }
                    if ((int32_t)ma.nodes.size() > lo0) {
                        ma.e_u.push_back(u);
                        ma.e_lo.push_back(lo0);
                        ma.e_hi.push_back((int32_t)ma.nodes.size());
                    }
                }
                ma.ml_hi.push_back((int32_t)ma.e_u.size());
            }
        }

        auto ml_at = [&](int32_t i, int32_t cj_rel) {
            const int32_t mi = ma.ml_base[(size_t)i] + cj_rel;
            return std::pair<int32_t, int32_t>(ma.ml_lo[(size_t)mi], ma.ml_hi[(size_t)mi]);
        };
        auto block_rows = [P](int64_t a, int64_t b) {
            return (a * b + P - 1) / P;
        };
        auto e_n = [&](int32_t e) {
            return (int64_t)(ma.e_hi[(size_t)e] - ma.e_lo[(size_t)e]);
        };

        // pass 1 (pair order = emission order): pair tables, spans, marks
        marked.assign((size_t)lb.ln, 0);
        spans.clear();
        int64_t lig_rows = 0;
        for (int32_t i = 0; i < n_active; ++i) {
            const int32_t l = lb.active[a_lo + i];
            const int32_t gc = clus_base + l;
            const int32_t c_lo = lb.cand_offsets[gc];
            for (int32_t cj = c_lo; cj < lb.cand_offsets[gc + 1]; ++cj) {
                auto [e0, e1] = ml_at(i, cj - c_lo);
                int64_t span = 0;
                if (e1 - e0 >= 2) {
                    for (int32_t a = e0; a < e1; ++a) {
                        marked[(size_t)ma.e_u[(size_t)a]] = 1;
                        for (int32_t b = a + 1; b < e1; ++b)
                            span += block_rows(e_n(a), e_n(b));
                    }
                }
                o.pthr.push_back(INF);
                o.pmeta.insert(o.pmeta.end(), {li, l, l, lb.cands[cj], lb.cands[cj], 1});
                spans.push_back(span);
                lig_rows += span;
            }
        }
        for (int32_t i1 = 0; i1 < n_active; ++i1) {
            const int32_t l1 = lb.active[a_lo + i1];
            const int32_t gc1 = clus_base + l1;
            const int32_t c1_lo = lb.cand_offsets[gc1];
            for (int32_t i2 = i1 + 1; i2 < n_active; ++i2) {
                const int32_t l2 = lb.active[a_lo + i2];
                const int32_t gc2 = clus_base + l2;
                const int32_t c2_lo = lb.cand_offsets[gc2];
                for (int32_t cj1 = c1_lo; cj1 < lb.cand_offsets[gc1 + 1]; ++cj1) {
                    auto [a0, a1] = ml_at(i1, cj1 - c1_lo);
                    for (int32_t cj2 = c2_lo; cj2 < lb.cand_offsets[gc2 + 1]; ++cj2) {
                        auto [b0e, b1e] = ml_at(i2, cj2 - c2_lo);
                        int64_t span = 0;
                        if (a1 > a0 && b1e > b0e) {
                            for (int32_t a = a0; a < a1; ++a) {
                                marked[(size_t)ma.e_u[(size_t)a]] = 1;
                                for (int32_t b = b0e; b < b1e; ++b)
                                    span += block_rows(e_n(a), e_n(b));
                            }
                            for (int32_t b = b0e; b < b1e; ++b)
                                marked[(size_t)ma.e_u[(size_t)b]] = 1;
                        }
                        o.pthr.push_back(
                            0.5f * (float)(a1 - a0) * (float)(b1e - b0e));
                        o.pmeta.insert(o.pmeta.end(), {li, l1, l2, lb.cands[cj1], lb.cands[cj2], 0});
                        spans.push_back(span);
                        lig_rows += span;
                    }
                }
            }
        }

        if (lig_rows == 0) {
            for (size_t k = 0; k < spans.size(); ++k) o.pend.push_back(-1);
            o.pslices.push_back((int64_t)o.pthr.size());
            continue;
        }

        int64_t n_ref = 0;
        for (char c : marked) n_ref += c;
        if (n_ref > cap) { o.rc = -3; break; }
        // per-ligand node budget (conservative: full referenced set)
        const int64_t in_tile = o.nst % tile;
        if (in_tile && nodes_in_tile + n_ref > cap) {
            o.pad_to_boundary(lb);
            nodes_in_tile = 0;
        }
        const int64_t start = o.nst;

        // pass 2: emit rows, pair-aligned (spans precomputed)
        size_t span_idx = 0;
        auto emit_block = [&](int32_t ea, int32_t eb, bool& first_row_of_pair,
                              float thr, float selff, float gate) {
            const int32_t u = ma.e_u[(size_t)ea], v = ma.e_u[(size_t)eb];
            const int64_t mn = e_n(ea) * e_n(eb);
            const int64_t rows = (mn + P - 1) / P;
            o.maxb = std::max(o.maxb, rows);
            const int32_t g_u = li * lb.ln + u;
            const int32_t g_v = li * lb.ln + v;
            int64_t k = 0, row = -1;
            float* grow = nullptr;
            float* arow = nullptr;
            for (int32_t ai = ma.e_lo[(size_t)ea]; ai < ma.e_hi[(size_t)ea]; ++ai) {
                const int32_t pn = ma.nodes[(size_t)ai];
                const float* mu_row = m.mu + (int64_t)pn * m.Mn;
                const float* inv_row = m.inv_stdv.data() + (int64_t)pn * m.Mn;
                const float* winv_row = m.winv_tab.data() + (int64_t)pn * m.Mn;
                for (int32_t bi = ma.e_lo[(size_t)eb]; bi < ma.e_hi[(size_t)eb]; ++bi) {
                    const int32_t qn = ma.nodes[(size_t)bi];
                    const int lane = (int)(k % P);
                    if (lane == 0) {
                        row = o.nst++;
                        const int64_t off = row % tile;
                        grow = &o.gstage[off * (3 * P)];
                        arow = &o.astage[off * 7];
                        for (int p = 0; p < P; ++p) {
                            grow[p] = 0.f;
                            grow[P + p] = 1.f;
                            grow[2 * P + p] = 0.f;
                        }
                        arow[AUX_FB] = (k == 0) ? 1.f : 0.f;
                        arow[AUX_FP] = first_row_of_pair ? 1.f : 0.f;
                        first_row_of_pair = false;
                        arow[AUX_MNINV] = 0.f;
                        arow[AUX_MNHALF] = 0.f;
                        arow[AUX_GATE] = 0.f;
                        arow[AUX_THR] = thr;
                        arow[AUX_SELF] = selff;
                        o.row_u[row - o.tile_base] = g_u;
                        o.row_v[row - o.tile_base] = g_v;
                        o.register_node(g_u);
                        o.register_node(g_v);
                    }
                    grow[lane] = mu_row[qn];
                    grow[P + lane] = inv_row[qn];
                    grow[2 * P + lane] = winv_row[qn];
                    ++k;
                }
            }
            arow[AUX_MNINV] = 1.0f / (float)std::max<int64_t>(mn, 1);
            arow[AUX_MNHALF] = (float)((mn + 1) / 2);
            arow[AUX_GATE] = gate;
            if (o.nst % tile == 0) o.close_tile(lb);
        };

        auto begin_pair = [&](int64_t span) -> bool {
            // pair-align: returns false for empty pairs
            if (span == 0) { o.pend.push_back(-1); return false; }
            if (span > tile) { o.rc = -3; return false; }
            int64_t start_at = o.nst;
            if ((o.nst % tile) + span > tile)
                start_at = (o.nst / tile + 1) * tile;
            if (start_at + span > o.cap_tiles * tile) { o.rc = -1; return false; }
            if (start_at != o.nst) o.pad_to_boundary(lb);
            return o.rc == 0;
        };

        for (int32_t i = 0; i < n_active && o.rc == 0; ++i) {
            const int32_t l = lb.active[a_lo + i];
            const int32_t gc = clus_base + l;
            const int32_t c_lo = lb.cand_offsets[gc];
            for (int32_t cj = c_lo; cj < lb.cand_offsets[gc + 1] && o.rc == 0; ++cj) {
                const int64_t span = spans[span_idx++];
                if (!begin_pair(span)) continue;
                auto [e0, e1] = ml_at(i, cj - c_lo);
                const int64_t pair_start = o.nst;
                bool first = true;
                for (int32_t a = e0; a < e1; ++a)
                    for (int32_t b = a + 1; b < e1; ++b)
                        emit_block(a, b, first, INF, 1.f, 0.f);
                o.maxp = std::max(o.maxp, o.nst - pair_start);
                o.pend.push_back(o.nst - 1);
            }
        }
        for (int32_t i1 = 0; i1 < n_active && o.rc == 0; ++i1) {
            const int32_t l1 = lb.active[a_lo + i1];
            const int32_t gc1 = clus_base + l1;
            const int32_t c1_lo = lb.cand_offsets[gc1];
            for (int32_t i2 = i1 + 1; i2 < n_active && o.rc == 0; ++i2) {
                const int32_t l2 = lb.active[a_lo + i2];
                const int32_t gc2 = clus_base + l2;
                const int32_t c2_lo = lb.cand_offsets[gc2];
                for (int32_t cj1 = c1_lo; cj1 < lb.cand_offsets[gc1 + 1] && o.rc == 0; ++cj1) {
                    auto [a0, a1] = ml_at(i1, cj1 - c1_lo);
                    for (int32_t cj2 = c2_lo; cj2 < lb.cand_offsets[gc2 + 1] && o.rc == 0; ++cj2) {
                        const int64_t span = spans[span_idx++];
                        if (!begin_pair(span)) continue;
                        auto [b0e, b1e] = ml_at(i2, cj2 - c2_lo);
                        const float thr = 0.5f * (float)(a1 - a0) * (float)(b1e - b0e);
                        const int64_t pair_start = o.nst;
                        bool first = true;
                        for (int32_t a = a0; a < a1; ++a)
                            for (int32_t b = b0e; b < b1e; ++b)
                                emit_block(a, b, first, thr, 0.f, 1.f);
                        o.maxp = std::max(o.maxp, o.nst - pair_start);
                        o.pend.push_back(o.nst - 1);
                    }
                }
            }
        }
        o.pslices.push_back((int64_t)o.pthr.size());

        // node-budget accounting (mirrors screen_tiles.py exactly)
        if (o.nst % tile == 0) nodes_in_tile = 0;
        else if (o.nst / tile != start / tile) nodes_in_tile = n_ref;
        else nodes_in_tile += n_ref;
    }
    if (o.rc == 0) o.pad_to_boundary(lb);  // segment ends tile-aligned
}

}  // namespace

extern "C" int32_t pack_tiled(
    // model tables
    int32_t M, int32_t Mn,
    const int32_t* ct_offsets, const int32_t* ct_nodes,
    const float* mu, const float* stdv, const float* weight,
    // ligand batch (flattened, same as build_blocks) + positions
    int32_t B, int32_t ln, int32_t cmax,
    const int32_t* lig_cluster_offsets,
    const int32_t* cluster_node_offsets,
    const int32_t* cluster_nodes,
    const int32_t* node_mask_offsets,
    const int32_t* node_masks,
    const int32_t* active_offsets,
    const int32_t* active,
    const int32_t* cand_offsets,
    const int32_t* cands,
    const float* node_pos,  // [B*ln, cmax*3]
    // layout params
    int32_t P, int32_t tile, int32_t cap, int32_t threads,
    int64_t t_alloc, int64_t cap_np,
    // outputs
    float* gtab,            // [t_alloc, 3, P, tile]
    float* aux,             // [t_alloc, 7, tile]
    int32_t* uv,            // [t_alloc, tile]
    float* pos_blocks,      // [t_alloc, 3*cmax, cap]
    float* pair_threshold,  // [cap_np]
    int32_t* pair_meta,     // [cap_np, 6]
    int64_t* pair_end_rows, // [cap_np]
    int64_t* pair_slices,   // [B, 2]
    int64_t* out            // [4]: nst, np, max_block, max_pair
) {
    ModelTables model{M, Mn, ct_offsets, ct_nodes, mu, stdv, weight};
    model.precompute();
    LigandBatch lb{B, ln, cmax, lig_cluster_offsets, cluster_node_offsets,
                   cluster_nodes, node_mask_offsets, node_masks,
                   active_offsets, active, cand_offsets, cands, node_pos};
    const int threec = 3 * cmax;

    const int nthreads = std::max(1, std::min<int>(threads, B));
    std::vector<SegBuf> segs((size_t)nthreads);
    std::vector<float*> staging;  // malloc'd buffers for threads > 0
    std::vector<std::thread> pool;
    const int32_t chunk = (B + nthreads - 1) / nthreads;
    // staging capacity per extra thread: generous share of the total
    const int64_t cap_per =
        nthreads == 1 ? t_alloc
                      : std::min<int64_t>(t_alloc, 2 * (t_alloc / nthreads) + 64);
    for (int t = 0; t < nthreads; ++t) {
        SegBuf& s = segs[(size_t)t];
        s.tile = tile; s.P = P; s.cap = cap; s.threec = threec;
        if (t == 0) {
            // first segment starts at offset 0: write the finals directly
            s.gtab = gtab; s.aux = aux; s.uv = uv; s.pos = pos_blocks;
            s.cap_tiles = nthreads == 1 ? t_alloc : cap_per;
        } else {
            float* g = (float*)std::malloc(sizeof(float) * cap_per * 3 * P * tile);
            float* a = (float*)std::malloc(sizeof(float) * cap_per * 7 * tile);
            int32_t* u = (int32_t*)std::malloc(sizeof(int32_t) * cap_per * tile);
            float* p = (float*)std::malloc(sizeof(float) * cap_per * threec * cap);
            staging.insert(staging.end(), {g, a, (float*)u, p});
            s.gtab = g; s.aux = a; s.uv = u; s.pos = p;
            if (!(g && a && u && p)) {
                // allocation failure must NOT look like tile overflow
                // (rc=-1 makes the caller retry with BIGGER buffers)
                for (float* q : staging) std::free(q);
                return -4;
            }
            s.cap_tiles = cap_per;
        }
    }
    for (int t = 0; t < nthreads; ++t) {
        const int32_t lo = t * chunk, hi = std::min(B, (t + 1) * chunk);
        if (lo >= hi) continue;
        if (nthreads == 1)
            pack_range(model, lb, P, tile, cap, lo, hi, segs[(size_t)t]);
        else
            pool.emplace_back(pack_range, std::cref(model), std::cref(lb),
                              P, tile, cap, lo, hi, std::ref(segs[(size_t)t]));
    }
    for (auto& th : pool) th.join();

    auto cleanup = [&]() { for (float* p : staging) std::free(p); };

    int64_t nst = 0, np = 0, maxb = 1, maxp = 1;
    int rc = 0;
    for (auto& s : segs) {
        if (s.rc != 0 && rc == 0) rc = s.rc;
        nst += s.nst;
        np += (int64_t)s.pthr.size();
        maxb = std::max(maxb, s.maxb);
        maxp = std::max(maxp, s.maxp);
    }
    out[0] = nst; out[1] = np; out[2] = maxb; out[3] = maxp;
    if (rc == -1 || nst > t_alloc * tile) {
        // tile overflow: out[0] is a lower bound; the caller regrows
        out[0] = std::max(nst, t_alloc * tile + 1);
        cleanup();
        return -1;
    }
    if (rc != 0) { cleanup(); return rc; }
    if (np > cap_np) { cleanup(); return -2; }

    // merge segments (contiguous memcpys; tile-aligned by construction)
    int64_t row_off = 0, np_off = 0, lig_off = 0;
    for (size_t si = 0; si < segs.size(); ++si) {
        SegBuf& s = segs[si];
        const int64_t t0 = row_off / tile, ts = s.nst / tile;
        if (ts && si > 0) {  // segment 0 already lives in the finals
            std::memcpy(gtab + t0 * 3 * P * tile, s.gtab,
                        sizeof(float) * ts * 3 * P * tile);
            std::memcpy(aux + t0 * 7 * tile, s.aux,
                        sizeof(float) * ts * 7 * tile);
            std::memcpy(uv + t0 * tile, s.uv, sizeof(int32_t) * ts * tile);
            std::memcpy(pos_blocks + t0 * threec * cap, s.pos,
                        sizeof(float) * ts * threec * cap);
        }
        const int64_t sp = (int64_t)s.pthr.size();
        if (sp) {
            std::memcpy(pair_threshold + np_off, s.pthr.data(), sizeof(float) * sp);
            std::memcpy(pair_meta + np_off * 6, s.pmeta.data(), sizeof(int32_t) * sp * 6);
            for (int64_t i = 0; i < sp; ++i)
                pair_end_rows[np_off + i] =
                    s.pend[(size_t)i] < 0 ? -1 : s.pend[(size_t)i] + row_off;
        }
        const int64_t nl = (int64_t)s.pslices.size() / 2;
        for (int64_t i = 0; i < nl; ++i) {
            pair_slices[(lig_off + i) * 2] = s.pslices[(size_t)(i * 2)] + np_off;
            pair_slices[(lig_off + i) * 2 + 1] = s.pslices[(size_t)(i * 2 + 1)] + np_off;
        }
        row_off += s.nst; np_off += sp; lig_off += nl;
    }
    cleanup();

    // neutral-fill the remaining allocated tiles (bucket padding)
    for (int64_t t = nst / tile; t < t_alloc; ++t) {
        float* g = gtab + t * 3 * P * tile;
        for (int64_t i = 0; i < (int64_t)P * tile; ++i) g[i] = 0.f;            // mu
        for (int64_t i = 0; i < (int64_t)P * tile; ++i) g[P * tile + i] = 1.f; // inv
        std::memset(g + 2 * P * tile, 0, sizeof(float) * P * tile);            // winv
        float* a = aux + t * 7 * tile;
        for (int64_t i = 0; i < tile; ++i) a[AUX_FB * tile + i] = 1.f;
        for (int64_t i = 0; i < tile; ++i) a[AUX_FP * tile + i] = 1.f;
        std::memset(a + AUX_MNINV * tile, 0, sizeof(float) * tile * 3);
        for (int64_t i = 0; i < tile; ++i) a[AUX_THR * tile + i] = INF;
        for (int64_t i = 0; i < tile; ++i) a[AUX_SELF * tile + i] = 1.f;
        std::memset(uv + t * tile, 0, sizeof(int32_t) * tile);
        std::memset(pos_blocks + t * threec * cap, 0, sizeof(float) * threec * cap);
    }
    return 0;
}
