// Native assignment-tree DFS for graph-match screening.
//
// Consumes the device-computed pair-score table and runs the reference's
// cluster-assignment search (pharmaconet_tpu_torch/scoring/tree.py is the semantic
// reference; tests enforce equal scores):
//   * ligand clusters are assigned, in priority order, to one of their
//     candidate model clusters or to None
//   * a candidate survives at a conformer only while every pairwise score
//     against already-assigned ancestors stays > 0
//   * the None branch is taken when no candidate survives or the best
//     completable match count would stay below MIN_MATCHES (5)
//   * final score = mean over conformers of the best leaf total
//
// Table row layout per ligand (produced by both block packers):
//   [self rows:  for l in active: for m in cands[l]]
//   [cross rows: for i1 < i2: for m1 in cands[l_i1]: for m2 in cands[l_i2]]
//
// Candidate state (accumulated cross scores + per-conformer alive masks)
// lives in a preallocated arena indexed by [depth][entry][conformer] —
// the depth slot (level+1) is unique per stack frame, so filtering writes
// never clobber a state another frame still reads. This removes all
// per-node heap allocation from the search.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread match_dfs.cpp -o libmatchdfs.so

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int MIN_MATCHES = 5;

struct LigandCtx {
    const float* table;  // [np_lig, cmax] rows for this ligand
    int64_t cmax;
    int c;               // real conformers
    int n_active;
    const int32_t* cand_counts;         // [n_active]
    std::vector<int64_t> self_offset;   // per active cluster -> first self row
    std::vector<int64_t> entry_offset;  // per active cluster -> first arena slot
    std::vector<std::vector<int64_t>> cross_offset;  // [i1][i2] -> first cross row
    std::vector<float> best;            // [c] running best per conformer

    // state arena: depth in [0, n_active], slot in [0, total_entries)
    int total_entries;
    std::vector<float> accum;    // [depth][slot][c]
    std::vector<uint8_t> alive;  // [depth][slot][c]
    std::vector<uint8_t> any;    // [depth][slot]
    std::vector<float> ps_stack;       // [n_active + 2][c]
    std::vector<uint8_t> psalive_stack;

    inline float* acc(int d, int64_t slot) {
        return accum.data() + ((int64_t)d * total_entries + slot) * c;
    }
    inline uint8_t* alv(int d, int64_t slot) {
        return alive.data() + ((int64_t)d * total_entries + slot) * c;
    }
    inline uint8_t& anyf(int d, int64_t slot) {
        return any[(size_t)((int64_t)d * total_entries + slot)];
    }
};

int dfs(LigandCtx& ctx,
        int level,            // index of the cluster just assigned (-1 at root)
        int chosen_cand,      // candidate index, or -1 for None/root
        bool has_model,       // true if a model cluster was assigned here
        int num_matches,
        const float* ps,            // [c] node conformer totals
        const uint8_t* ps_alive,    // [c]
        int src)                    // arena depth holding deeper-cluster state
{
    const int c = ctx.c;
    int state = src;

    // filter deeper candidates against the newly assigned cluster
    if (has_model) {
        const int dst = level + 1;
        for (int lv = level + 1; lv < ctx.n_active; ++lv) {
            const int64_t base = ctx.entry_offset[(size_t)lv];
            const int64_t cross0 =
                ctx.cross_offset[(size_t)level][(size_t)lv]
                + (int64_t)chosen_cand * ctx.cand_counts[lv];
            for (int j = 0; j < ctx.cand_counts[lv]; ++j) {
                const int64_t slot = base + j;
                if (!ctx.anyf(src, slot)) {
                    ctx.anyf(dst, slot) = 0;
                    continue;
                }
                const float* pair = ctx.table + (cross0 + j) * ctx.cmax;
                const float* sacc = ctx.acc(src, slot);
                const uint8_t* salv = ctx.alv(src, slot);
                float* dacc = ctx.acc(dst, slot);
                uint8_t* dalv = ctx.alv(dst, slot);
                bool any = false;
                for (int ci = 0; ci < c; ++ci) {
                    if (salv[ci] && ps_alive[ci] && pair[ci] > 0.0f) {
                        dacc[ci] = sacc[ci] + pair[ci];
                        dalv[ci] = 1;
                        any = true;
                    } else {
                        dalv[ci] = 0;
                    }
                }
                ctx.anyf(dst, slot) = any;
            }
        }
        state = dst;
    }

    if (level >= ctx.n_active - 1) {
        // leaf: record conformer totals
        for (int ci = 0; ci < c; ++ci) {
            if (ps_alive[ci] && ps[ci] > ctx.best[ci]) ctx.best[ci] = ps[ci];
        }
        return has_model ? 1 : 0;
    }

    const int child = level + 1;
    float* cps = ctx.ps_stack.data() + (size_t)(child + 1) * c;
    uint8_t* cal = ctx.psalive_stack.data() + (size_t)(child + 1) * c;
    const int64_t child_base = ctx.entry_offset[(size_t)child];

    int max_matches = 0;
    bool any_child = false;
    for (int j = 0; j < ctx.cand_counts[child]; ++j) {
        const int64_t slot = child_base + j;
        if (!ctx.anyf(state, slot)) continue;
        any_child = true;
        const float* self_scores =
            ctx.table + (ctx.self_offset[(size_t)child] + j) * ctx.cmax;
        const float* eacc = ctx.acc(state, slot);
        const uint8_t* ealv = ctx.alv(state, slot);
        for (int ci = 0; ci < c; ++ci) {
            if (ealv[ci]) {
                cal[ci] = 1;
                cps[ci] = ps[ci] + self_scores[ci] + eacc[ci];
            } else {
                cal[ci] = 0;
                cps[ci] = 0.0f;
            }
        }
        const int nm = dfs(ctx, child, j, true, num_matches + 1, cps, cal, state);
        if (nm > max_matches) max_matches = nm;
    }
    if (!any_child || num_matches + max_matches < MIN_MATCHES) {
        const int nm = dfs(ctx, child, -1, false, num_matches, ps, ps_alive, state);
        if (nm > max_matches) max_matches = nm;
    }
    return max_matches + (has_model ? 1 : 0);
}

}  // namespace

namespace {

// One worker's sequential sweep over ligands [lo, hi). Each ligand is an
// independent search writing only out_scores[li], so threading is a pure
// range split — scores are bit-identical at any thread count.
void dfs_range(
    int32_t lo, int32_t hi,
    const float* table, int64_t cmax,
    const int64_t* pair_starts, const int32_t* conformers,
    const int32_t* active_offsets, const int32_t* cand_counts,
    float* out_scores
) {
    LigandCtx ctx;  // buffers reused across ligands
    for (int32_t li = lo; li < hi; ++li) {
        const int32_t a_lo = active_offsets[li];
        const int32_t a_hi = active_offsets[li + 1];
        const int n_active = a_hi - a_lo;
        const int c = conformers[li];
        if (n_active == 0 || c == 0) {
            out_scores[li] = 0.0f;
            continue;
        }
        ctx.cmax = cmax;
        ctx.c = c;
        ctx.n_active = n_active;
        ctx.cand_counts = cand_counts + a_lo;
        ctx.table = table + pair_starts[li] * cmax;
        ctx.best.assign((size_t)c, 0.0f);

        // row offsets matching the packer's emission order
        ctx.self_offset.resize((size_t)n_active);
        ctx.entry_offset.resize((size_t)n_active);
        int64_t row = 0;
        int64_t slots = 0;
        for (int l = 0; l < n_active; ++l) {
            ctx.self_offset[(size_t)l] = row;
            ctx.entry_offset[(size_t)l] = slots;
            row += ctx.cand_counts[l];
            slots += ctx.cand_counts[l];
        }
        ctx.cross_offset.assign(
            (size_t)n_active, std::vector<int64_t>((size_t)n_active, -1));
        for (int i1 = 0; i1 < n_active; ++i1) {
            for (int i2 = i1 + 1; i2 < n_active; ++i2) {
                ctx.cross_offset[(size_t)i1][(size_t)i2] = row;
                row += (int64_t)ctx.cand_counts[i1] * ctx.cand_counts[i2];
            }
        }

        // arena: depth 0 holds the root state (zero accum, all alive)
        ctx.total_entries = (int)slots;
        const size_t depths = (size_t)n_active + 1;
        ctx.accum.resize(depths * (size_t)slots * (size_t)c);
        ctx.alive.resize(depths * (size_t)slots * (size_t)c);
        ctx.any.resize(depths * (size_t)slots);
        std::memset(ctx.accum.data(), 0, (size_t)slots * (size_t)c * sizeof(float));
        std::memset(ctx.alive.data(), 1, (size_t)slots * (size_t)c);
        std::memset(ctx.any.data(), 1, (size_t)slots);

        ctx.ps_stack.assign((size_t)(n_active + 2) * (size_t)c, 0.0f);
        ctx.psalive_stack.assign((size_t)(n_active + 2) * (size_t)c, 1);
        dfs(ctx, -1, -1, false, 0,
            ctx.ps_stack.data(), ctx.psalive_stack.data(), 0);

        float total = 0.0f;
        for (int ci = 0; ci < c; ++ci) total += ctx.best[ci];
        out_scores[li] = total / (float)c;
    }
}

}  // namespace

extern "C" void match_dfs_mt(
    int32_t num_ligands,
    const float* table,          // [np_total, cmax]
    int64_t cmax,
    const int64_t* pair_starts,  // [B] first table row per ligand
    const int32_t* conformers,   // [B]
    const int32_t* active_offsets,  // [B+1] into cand_counts
    const int32_t* cand_counts,     // [sum active] candidates per active cluster
    float* out_scores,           // [B]
    int32_t threads
) {
    if (threads < 1) threads = 1;
    if (threads > num_ligands) threads = num_ligands > 0 ? num_ligands : 1;
    if (threads == 1) {
        dfs_range(0, num_ligands, table, cmax, pair_starts, conformers,
                  active_offsets, cand_counts, out_scores);
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve((size_t)threads);
    const int32_t per = (num_ligands + threads - 1) / threads;
    for (int32_t t = 0; t < threads; ++t) {
        const int32_t lo = t * per;
        const int32_t hi = lo + per < num_ligands ? lo + per : num_ligands;
        if (lo >= hi) break;
        pool.emplace_back(dfs_range, lo, hi, table, cmax, pair_starts,
                          conformers, active_offsets, cand_counts, out_scores);
    }
    for (auto& th : pool) th.join();
}

extern "C" void match_dfs(
    int32_t num_ligands,
    const float* table,
    int64_t cmax,
    const int64_t* pair_starts,
    const int32_t* conformers,
    const int32_t* active_offsets,
    const int32_t* cand_counts,
    float* out_scores
) {
    dfs_range(0, num_ligands, table, cmax, pair_starts, conformers,
              active_offsets, cand_counts, out_scores);
}

// ---------------------------------------------------------------------------
// Leaf enumeration: walk the SAME gated tree as dfs() above but emit, for
// every visited leaf, the assignment vector (candidate index per active
// ligand cluster, -1 for None). The visited-leaf SET depends on the table
// only through sign bits (pair > 0) and the match-count gate, so it can be
// baked at prepack time and replayed on-device as a dense masked reduction
// (scoring/leaf_tree.py) — the tree search leaves the screen-time host path
// entirely.
//
// Conformer aliveness is tracked as bitmasks (cmax <= 64), making the walk
// ~10x cheaper than the scoring DFS.
// ---------------------------------------------------------------------------

namespace {

struct LeafCtx {
    int n_active;
    const int32_t* cand_counts;
    std::vector<std::vector<int64_t>> cross_off;     // [i1][i2] ligand-relative
    std::vector<uint64_t> posmask;                   // per ligand row: bit ci = table > 0
    int8_t assign[64];
    // emission
    int8_t* out;
    int32_t lmax;
    int64_t cap;
    int64_t count;  // keeps counting past cap (caller learns the need)
};

int leaf_rec(LeafCtx& ctx, int level, uint64_t alive, int num_matches) {
    if (level >= ctx.n_active) {
        if (ctx.count < ctx.cap) {
            int8_t* row = ctx.out + ctx.count * ctx.lmax;
            std::memset(row, -1, (size_t)ctx.lmax);
            std::memcpy(row, ctx.assign, (size_t)ctx.n_active);
        }
        ++ctx.count;
        return 0;
    }
    int max_matches = 0;
    bool any_child = false;
    for (int j = 0; j < ctx.cand_counts[level]; ++j) {
        uint64_t m = alive;
        for (int k = 0; k < level && m; ++k) {
            const int8_t jk = ctx.assign[k];
            if (jk < 0) continue;
            const int64_t row = ctx.cross_off[(size_t)k][(size_t)level]
                + (int64_t)jk * ctx.cand_counts[level] + j;
            m &= ctx.posmask[(size_t)row];
        }
        if (!m) continue;
        any_child = true;
        ctx.assign[level] = j;
        const int nm = leaf_rec(ctx, level + 1, m, num_matches + 1) + 1;
        if (nm > max_matches) max_matches = nm;
    }
    if (!any_child || num_matches + max_matches < MIN_MATCHES) {
        ctx.assign[level] = -1;
        const int nm = leaf_rec(ctx, level + 1, alive, num_matches);
        if (nm > max_matches) max_matches = nm;
    }
    return max_matches;
}

}  // namespace

// Returns the total leaf count over all ligands (may exceed `capacity`; the
// caller then re-allocates and reruns), or -1 when cmax > 64 / lmax too
// small. assign_out rows are written ligand-major; leaf_offsets[li] is the
// first leaf row of ligand li (always filled, even past capacity).
extern "C" int64_t match_dfs_leaves(
    int32_t num_ligands,
    const float* table,          // [np_total, cmax]
    int64_t cmax,
    const int64_t* pair_starts,  // [B]
    const int32_t* conformers,   // [B]
    const int32_t* active_offsets,  // [B+1]
    const int32_t* cand_counts,     // [sum active]
    int32_t lmax,                // assign_out row stride (>= max n_active)
    int64_t capacity,            // assign_out rows
    int8_t* assign_out,          // [capacity, lmax]
    int64_t* leaf_offsets        // [num_ligands + 1]
) {
    if (cmax > 64) return -1;
    LeafCtx ctx;
    ctx.out = assign_out;
    ctx.lmax = lmax;
    ctx.cap = capacity;
    ctx.count = 0;
    for (int32_t li = 0; li < num_ligands; ++li) {
        leaf_offsets[li] = ctx.count;
        const int32_t a_lo = active_offsets[li];
        const int n = active_offsets[li + 1] - a_lo;
        const int c = conformers[li];
        if (n == 0 || c == 0) continue;
        if (n > lmax || n > 64) return -1;
        ctx.n_active = n;
        ctx.cand_counts = cand_counts + a_lo;

        // ligand-relative row offsets (same emission order as dfs_range)
        int64_t row = 0;
        for (int l = 0; l < n; ++l) row += ctx.cand_counts[l];
        ctx.cross_off.assign((size_t)n, std::vector<int64_t>((size_t)n, -1));
        for (int i1 = 0; i1 < n; ++i1) {
            for (int i2 = i1 + 1; i2 < n; ++i2) {
                ctx.cross_off[(size_t)i1][(size_t)i2] = row;
                row += (int64_t)ctx.cand_counts[i1] * ctx.cand_counts[i2];
            }
        }
        // sign bitmasks over this ligand's table rows
        const float* tl = table + pair_starts[li] * cmax;
        ctx.posmask.resize((size_t)row);
        for (int64_t r = 0; r < row; ++r) {
            uint64_t m = 0;
            for (int ci = 0; ci < c; ++ci) {
                if (tl[r * cmax + ci] > 0.0f) m |= (uint64_t)1 << ci;
            }
            ctx.posmask[(size_t)r] = m;
        }
        const uint64_t all_alive =
            (c >= 64) ? ~(uint64_t)0 : (((uint64_t)1 << c) - 1);
        leaf_rec(ctx, 0, all_alive, 0);
    }
    leaf_offsets[num_ligands] = ctx.count;
    return ctx.count;
}
