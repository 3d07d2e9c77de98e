// Device-argument preparation for the screening kernel (host fast path).
//
// Fuses the lane-major transposes, reciprocal tables, segment flags,
// block-end annotations and pair-threshold expansion that
// BatchScreener.device_args (scoring/batch_screen.py) otherwise performs
// as ~10 separate numpy passes into one pass over the sub-row arrays.
// Output semantics are bit-identical to the numpy path (parity-tested in
// tests/test_batch_screen.py).
//
// All inputs are host arrays produced by the block packer; P is fixed to
// BLOCK_P == 8 lanes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" int32_t prep_args(
    int64_t ns_real,            // emitted sub rows
    int64_t ns,                 // padded sub rows (power-of-two bucket)
    int64_t nb,                 // blocks
    int64_t np_real,            // pairs
    int32_t P,                  // lanes per sub row (BLOCK_P)
    const float* sub_mu,        // [ns_real, P] row-major
    const float* sub_std,       // [ns_real, P]
    const float* sub_w,         // [ns_real, P]
    const int32_t* sub_block,   // [ns_real] sorted block id per sub row
    const int32_t* block_pair,  // [nb] pair id per block
    const int32_t* block_mn,    // [nb] M*N of the block's candidate pair
    const int32_t* block_cross, // [nb] 1 for cross blocks
    const float* pair_threshold,// [np_real]
    const int32_t* pair_self,   // [np_real] pair_meta[:, 5]
    // outputs (caller-allocated, fully written here)
    float* muT,                 // [P, ns] lane-major
    float* invT,                // [P, ns] 1/std (pad lanes = 1)
    float* winvT,               // [P, ns] w/std (pad lanes = 0)
    uint8_t* flags_block,       // [ns] segment-start flags over blocks
    uint8_t* flags_pair,        // [ns] segment-start flags over pairs
    float* end_mn_inv,          // [ns] 1/max(mn,1) at each block end
    float* end_mn_half,         // [ns] (mn+1)//2 at each block end
    float* end_fail_gate,       // [ns] is_cross at each block end
    float* thr_ns,              // [ns] pair threshold per sub row (pad inf)
    uint8_t* self_ns,           // [ns] pair is_self per sub row (pad true)
    int64_t* out_max)           // [2] longest block span, longest pair span
{
    const float INF = std::numeric_limits<float>::infinity();

    // lane-major transpose + reciprocals (single read pass, strided writes)
    for (int32_t p = 0; p < P; ++p) {
        float* mu_row = muT + (int64_t)p * ns;
        float* inv_row = invT + (int64_t)p * ns;
        float* winv_row = winvT + (int64_t)p * ns;
        for (int64_t i = 0; i < ns_real; ++i) {
            const float m = sub_mu[i * P + p];
            const float s = sub_std[i * P + p];
            const float w = sub_w[i * P + p];
            mu_row[i] = m;
            inv_row[i] = 1.0f / s;
            winv_row[i] = w / s;
        }
        for (int64_t i = ns_real; i < ns; ++i) {
            mu_row[i] = 0.0f;
            inv_row[i] = 1.0f;
            winv_row[i] = 0.0f;
        }
    }

    // per-row expansion: flags, thresholds, self mask + segment counts
    std::vector<int64_t> counts_b((size_t)nb, 0);
    std::vector<int64_t> counts_p((size_t)np_real, 0);
    int32_t prev_block = -1, prev_pair = -1;
    for (int64_t i = 0; i < ns_real; ++i) {
        const int32_t b = sub_block[i];
        const int32_t pr = block_pair[b];
        flags_block[i] = (i == 0) || (b != prev_block);
        flags_pair[i] = (i == 0) || (pr != prev_pair);
        thr_ns[i] = pair_threshold[pr];
        self_ns[i] = pair_self[pr] == 1;
        end_mn_inv[i] = 0.0f;
        end_mn_half[i] = 0.0f;
        end_fail_gate[i] = 0.0f;
        if (b >= 0 && b < nb) counts_b[(size_t)b] += 1;
        if (pr >= 0 && pr < np_real) counts_p[(size_t)pr] += 1;
        prev_block = b;
        prev_pair = pr;
    }
    for (int64_t i = ns_real; i < ns; ++i) {
        flags_block[i] = 1;
        flags_pair[i] = 1;
        thr_ns[i] = INF;
        self_ns[i] = 1;
        end_mn_inv[i] = 0.0f;
        end_mn_half[i] = 0.0f;
        end_fail_gate[i] = 0.0f;
    }

    // block ends: ascending writes (duplicate indices: last write wins, as
    // in numpy fancy assignment) at end = cumsum(counts) - 1
    int64_t cum = 0;
    int64_t max_block = 1;
    for (int64_t b = 0; b < nb; ++b) {
        cum += counts_b[(size_t)b];
        if (counts_b[(size_t)b] > max_block) max_block = counts_b[(size_t)b];
        int64_t end = cum - 1;
        if (end < 0) end += ns;  // numpy negative-index semantics
        // double divide then round, matching numpy's 1.0 / np.maximum(mn, 1)
        end_mn_inv[end] = (float)(1.0 / (double)(block_mn[b] > 1 ? block_mn[b] : 1));
        end_mn_half[end] = (float)((block_mn[b] + 1) / 2);
        end_fail_gate[end] = (float)block_cross[b];
    }
    int64_t max_pair = 1;
    for (int64_t p = 0; p < np_real; ++p)
        if (counts_p[(size_t)p] > max_pair) max_pair = counts_p[(size_t)p];

    out_max[0] = max_block;
    out_max[1] = max_pair;
    return 0;
}

// Geometric feasibility prune per (ligand-cluster, model-cluster) pair:
// True where min over conformers of |d_lig - d_model| - (r1+r2) exceeds the
// model pair's combined size (host_prune_mask in scoring/batch_screen.py;
// reference semantics: graph_match.py:267). Float ops ordered to match the
// numpy float32 path bit-for-bit.
extern "C" void prune_pairs(
    int64_t np_real,
    int64_t cmax,               // conformers per ligand (padded)
    int64_t lmax,               // clusters per ligand (padded)
    const int32_t* pair_meta,   // [np_real, 6] (li, l1, l2, m1, m2, is_self)
    const float* lig_center,    // [B, lmax, cmax, 3]
    const float* lig_size,      // [B, lmax, cmax]
    const float* model_center,  // [M, 3]
    const float* model_size,    // [M]
    uint8_t* pruned)            // [np_real]
{
    for (int64_t p = 0; p < np_real; ++p) {
        const int32_t* m = pair_meta + p * 6;
        const int64_t li = m[0], l1 = m[1], l2 = m[2];
        const int64_t m1 = m[3], m2 = m[4];
        const bool is_self = m[5] == 1;

        const float mdx = model_center[m1 * 3 + 0] - model_center[m2 * 3 + 0];
        const float mdy = model_center[m1 * 3 + 1] - model_center[m2 * 3 + 1];
        const float mdz = model_center[m1 * 3 + 2] - model_center[m2 * 3 + 2];
        const float model_dist = std::sqrt(mdx * mdx + mdy * mdy + mdz * mdz);
        const float model_sz = model_size[m1] + model_size[m2];

        const float* c1 = lig_center + ((li * lmax + l1) * cmax) * 3;
        const float* c2 = lig_center + ((li * lmax + l2) * cmax) * 3;
        const float* s1 = lig_size + (li * lmax + l1) * cmax;
        const float* s2 = lig_size + (li * lmax + l2) * cmax;
        float best = std::numeric_limits<float>::infinity();
        for (int64_t c = 0; c < cmax; ++c) {
            const float dx = c1[c * 3 + 0] - c2[c * 3 + 0];
            const float dy = c1[c * 3 + 1] - c2[c * 3 + 1];
            const float dz = c1[c * 3 + 2] - c2[c * 3 + 2];
            const float d = std::sqrt(dx * dx + dy * dy + dz * dz);
            const float v = std::fabs(d - model_dist) - (s1[c] + s2[c]);
            if (v < best) best = v;
        }
        pruned[p] = (best > model_sz) && !is_self;
    }
}
