// Screening kernels for Hopper (sm_90a): K1-K5.
//
// Replace the Pallas TPU kernels of pharmaconet_tpu/ops/screen_pallas.py:
//   K1 screen_tiles_fused    <- score_tiles_fused (_fused_kernel_v2), rows
//                               form of score_tiles_fused_rows: tile-major
//                               gtab/aux, distances rebuilt per tile
//   K2 screen_tiles_v3       <- score_tiles_v3 (_v3_kernel), rows form of
//                               score_tiles_v3_rows: v3 block-major layout
//   K3 screen_tiles_fused_dt <- score_tiles_fused_dt (_fused_kernel_dt):
//                               K1 with the distances read from the store
//   K4 screen_blocks_fused   <- score_blocks_pallas_fused (_fused_kernel):
//                               K1's arithmetic over the row layout
//   K5 screen_gauss_phase    <- gaussian_phase_pallas (_gauss_kernel): the
//                               Gaussian phase alone (scans stay in torch)
//
// K1, K3, K4 and K5 are one template (screen_tile_kernel<C, MODE>) over
// pointer strides. What it computes, per 1024-row tile (one thread block,
// one thread per row; scan segments never cross a tile because the layout
// is pair-aligned):
//   1. the conformer distance d of the row: K3 loads it from the store's
//      dt [T, C, 1024]; the others compute sqrt((dx²+dy²)+dz²) between the
//      row's two ligand nodes, read from the tile's [3C, 64] node table in
//      shared memory (an indexed load; the TPU kernel selected with a
//      one-hot matmul because Mosaic has no gather);
//   2. over the P = 8 model pairs: x = (d-μ)·inv, term = winv·exp(-x²/2)
//      and pass = x² < 4 where winv > 0, summed over P;
//   3. (K1, K3, K4) a bounded segmented Hillis-Steele scan sub-row -> block
//      (depth1), block score ·1/(MN), block fail where passes < (MN+1)/2 on
//      cross pairs, a second scan block -> pair (depth2), and -1 where
//      fails > threshold on a non-self pair.
//
// K2 (v3_tile_kernel<C>) is the same arithmetic on the v3 layout: one row
// per ligand-node-pair block, the model-node-pair axis (mn_cap entries)
// inside the row. The tile's [g_cap, r_pad] group table sits in shared
// memory and each row reads its group's (μ, 1/std, w2, mnhalf) by its gid,
// an indexed load where the TPU kernel ran a one-hot MXU select. The block
// fail is set in-row, and ONE pair-level scan of [score; block_fail]
// follows.
//
// Bound on this card: bytes. Per tile K1 streams ~147 KiB (gtab 96 KiB,
// aux 28 KiB, uv 4 KiB, the node table and the output), K3 ~160 KiB (dt
// in place of uv and the node table), K2 ~44 KiB (dt, gid, an 8 KiB table,
// aux 12 KiB, the output), each against a few hundred f32 operations per
// row, far below the H100's operations-per-byte balance. The design keeps
// every intermediate (distances, the stacked scores/passes, the scans) in
// registers and shared memory, so HBM sees each input once and the output
// once. Not yet done: TMA/cp.async prefetch of the next tile and more than
// one tile in flight per SM.
//
// Discrete decisions (x² < 4, passes < (MN+1)/2, fails > thr) must match
// the reference bit for bit, so the file is built without fast math and
// with -fmad=false, and the distance and x use explicitly rounded
// operations in the reference's order. Only expf differs by ulps; it feeds
// continuous scores only.
//
// Build (plain C interface, bound with ctypes by ops/screen_cuda.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libscreen_fused.so screen_fused.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;  // rows per tile (scoring/screen_tiles.py TILE)
constexpr int CAP = 64;     // node slots per tile (NODE_CAP)
constexpr int P = 8;        // model pairs per row (BLOCK_P)
constexpr int MAX_C = 8;    // conformers supported (template instances)
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may opt into

enum Mode { GAUSS = 0, FUSED = 1, FUSED_DT = 2 };

struct TileArgs {
    const float* pos;    // [T, 3C, CAP]           (GAUSS, FUSED)
    const int32_t* uv;   // [T * TILE] u_slot * CAP + v_slot
    const float* dt;     // [T, C, TILE] distances (FUSED_DT)
    // Gaussian tables: element (t, p, r) at base + t*g_tstride + p*g_pstride + r
    const float* mu;
    const float* inv;
    const float* winv;
    long long g_tstride, g_pstride;
    // flags_block, flags_pair, end_mn_inv, end_mn_half, end_fail_gate,
    // thr, is_self: element (t, r) of row j at aux[j] + t*a_tstride + r
    const float* aux[7];
    long long a_tstride;
    // output (c, global row) at out + row*o_rstride + c*o_cstride
    float* out;
    long long o_rstride, o_cstride;
    int depth1, depth2;
};

// Conformer distances of one row from the tile's node table.
template <int C>
__device__ __forceinline__ void row_distances(const float* pos_s, int32_t uvp,
                                              float (&d)[C]) {
    const int u = uvp / CAP, w = uvp % CAP;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float dx = __fsub_rn(pos_s[(3 * c + 0) * CAP + u], pos_s[(3 * c + 0) * CAP + w]);
        const float dy = __fsub_rn(pos_s[(3 * c + 1) * CAP + u], pos_s[(3 * c + 1) * CAP + w]);
        const float dz = __fsub_rn(pos_s[(3 * c + 2) * CAP + u], pos_s[(3 * c + 2) * CAP + w]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        d[c] = __fsqrt_rn(d2);
    }
}

// One Gaussian entry (μ, inv, weight) added to the row's stacked sums:
// v[0, C) scores, v[C, 2C) pass counts.
template <int C>
__device__ __forceinline__ void gauss_entry(const float (&d)[C], float m, float iv,
                                            float wt, float (&v)[2 * C]) {
    const bool valid = wt > 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float x = __fmul_rn(__fsub_rn(d[c], m), iv);
        const float x2 = __fmul_rn(x, x);
        const float term = valid ? __fmul_rn(wt, expf(__fmul_rn(-0.5f, x2))) : 0.f;
        v[c] = __fadd_rn(v[c], term);
        v[C + c] = __fadd_rn(v[C + c], (valid && x2 < 4.f) ? 1.f : 0.f);
    }
}

// Bounded segmented inclusive scan across the block's 1024 rows (thread r
// holds row r): `seen` is 1 at a segment start; lanes below the shift act
// as starts. Same recurrence and addition order as the reference
// (val += val[r - shift] where the row has not yet seen its start).
template <int R>
__device__ __forceinline__ void scan_bounded(float (&v)[R], float seen, int depth,
                                             float* buf, float* seen_buf, int r) {
    int shift = 1;
    for (int k = 0; k < depth && shift < TILE; ++k, shift <<= 1) {
#pragma unroll
        for (int j = 0; j < R; ++j) buf[j * TILE + r] = v[j];
        seen_buf[r] = seen;
        __syncthreads();
        if (r >= shift) {
            const float prev_seen = seen_buf[r - shift];
            if (seen == 0.f) {
#pragma unroll
                for (int j = 0; j < R; ++j) v[j] = __fadd_rn(v[j], buf[j * TILE + r - shift]);
            }
            seen = fmaxf(seen, prev_seen);
        } else {
            seen = 1.f;
        }
        __syncthreads();
    }
}

template <int C, int MODE>
__global__ void __launch_bounds__(TILE) screen_tile_kernel(TileArgs a) {
    extern __shared__ float smem[];
    constexpr int POS = MODE == FUSED_DT ? 0 : 3 * C * CAP;
    float* pos_s = smem;                     // [POS]
    float* buf = smem + POS;                 // [2C * TILE]  (FUSED, FUSED_DT)
    float* seen_buf = buf + 2 * C * TILE;    // [TILE]       (FUSED, FUSED_DT)

    const int t = blockIdx.x;
    const int r = threadIdx.x;
    const long long row = (long long)t * TILE + r;
    float d[C];
    if constexpr (MODE == FUSED_DT) {
        const float* dt_t = a.dt + (long long)t * C * TILE + r;
#pragma unroll
        for (int c = 0; c < C; ++c) d[c] = dt_t[c * TILE];
    } else {
        const float* pos_t = a.pos + (long long)t * 3 * C * CAP;
        for (int i = r; i < POS; i += TILE) pos_s[i] = pos_t[i];
        __syncthreads();
        row_distances<C>(pos_s, a.uv[row], d);
    }

    const long long g = (long long)t * a.g_tstride + r;
    float v[2 * C];
#pragma unroll
    for (int j = 0; j < 2 * C; ++j) v[j] = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const long long gp = g + p * a.g_pstride;
        gauss_entry<C>(d, a.mu[gp], a.inv[gp], a.winv[gp], v);
    }

    float* out = a.out + row * a.o_rstride;
    if constexpr (MODE == GAUSS) {
#pragma unroll
        for (int j = 0; j < 2 * C; ++j) out[j * a.o_cstride] = v[j];
        return;
    }

    const long long ai = (long long)t * a.a_tstride + r;
    const float fb = a.aux[0][ai], fp = a.aux[1][ai];
    const float mninv = a.aux[2][ai], mnhalf = a.aux[3][ai], gate = a.aux[4][ai];
    const float thr = a.aux[5][ai], selff = a.aux[6][ai];

    // sub -> block: scores and pass counts scan together
    scan_bounded<2 * C>(v, fb, a.depth1, buf, seen_buf, r);
#pragma unroll
    for (int c = 0; c < C; ++c) {
        v[c] = __fmul_rn(v[c], mninv);                 // block score
        v[C + c] = (v[C + c] < mnhalf) ? gate : 0.f;   // block fail
    }
    // block -> pair: [block_score; block_fail] scan together
    scan_bounded<2 * C>(v, fp, a.depth2, buf, seen_buf, r);
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const bool failed = v[C + c] > thr && selff == 0.f;
        out[c * a.o_cstride] = failed ? -1.f : v[c];
    }
}

struct V3Args {
    const float* dt;      // [T, C, TILE]
    const int32_t* gid;   // [T, TILE] group slot of the row
    const float* tab;     // [T, g_cap, r_pad] group tables
    const float* aux;     // [T, 3, TILE] pair-start flag, thr, is_self
    float* out;           // [T * TILE, C]
    int g_cap, r_pad, mn_cap, depth;
};

// K2: the v3 block-major kernel (see the file header).
template <int C>
__global__ void __launch_bounds__(TILE) v3_tile_kernel(V3Args a) {
    extern __shared__ float smem[];
    const int tab_n = a.g_cap * a.r_pad;
    float* tab_s = smem;                     // [g_cap * r_pad]
    float* buf = smem + tab_n;               // [2C * TILE]
    float* seen_buf = buf + 2 * C * TILE;    // [TILE]

    const int t = blockIdx.x;
    const int r = threadIdx.x;
    const float* tab_t = a.tab + (long long)t * tab_n;
    for (int i = r; i < tab_n; i += TILE) tab_s[i] = tab_t[i];
    __syncthreads();

    const long long row = (long long)t * TILE + r;
    float d[C];
    const float* dt_t = a.dt + (long long)t * C * TILE + r;
#pragma unroll
    for (int c = 0; c < C; ++c) d[c] = dt_t[c * TILE];

    float v[2 * C];
#pragma unroll
    for (int j = 0; j < 2 * C; ++j) v[j] = 0.f;
    // a slot outside the table selects nothing (the one-hot select's zero
    // row): no terms, no passes, mnhalf 0
    const int gi = a.gid[row];
    float mnhalf = 0.f;
    if (gi >= 0 && gi < a.g_cap) {
        const float* grp = tab_s + gi * a.r_pad;
        for (int k = 0; k < a.mn_cap; ++k)
            gauss_entry<C>(d, grp[k], grp[a.mn_cap + k], grp[2 * a.mn_cap + k], v);
        mnhalf = grp[3 * a.mn_cap];
    }

    const float* aux_t = a.aux + (long long)t * 3 * TILE + r;
    const float fp = aux_t[0], thr = aux_t[TILE], selff = aux_t[2 * TILE];
    const float gate = __fsub_rn(1.f, selff);  // fails count on cross pairs only
#pragma unroll
    for (int c = 0; c < C; ++c) v[C + c] = (v[C + c] < mnhalf) ? gate : 0.f;
    scan_bounded<2 * C>(v, fp, a.depth, buf, seen_buf, r);
    float* out = a.out + row * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const bool failed = v[C + c] > thr && selff == 0.f;
        out[c] = failed ? -1.f : v[c];
    }
}

// Dynamic shared memory above 48 KB needs the opt-in; it is set once per
// kernel instance to the most a block may use (the launch passes the
// bytes it needs).
template <typename K>
int allow_smem(K kernel, bool& configured) {
    if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    return 0;
}

template <int C, int MODE>
int launch_c(const TileArgs& a, int tiles, cudaStream_t stream) {
    const int smem = (int)sizeof(float) *
        ((MODE == FUSED_DT ? 0 : 3 * C * CAP) + (MODE == GAUSS ? 0 : (2 * C + 1) * TILE));
    static bool configured = false;
    if (const int e = allow_smem(screen_tile_kernel<C, MODE>, configured)) return e;
    if (tiles > 0) screen_tile_kernel<C, MODE><<<tiles, TILE, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int C>
int launch_v3_c(const V3Args& a, int tiles, cudaStream_t stream) {
    const long long smem = (long long)sizeof(float) *
        ((long long)a.g_cap * a.r_pad + (2 * C + 1) * TILE);
    if (smem > MAX_SMEM) return -2;
    static bool configured = false;
    if (const int e = allow_smem(v3_tile_kernel<C>, configured)) return e;
    if (tiles > 0) v3_tile_kernel<C><<<tiles, TILE, (int)smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// Instantiates `launch<C>` for C = 1..MAX_C from the runtime count c.
#define DISPATCH_C(c, call)                                   \
    switch (c) {                                              \
        case 1: return call(1); case 2: return call(2);       \
        case 3: return call(3); case 4: return call(4);       \
        case 5: return call(5); case 6: return call(6);       \
        case 7: return call(7); case 8: return call(8);       \
        default: return -1;                                   \
    }

template <int MODE>
int launch(const TileArgs& a, int tiles, int c, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(C) launch_c<C, MODE>(a, tiles, s)
    DISPATCH_C(c, CALL)
#undef CALL
}

}  // namespace

extern "C" {

int screen_max_conformers() { return MAX_C; }

// K1: tile-major inputs; out [T*TILE, C] rows.
int screen_tiles_fused(const float* pos, const int32_t* uv, const float* gtab,
                       const float* aux, float* out, int tiles, int c,
                       int depth1, int depth2, void* stream) {
    TileArgs a{};
    a.pos = pos;
    a.uv = uv;
    a.mu = gtab;
    a.inv = gtab + P * TILE;
    a.winv = gtab + 2 * P * TILE;
    a.g_tstride = 3LL * P * TILE;
    a.g_pstride = TILE;
    for (int j = 0; j < 7; ++j) a.aux[j] = aux + (long long)j * TILE;
    a.a_tstride = 7LL * TILE;
    a.out = out;
    a.o_rstride = c;
    a.o_cstride = 1;
    a.depth1 = depth1;
    a.depth2 = depth2;
    return launch<FUSED>(a, tiles, c, stream);
}

// K4: row layout (uv [NS], mu/inv/winv [P, NS], seven [NS] rows); out [C, NS].
int screen_blocks_fused(const float* pos, const int32_t* uv, const float* mu,
                        const float* inv, const float* winv, const float* const* rows,
                        float* out, int tiles, int c, int depth1, int depth2,
                        void* stream) {
    const long long ns = (long long)tiles * TILE;
    TileArgs a{};
    a.pos = pos;
    a.uv = uv;
    a.mu = mu;
    a.inv = inv;
    a.winv = winv;
    a.g_tstride = TILE;
    a.g_pstride = ns;
    for (int j = 0; j < 7; ++j) a.aux[j] = rows[j];
    a.a_tstride = TILE;
    a.out = out;
    a.o_rstride = 1;
    a.o_cstride = ns;
    a.depth1 = depth1;
    a.depth2 = depth2;
    return launch<FUSED>(a, tiles, c, stream);
}

// K5: row layout; out [2C, NS] (scores, then pass counts).
int screen_gauss_phase(const float* pos, const int32_t* uv, const float* mu,
                       const float* inv, const float* winv, float* out,
                       int tiles, int c, void* stream) {
    const long long ns = (long long)tiles * TILE;
    TileArgs a{};
    a.pos = pos;
    a.uv = uv;
    a.mu = mu;
    a.inv = inv;
    a.winv = winv;
    a.g_tstride = TILE;
    a.g_pstride = ns;
    a.out = out;
    a.o_rstride = 1;
    a.o_cstride = ns;
    return launch<GAUSS>(a, tiles, c, stream);
}

// K3: K1 with stored distances dt [T, C, TILE]; out [T*TILE, C] rows.
int screen_tiles_fused_dt(const float* dt, const float* gtab, const float* aux,
                          float* out, int tiles, int c, int depth1, int depth2,
                          void* stream) {
    TileArgs a{};
    a.dt = dt;
    a.mu = gtab;
    a.inv = gtab + P * TILE;
    a.winv = gtab + 2 * P * TILE;
    a.g_tstride = 3LL * P * TILE;
    a.g_pstride = TILE;
    for (int j = 0; j < 7; ++j) a.aux[j] = aux + (long long)j * TILE;
    a.a_tstride = 7LL * TILE;
    a.out = out;
    a.o_rstride = c;
    a.o_cstride = 1;
    a.depth1 = depth1;
    a.depth2 = depth2;
    return launch<FUSED_DT>(a, tiles, c, stream);
}

// K2: v3 layout; out [T*TILE, C] rows. Returns -2 when the group table
// and the scan buffers do not fit a block's shared memory.
int screen_tiles_v3(const float* dt, const int32_t* gid, const float* tab,
                    const float* aux, float* out, int tiles, int c, int g_cap,
                    int r_pad, int mn_cap, int depth, void* stream) {
    const V3Args a{dt, gid, tab, aux, out, g_cap, r_pad, mn_cap, depth};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(C) launch_v3_c<C>(a, tiles, s)
    DISPATCH_C(c, CALL)
#undef CALL
}

int screen_max_smem() { return MAX_SMEM; }

}  // extern "C"
