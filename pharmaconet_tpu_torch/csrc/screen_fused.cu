// Fused screening kernels for Hopper (sm_90a): K1, K4 and K5.
//
// Replace the Pallas TPU kernels of pharmaconet_tpu/ops/screen_pallas.py:
//   K1 screen_tiles_fused  <- score_tiles_fused (_fused_kernel_v2), rows form
//                             of score_tiles_fused_rows: tile-major gtab/aux
//   K4 screen_blocks_fused <- score_blocks_pallas_fused (_fused_kernel):
//                             the same arithmetic over the row layout
//   K5 screen_gauss_phase  <- gaussian_phase_pallas (_gauss_kernel): the
//                             Gaussian phase alone (scans stay in torch)
//
// What each computes, per 1024-row tile (one thread block, one thread per
// row; scan segments never cross a tile because the layout is pair-aligned):
//   1. conformer distance d = sqrt((dx²+dy²)+dz²) between the row's two
//      ligand nodes, read from the tile's [3C, 64] node table in shared
//      memory (an indexed load; the TPU kernel selected with a one-hot
//      matmul because Mosaic has no gather);
//   2. over the P = 8 model pairs: x = (d-μ)·inv, term = winv·exp(-x²/2)
//      and pass = x² < 4 where winv > 0, summed over P;
//   3. (K1, K4) a bounded segmented Hillis-Steele scan sub-row -> block
//      (depth1), block score ·1/(MN), block fail where passes < (MN+1)/2 on
//      cross pairs, a second scan block -> pair (depth2), and -1 where
//      fails > threshold on a non-self pair.
//
// Bound on this card: bytes. Per tile the kernel streams ~147 KiB (gtab
// 96 KiB, aux 28 KiB, uv 4 KiB, the node table and the output) against
// ~300 f32 operations per row, far below the H100's operations-per-byte
// balance. The design keeps every intermediate (distances, the stacked
// scores/passes, both scans) in registers and shared memory, so HBM sees
// each input once and the output once. Not yet done: TMA/cp.async
// prefetch of the next tile and more than one tile in flight per SM.
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

struct TileArgs {
    const float* pos;    // [T, 3C, CAP]
    const int32_t* uv;   // [T * TILE] u_slot * CAP + v_slot
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

// Gaussian phase of one row: v[0, C) scores, v[C, 2C) pass counts.
template <int C>
__device__ __forceinline__ void gauss_row(const float* pos_s, int32_t uvp,
                                          const float* mu, const float* inv,
                                          const float* winv, long long pstride,
                                          float (&v)[2 * C]) {
    const int u = uvp / CAP, w = uvp % CAP;
    float d[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float dx = __fsub_rn(pos_s[(3 * c + 0) * CAP + u], pos_s[(3 * c + 0) * CAP + w]);
        const float dy = __fsub_rn(pos_s[(3 * c + 1) * CAP + u], pos_s[(3 * c + 1) * CAP + w]);
        const float dz = __fsub_rn(pos_s[(3 * c + 2) * CAP + u], pos_s[(3 * c + 2) * CAP + w]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        d[c] = __fsqrt_rn(d2);
        v[c] = 0.f;
        v[C + c] = 0.f;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const float m = mu[p * pstride];
        const float iv = inv[p * pstride];
        const float wt = winv[p * pstride];
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

template <int C, bool FUSED>
__global__ void __launch_bounds__(TILE) screen_tile_kernel(TileArgs a) {
    extern __shared__ float smem[];
    float* pos_s = smem;                     // [3C * CAP]
    float* buf = smem + 3 * C * CAP;         // [2C * TILE]  (FUSED only)
    float* seen_buf = buf + 2 * C * TILE;    // [TILE]       (FUSED only)

    const int t = blockIdx.x;
    const int r = threadIdx.x;
    const float* pos_t = a.pos + (long long)t * 3 * C * CAP;
    for (int i = r; i < 3 * C * CAP; i += TILE) pos_s[i] = pos_t[i];
    __syncthreads();

    const long long row = (long long)t * TILE + r;
    const long long g = (long long)t * a.g_tstride + r;
    float v[2 * C];
    gauss_row<C>(pos_s, a.uv[row], a.mu + g, a.inv + g, a.winv + g, a.g_pstride, v);

    float* out = a.out + row * a.o_rstride;
    if (!FUSED) {
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

template <int C, bool FUSED>
int launch_c(const TileArgs& a, int tiles, cudaStream_t stream) {
    const int smem = (int)sizeof(float) * (3 * C * CAP + (FUSED ? (2 * C + 1) * TILE : 0));
    static bool configured = false;  // smem above 48 KB needs the opt-in
    if (!configured) {
        const cudaError_t e = cudaFuncSetAttribute(
            screen_tile_kernel<C, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    if (tiles > 0) screen_tile_kernel<C, FUSED><<<tiles, TILE, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool FUSED>
int launch(const TileArgs& a, int tiles, int c, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (c) {
        case 1: return launch_c<1, FUSED>(a, tiles, s);
        case 2: return launch_c<2, FUSED>(a, tiles, s);
        case 3: return launch_c<3, FUSED>(a, tiles, s);
        case 4: return launch_c<4, FUSED>(a, tiles, s);
        case 5: return launch_c<5, FUSED>(a, tiles, s);
        case 6: return launch_c<6, FUSED>(a, tiles, s);
        case 7: return launch_c<7, FUSED>(a, tiles, s);
        case 8: return launch_c<8, FUSED>(a, tiles, s);
        default: return -1;
    }
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
    return launch<true>(a, tiles, c, stream);
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
    return launch<true>(a, tiles, c, stream);
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
    return launch<false>(a, tiles, c, stream);
}

}  // extern "C"
