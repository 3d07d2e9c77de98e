// Screening kernels for Hopper (sm_90a): K1-K5, and the probe kernels P1-P4.
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
// and the Pallas kernels of the repo's probes/ scripts (measurement
// variants; no route of the product calls them):
//   P1 screen_gauss_gather   <- probe_pallas_screen.py make_gather_fn
//                               (gather_kernel): K5 with each row's
//                               distances gathered from a unique-distance
//                               table d_table [NU, C] by slot
//   P2 screen_gauss_local    <- probe_pallas_screen.py make_onehot_fn
//                               (onehot_kernel): K5 with u and v read from
//                               two local index rows
//   P3 screen_tiles_fused_ablation <- probe_fused_split.py make_kernel:
//                               K1 with one stage removed (flags NOSCAN,
//                               NOEXP, NOHOT; all three = gauss0)
//   P4 screen_tiles_fused_variant  <- probe_kernel_r3.py make_kernel: K1's
//                               function in design variants. `full` and
//                               `b4d` launch K1's own instantiation: b4d
//                               removed the TPU's [P*C, TILE] broadcast
//                               copies, and a thread per row holds its P
//                               entries in registers and builds no
//                               broadcast, so K1 already is b4d here.
//                               `ohbf16` (FUSED_MMA) selects the node
//                               positions on the tensor cores (below).
//
// K1, K3, K4, K5 and P1-P4 are one template
// (screen_tile_kernel<C, MODE, FLAGS>) over pointer strides; K1-K5 are the
// FLAGS = 0 instances. What it computes, per 1024-row tile (one thread
// block, one thread per row; scan segments never cross a tile because the
// layout is pair-aligned):
//   1. the conformer distance d of the row: K3 loads it from the store's
//      dt [T, C, 1024], P1 from d_table[slot] (global memory; the table is
//      ~2 MB and stays in L2); the others compute sqrt((dx²+dy²)+dz²)
//      between the row's two ligand nodes, read from the tile's [3C, 64]
//      node table in shared memory (an indexed load; the TPU kernel
//      selected with a one-hot matmul because Mosaic has no gather);
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
// P4 `ohbf16` (FUSED_MMA) does the selection of step 1 as the TPU did, on
// the tensor cores: each f32 node position splits exactly into three bf16
// parts (hi, mid, lo, truncating: x = (hi + mid) + lo with no rounding),
// once per tile into shared memory; an unsigned one-hot [rows, 64] of u
// (then of v) times each part [64, 3C] is one mma.sync m16n8k16 bf16 ->
// f32 chain per warp, whose only nonzero product is part * 1, so every
// selection is exact; the three parts are summed in f32 (exact) and staged
// per warp in shared memory, and the row's thread then forms
// dx = pos_u - pos_v with __fsub_rn in K1's order. The distances are
// bit-equal to K1's. (The TPU probe's signed one-hot sums six terms inside
// the MMA, whose rounding is not K1's.) Per warp that is 96 MMAs at C = 4,
// their operand loads and the staging, where K1 does six indexed
// shared-memory loads per conformer and row: the probe measures what that
// costs.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;  // rows per tile (scoring/screen_tiles.py TILE)
constexpr int CAP = 64;     // node slots per tile (NODE_CAP)
constexpr int P = 8;        // model pairs per row (BLOCK_P)
constexpr int MAX_C = 8;    // conformers supported (template instances)
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may opt into

enum Mode { GAUSS = 0, FUSED = 1, FUSED_DT = 2, GATHER = 3, LOCAL = 4, FUSED_MMA = 5 };
// P3's ablations of FUSED: each removes one stage and the inputs only it reads
enum Flags { NOSCAN = 1, NOEXP = 2, NOHOT = 4 };

struct TileArgs {
    const float* pos;    // [T, 3C, CAP]           (GAUSS, FUSED, LOCAL, FUSED_MMA)
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
    // The probe kernels' inputs, last, so that K1-K5 keep their parameter
    // offsets and compile to the code they had before the probes:
    const float* dtab;   // [nu, C] unique distances (GATHER)
    const int32_t* slot; // [T * TILE] row -> dtab row (GATHER)
    long long nu;
    const int32_t* uloc; // [T * TILE] u slot (LOCAL)
    const int32_t* vloc; // [T * TILE] v slot (LOCAL)
    float* dist;         // optional [T, C, TILE] distances out (FUSED_MMA)
};

// sqrt((dx²+dy²)+dz²) in the reference's order, d = pu - pw per axis.
__device__ __forceinline__ float distance3(float ux, float uy, float uz, float wx, float wy,
                                           float wz) {
    const float dx = __fsub_rn(ux, wx);
    const float dy = __fsub_rn(uy, wy);
    const float dz = __fsub_rn(uz, wz);
    return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz)));
}

// Conformer distances of one row (node slots u, w) from the tile's node table.
template <int C>
__device__ __forceinline__ void row_distances(const float* pos_s, int u, int w,
                                              float (&d)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float* p = pos_s + 3 * c * CAP;
        d[c] = distance3(p[u], p[CAP + u], p[2 * CAP + u], p[w], p[CAP + w], p[2 * CAP + w]);
    }
}

// --- P4 ohbf16: the node selection on the tensor cores ---------------------

// x's exact three-way bf16 split (hi, mid, lo) into parts[i],
// parts[stride + i], parts[2 * stride + i]: truncation keeps each residual
// exact in f32, and 24 significand bits fit three bf16 parts of 8, so
// x == (hi + mid) + lo.
__device__ __forceinline__ void split_bf16(float x, uint16_t* parts, int i, int stride) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const __nv_bfloat16 p = __float2bfloat16_rz(x);
        parts[k * stride + i] = __bfloat16_as_ushort(p);
        x = __fsub_rn(x, __bfloat162float(p));
    }
}

// bf16 pair (k, k + 1) of an unsigned one-hot row: 1.0 where idx matches.
__device__ __forceinline__ uint32_t onehot_pair(int idx, int k) {
    return (idx == k ? 0x3F80u : 0u) | (idx == k + 1 ? 0x3F800000u : 0u);
}

// d += a · b, one m16n8k16 bf16 tile with an f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Conformer distances of row r (its warp's 32 rows together): for each
// side (u, then w) and each 16-row half of the warp, the one-hot [16, 64]
// of the rows' slots times each bf16 part of the node table (`parts`,
// [3, 3C, CAP], read as [64, 3C] B tiles padded to 8 columns) gives that
// part of the rows' [16, 3C] positions; the parts are summed in f32 into
// `stage` (per warp [32, 3C] for u, then for w), which the row's thread
// reads back.
template <int C>
__device__ __forceinline__ void mma_row_distances(const uint16_t* parts, int32_t uvp,
                                                  float* stage, int r, float (&d)[C]) {
    constexpr int K3 = 3 * C;
    constexpr int NT = (K3 + 7) / 8;
    const int lane = r & 31, g = lane >> 2, q = lane & 3;
    float* st = stage + (r & ~31) * 2 * K3;  // this warp's [2][32][K3]
#pragma unroll
    for (int side = 0; side < 2; ++side) {
        const int idx = side == 0 ? uvp / CAP : uvp % CAP;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int ia = __shfl_sync(0xffffffffu, idx, half * 16 + g);
            const int ib = __shfl_sync(0xffffffffu, idx, half * 16 + g + 8);
#pragma unroll
            for (int part = 0; part < 3; ++part) {
                float acc[NT][4] = {};
#pragma unroll
                for (int k16 = 0; k16 < CAP; k16 += 16) {
                    const int k = k16 + 2 * q;
                    const uint32_t a[4] = {onehot_pair(ia, k), onehot_pair(ib, k),
                                           onehot_pair(ia, k + 8), onehot_pair(ib, k + 8)};
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt) {
                        const int n = nt * 8 + g;  // node table row (coordinate 3c + axis)
                        // bf16 pairs (k, k + 1) and (k + 8, k + 9) of row n of this part
                        const uint32_t* b = reinterpret_cast<const uint32_t*>(
                            parts + (part * K3 + (n < K3 ? n : 0)) * CAP + k);
                        mma_bf16(acc[nt], a, n < K3 ? b[0] : 0u, n < K3 ? b[4] : 0u);
                    }
                }
                // acc[nt][e]: row half*16 + g (+8 for e >= 2), column nt*8 + 2q + (e & 1)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int col = nt * 8 + 2 * q + (e & 1);
                        if (col < K3) {
                            float* s = st + side * 32 * K3 + (half * 16 + g + (e >> 1) * 8) * K3 + col;
                            *s = part == 0 ? acc[nt][e] : __fadd_rn(*s, acc[nt][e]);
                        }
                    }
                }
            }
        }
    }
    __syncwarp();
    const float* pu = st + lane * K3;
    const float* pw = st + 32 * K3 + lane * K3;
#pragma unroll
    for (int c = 0; c < C; ++c)
        d[c] = distance3(pu[3 * c], pu[3 * c + 1], pu[3 * c + 2], pw[3 * c], pw[3 * c + 1],
                         pw[3 * c + 2]);
}

// One Gaussian entry (μ, inv, weight) added to the row's stacked sums:
// v[0, C) scores, v[C, 2C) pass counts. NOEXP (P3) takes wt·x² as the term.
template <int C, bool NOEXP = false>
__device__ __forceinline__ void gauss_entry(const float (&d)[C], float m, float iv,
                                            float wt, float (&v)[2 * C]) {
    const bool valid = wt > 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float x = __fmul_rn(__fsub_rn(d[c], m), iv);
        const float x2 = __fmul_rn(x, x);
        const float e = NOEXP ? x2 : expf(__fmul_rn(-0.5f, x2));
        const float term = valid ? __fmul_rn(wt, e) : 0.f;
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

// Shared memory of one block, in floats: the tile's node table where the
// distances are rebuilt (FUSED_MMA: its three bf16 parts, [3, 3C, CAP] of
// 16 bits), and the scan buffers (FUSED_MMA: also the selection's staging,
// [2, TILE, 3C], which the scans reuse).
template <int C, int MODE, int FLAGS>
__host__ __device__ constexpr int pos_floats() {
    if (MODE == FUSED_DT || MODE == GATHER || (FLAGS & NOHOT)) return 0;
    return MODE == FUSED_MMA ? 3 * 3 * C * CAP / 2 : 3 * C * CAP;
}
template <int MODE, int FLAGS>
__host__ __device__ constexpr bool has_scans() {
    return (MODE == FUSED || MODE == FUSED_DT || MODE == FUSED_MMA) && !(FLAGS & NOSCAN);
}
template <int C, int MODE, int FLAGS>
__host__ __device__ constexpr int smem_floats() {
    const int scan = has_scans<MODE, FLAGS>() ? (2 * C + 1) * TILE : 0;
    const int stage = MODE == FUSED_MMA ? 6 * C * TILE : 0;
    return pos_floats<C, MODE, FLAGS>() + (scan > stage ? scan : stage);
}

template <int C, int MODE, int FLAGS = 0>
__global__ void __launch_bounds__(TILE) screen_tile_kernel(TileArgs a) {
    extern __shared__ float smem[];
    constexpr int POS = pos_floats<C, MODE, FLAGS>();
    float* pos_s = smem;                     // [POS]
    float* buf = smem + POS;                 // [2C * TILE]  (scans; FUSED_MMA staging)
    float* seen_buf = buf + 2 * C * TILE;    // [TILE]       (scans)

    const int t = blockIdx.x;
    const int r = threadIdx.x;
    const long long row = (long long)t * TILE + r;
    float d[C];
    if constexpr ((FLAGS & NOHOT) != 0) {
        // the probe's constant distance: no uv, one node-table value
        const float d0 = __fadd_rn(1.5f, a.pos[(long long)t * 3 * C * CAP]);
#pragma unroll
        for (int c = 0; c < C; ++c) d[c] = d0;
    } else if constexpr (MODE == FUSED_DT) {
        const float* dt_t = a.dt + (long long)t * C * TILE + r;
#pragma unroll
        for (int c = 0; c < C; ++c) d[c] = dt_t[c * TILE];
    } else if constexpr (MODE == GATHER) {
        const long long s = a.slot[row];
        const bool in = s >= 0 && s < a.nu;  // a slot outside the table gives NaN
#pragma unroll
        for (int c = 0; c < C; ++c) d[c] = in ? a.dtab[s * C + c] : __int_as_float(0x7fc00000);
    } else if constexpr (MODE == FUSED_MMA) {
        constexpr int N = 3 * C * CAP;
        uint16_t* parts = reinterpret_cast<uint16_t*>(pos_s);
        const float* pos_t = a.pos + (long long)t * N;
        for (int i = r; i < N; i += TILE) split_bf16(pos_t[i], parts, i, N);
        __syncthreads();
        mma_row_distances<C>(parts, a.uv[row], buf, r, d);
        if (a.dist != nullptr) {
#pragma unroll
            for (int c = 0; c < C; ++c) a.dist[((long long)t * C + c) * TILE + r] = d[c];
        }
        __syncthreads();  // the scans reuse the staging of every warp
    } else {
        const float* pos_t = a.pos + (long long)t * 3 * C * CAP;
        for (int i = r; i < POS; i += TILE) pos_s[i] = pos_t[i];
        __syncthreads();
        if constexpr (MODE == LOCAL) {
            row_distances<C>(pos_s, a.uloc[row], a.vloc[row], d);
        } else {
            const int32_t uvp = a.uv[row];
            row_distances<C>(pos_s, uvp / CAP, uvp % CAP, d);
        }
    }

    const long long g = (long long)t * a.g_tstride + r;
    float v[2 * C];
#pragma unroll
    for (int j = 0; j < 2 * C; ++j) v[j] = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const long long gp = g + p * a.g_pstride;
        gauss_entry<C, (FLAGS & NOEXP) != 0>(d, a.mu[gp], a.inv[gp], a.winv[gp], v);
    }

    float* out = a.out + row * a.o_rstride;
    if constexpr (MODE == GAUSS || MODE == GATHER || MODE == LOCAL) {
#pragma unroll
        for (int j = 0; j < 2 * C; ++j) out[j * a.o_cstride] = v[j];
        return;
    }
    if constexpr ((FLAGS & NOSCAN) != 0) {
        // the probe writes scores + pass counts and skips the scans, the
        // fail logic and their aux rows
#pragma unroll
        for (int c = 0; c < C; ++c) out[c * a.o_cstride] = __fadd_rn(v[c], v[C + c]);
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

template <int C, int MODE, int FLAGS>
int launch_c(const TileArgs& a, int tiles, cudaStream_t stream) {
    constexpr int smem = (int)sizeof(float) * smem_floats<C, MODE, FLAGS>();
    static_assert(smem <= MAX_SMEM, "block shared memory");
    static bool configured = false;
    if (const int e = allow_smem(screen_tile_kernel<C, MODE, FLAGS>, configured)) return e;
    if (tiles > 0) screen_tile_kernel<C, MODE, FLAGS><<<tiles, TILE, smem, stream>>>(a);
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

template <int MODE, int FLAGS = 0>
int launch(const TileArgs& a, int tiles, int c, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(C) launch_c<C, MODE, FLAGS>(a, tiles, s)
    DISPATCH_C(c, CALL)
#undef CALL
}

// K1's arguments: tile-major pos/uv/gtab [T, 3, P, TILE]/aux [T, 7, TILE];
// out [T*TILE, C] rows.
TileArgs tile_major_args(const float* pos, const int32_t* uv, const float* gtab,
                         const float* aux, float* out, int c, int depth1, int depth2) {
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
    return a;
}

// The row layout's Gaussian tables [P, NS] and output [R, NS] (K4; K5, P1
// and P2 stacked, R = 2C).
void row_layout_tables(TileArgs& a, const float* mu, const float* inv, const float* winv,
                       float* out, int tiles) {
    const long long ns = (long long)tiles * TILE;
    a.mu = mu;
    a.inv = inv;
    a.winv = winv;
    a.g_tstride = TILE;
    a.g_pstride = ns;
    a.out = out;
    a.o_rstride = 1;
    a.o_cstride = ns;
}

}  // namespace

extern "C" {

int screen_max_conformers() { return MAX_C; }

// K1: tile-major inputs; out [T*TILE, C] rows.
int screen_tiles_fused(const float* pos, const int32_t* uv, const float* gtab,
                       const float* aux, float* out, int tiles, int c,
                       int depth1, int depth2, void* stream) {
    return launch<FUSED>(tile_major_args(pos, uv, gtab, aux, out, c, depth1, depth2), tiles, c,
                         stream);
}

// K4: row layout (uv [NS], mu/inv/winv [P, NS], seven [NS] rows); out [C, NS].
int screen_blocks_fused(const float* pos, const int32_t* uv, const float* mu,
                        const float* inv, const float* winv, const float* const* rows,
                        float* out, int tiles, int c, int depth1, int depth2,
                        void* stream) {
    TileArgs a{};
    a.pos = pos;
    a.uv = uv;
    row_layout_tables(a, mu, inv, winv, out, tiles);
    for (int j = 0; j < 7; ++j) a.aux[j] = rows[j];
    a.a_tstride = TILE;
    a.depth1 = depth1;
    a.depth2 = depth2;
    return launch<FUSED>(a, tiles, c, stream);
}

// K5: row layout; out [2C, NS] (scores, then pass counts).
int screen_gauss_phase(const float* pos, const int32_t* uv, const float* mu,
                       const float* inv, const float* winv, float* out,
                       int tiles, int c, void* stream) {
    TileArgs a{};
    a.pos = pos;
    a.uv = uv;
    row_layout_tables(a, mu, inv, winv, out, tiles);
    return launch<GAUSS>(a, tiles, c, stream);
}

// K3: K1 with stored distances dt [T, C, TILE]; out [T*TILE, C] rows.
int screen_tiles_fused_dt(const float* dt, const float* gtab, const float* aux,
                          float* out, int tiles, int c, int depth1, int depth2,
                          void* stream) {
    TileArgs a = tile_major_args(nullptr, nullptr, gtab, aux, out, c, depth1, depth2);
    a.dt = dt;
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

// P1: d_table [nu, C], slots [NS]; row layout; out [2C, NS].
int screen_gauss_gather(const float* dtab, long long nu, const int32_t* slot, const float* mu,
                        const float* inv, const float* winv, float* out, int tiles, int c,
                        void* stream) {
    TileArgs a{};
    a.dtab = dtab;
    a.nu = nu;
    a.slot = slot;
    row_layout_tables(a, mu, inv, winv, out, tiles);
    return launch<GATHER>(a, tiles, c, stream);
}

// P2: per-tile node tables pos [T, 3C, CAP], local slots uloc/vloc [NS];
// row layout; out [2C, NS].
int screen_gauss_local(const float* pos, const int32_t* uloc, const int32_t* vloc,
                       const float* mu, const float* inv, const float* winv, float* out,
                       int tiles, int c, void* stream) {
    TileArgs a{};
    a.pos = pos;
    a.uloc = uloc;
    a.vloc = vloc;
    row_layout_tables(a, mu, inv, winv, out, tiles);
    return launch<LOCAL>(a, tiles, c, stream);
}

// P3: K1's inputs and output, with one of the probe's ablations (flags 0
// launches K1's own instantiation). Returns -1 for another flag set.
int screen_tiles_fused_ablation(const float* pos, const int32_t* uv, const float* gtab,
                                const float* aux, float* out, int tiles, int c, int depth1,
                                int depth2, int flags, void* stream) {
    const TileArgs a = tile_major_args(pos, uv, gtab, aux, out, c, depth1, depth2);
    switch (flags) {
        case 0: return launch<FUSED>(a, tiles, c, stream);
        case NOSCAN: return launch<FUSED, NOSCAN>(a, tiles, c, stream);
        case NOEXP: return launch<FUSED, NOEXP>(a, tiles, c, stream);
        case NOHOT: return launch<FUSED, NOHOT>(a, tiles, c, stream);
        case NOHOT | NOEXP | NOSCAN: return launch<FUSED, NOHOT | NOEXP | NOSCAN>(a, tiles, c, stream);
        default: return -1;
    }
}

// P4: K1's inputs and output in a design variant: 0 full and 1 b4d launch
// K1's instantiation, 2 ohbf16 the tensor-core selection, which also
// writes its distances to dist [T, C, TILE] when dist is not null.
int screen_tiles_fused_variant(const float* pos, const int32_t* uv, const float* gtab,
                               const float* aux, float* out, float* dist, int tiles, int c,
                               int depth1, int depth2, int variant, void* stream) {
    TileArgs a = tile_major_args(pos, uv, gtab, aux, out, c, depth1, depth2);
    switch (variant) {
        case 0:
        case 1: return dist ? -1 : launch<FUSED>(a, tiles, c, stream);
        case 2: a.dist = dist; return launch<FUSED_MMA>(a, tiles, c, stream);
        default: return -1;
    }
}

int screen_max_smem() { return MAX_SMEM; }

}  // extern "C"
