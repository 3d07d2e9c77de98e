// Screening kernels for Hopper (sm_90a): K1-K5, and the probe kernels P1-P4.
//
// Replace the Pallas TPU kernels of pharmaconet_tpu/ops/screen_pallas.py:
//   K1 screen_tiles_fused    <- score_tiles_fused (_fused_kernel_v2), rows
//                               form of score_tiles_fused_rows: tile-major
//                               gtab/aux, distances rebuilt per tile
//                               (fused_stream_kernel<C>)
//   K2 screen_tiles_v3       <- score_tiles_v3 (_v3_kernel), rows form of
//                               score_tiles_v3_rows: v3 block-major layout
//                               (v3_stream_kernel<C>)
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
//                               `b4d` launch K1 (fused_stream_kernel): b4d
//                               removed the TPU's [P*C, TILE] broadcast
//                               copies, and a thread per row holds its P
//                               entries in registers and builds no
//                               broadcast, so K1 already is b4d.
//                               `ohbf16` (fused_stream_mma_kernel<C>) is
//                               K1 with the node positions selected on the
//                               tensor cores by wgmma (below); its first
//                               design (FUSED_MMA, mma.sync inside K1's
//                               first design) stays behind
//                               screen_tiles_ohbf16_baseline.
//
// K3, K4, K5 and P1-P4 are one template
// (screen_tile_kernel<C, MODE, FLAGS>) over pointer strides; K3-K5 are
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
//   3. (FUSED, FUSED_DT) a bounded segmented Hillis-Steele scan sub-row ->
//      block (depth1), block score ·1/(MN), block fail where passes <
//      (MN+1)/2 on cross pairs, a second scan block -> pair (depth2), and -1
//      where fails > threshold on a non-self pair.
// Its FUSED, FLAGS = 0 instance is K1's first design: the tile's node table
// loaded and waited for at a block-wide barrier, then two block-wide scans
// with two barriers per step. P3 `full` launches it, and K1 is held to it
// bit for bit. K2's first design, v3_tile_kernel<C> (the
// same arithmetic on the v3 layout: one row per ligand-node-pair block, the
// mn_cap model-node-pair entries inside the row, each row reading its
// group's (μ, 1/std, w2, mnhalf) from the tile's [g_cap, r_pad] group table
// in shared memory by its gid, the block fail set in-row, ONE pair-level
// scan of [score; block_fail]), stays behind screen_tiles_v3_baseline for
// the same comparison.
//
// P4 `ohbf16` does the selection of step 1 as the TPU did, on the tensor
// cores: each f32 node position splits exactly into three bf16 parts (hi,
// mid, lo, truncating: x = (hi + mid) + lo with no rounding wherever
// |x| >= 2^-110 or x = ±0, -0 coming back +0; below 2^-110 the lowest part
// can fall under bf16's subnormals), once per tile into shared memory; an
// unsigned one-hot
// [rows, 64] of u (then of v) times the parts [64, 3C] on the tensor cores
// has one nonzero product, part * 1, per column, so every selection is
// exact; the three parts are summed in f32 (exact), and dx = pos_u - pos_v
// is formed with __fsub_rn in K1's order. The distances are bit-equal to
// K1's. (The TPU probe's signed one-hot sums six terms inside the MMA,
// whose rounding is not K1's.)
//   - The first design (FUSED_MMA in screen_tile_kernel, inside K1's first
//     design): per warp and 16-row half, one mma.sync m16n8k16 chain per
//     side and part (96 MMAs per warp at C = 4, the one-hot rebuilt for
//     every part, two conflicted 32-bit B loads per MMA), each part's
//     positions read-modify-written in a [2, TILE, 3C] stage.
//   - The second (fused_stream_mma_kernel): K1's streaming kernel with only
//     the selection replaced. The block splits each landed node table once
//     into a swizzled K-major B operand (double-buffered like K1's tables);
//     each warpgroup runs wgmma m64nNk16 with the one-hot A from registers,
//     each warp its own 16 rows of the 64-row M-tile, so the products land
//     in the warp that owns the rows: per side, half and part one chain of
//     4 k steps (48 wgmma per 128 rows), and 3C differences per row staged
//     in the warp's own scan rows.
//
// Bound on this card: bytes. Per tile K1 streams ~147 KiB (gtab 96 KiB,
// aux 28 KiB, uv 4 KiB, the node table and the output), K3 ~160 KiB (dt
// in place of uv and the node table), K2 ~44 KiB (dt, gid, an 8 KiB table,
// aux 12 KiB, the output), each against a few hundred f32 operations per
// row, far below the H100's operations-per-byte balance. Every design keeps
// every intermediate (distances, the stacked scores/passes, the scans) in
// registers and shared memory, so HBM sees each input once and the output
// once.
//
// What held the first designs of K1 and K2 from that bound was work and
// waiting inside the block, not the memory system: a 1024-thread block per
// tile sits alone on its SM, each tile began with a global load of its
// small table and a block-wide barrier that nothing on the SM hid, and each
// scan step paid two barriers and a shared-memory round trip (P3's
// ablation: the selection 36% of K1's time, the scans 27%). The streaming
// designs (fused_stream_kernel, v3_stream_kernel):
//   - Persistent blocks, as many as fit on the SMs (one 1024-thread block
//     per SM), each walk tiles blockIdx.x, + gridDim.x, ...
//   - The small per-tile tables arrive by TMA (cp.async.bulk, completion on
//     an mbarrier) into a double buffer: K1's uv and [3C, 64] node table,
//     K2's gid and [g_cap, r_pad] group table. While tile j computes, tile
//     j+1's tables have landed and tile j+2's are in flight.
//   - The large streams (K1's gtab and aux, K2's dt and aux) stay coalesced
//     register loads; while one warp waits for them the SM's other warps
//     compute, since only the scans' barriers align the warps of a tile.
//     K2 has the registers to load its next tile's streams before its
//     barrier, so they arrive during the scan; K1, at the 64 registers a
//     1024-thread block allows, has not. (A bulk L2 prefetch of the next
//     tile's streams made K1 slower on the H100, so there is none.)
//   - K1 interleaves each staged node table once, as [64][C] of (x, y, z, -):
//     a conformer position is one 16-byte shared-memory load, 2C per row
//     where the first design made 6C scalar loads. The values are the same,
//     so distance3 gives the same distances.
//   - K2 finds, once per tile as its table lands, each group's last entry
//     of positive weight, and every row's loop stops there. Padding sits
//     above a group's mn with w = 0 (scoring/screen_v3.py _expand_rows). An
//     entry of weight <= 0 (or NaN) adds +0 to a sum that starts at +0 and
//     stays >= +0 or NaN, and no pass, so skipping it changes no bit.
//   - The scans run inside each warp with shuffles (scan_rows, which says
//     why that is exact): one barrier per scan, where the block-wide scan
//     paid two per step. Depths whose window exceeds a warp (2^depth > 32)
//     take the block-wide steps, a branch of the same function. Per tile K1
//     passes two barriers and K2 one.
//   - A K2 table too large for the double buffers (and double scan buffers)
//     runs with single ones, staged one tile ahead behind one more barrier
//     per tile. So K2 takes every table of the stores' shapes (g_cap a
//     power of two, r_pad a multiple of 128) that the first design took.
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

// --- K1 and K2: persistent blocks, TMA-staged tables, warp scans ------------

// Scans whose window (2^depth rows) fits a warp run inside the warp.
constexpr int WINDOW_DEPTH = 5;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of this parity has completed; the data
// its copies wrote is then visible to the thread.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    }
}

// One thread arms `bar` for `bytes`, then issues the TMA copies that bring
// them (each contiguous, 16-byte aligned, a multiple of 16 bytes).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
          "r"(smem_u32(bar))
        : "memory");
}

// Orders the block's reads of a buffer (behind the barrier just passed)
// before the TMA writes into it that the thread issues next.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// scan_bounded's scan (the same recurrence, val += val[r - shift] where row
// r has not yet seen its start, lanes below the shift at the tile start
// acting as starts, and the same __fadd_rn on the same operands) without a
// barrier per step. Thread r holds row r's R values and its start flag;
// `buf` holds every row's initial [values; flag] (R + 1 floats, row stride
// TILE), written before a barrier the block has passed.
//
// Windowed (depth <= WINDOW_DEPTH): after k steps a row depends only on its
// own and the 2^k - 1 rows before it, so a warp's 32 rows need no more than
// the 31 rows before the warp. Each lane also carries row r - 32 (its halo
// row, read once from buf) through the same steps, and takes a predecessor
// from the warp's lanes by shuffle, or from the halo lanes when it lies
// before the warp. A halo row whose predecessor lies before the halo is
// left as it is: after k steps halo lane m holds the block-wide scan's
// value whenever m >= 2^k - 1, and at step k a row of the warp reads halo
// lane m >= 32 - 2^k, which is such a lane for every k <= 4. So every
// operand a row of the warp adds is the block-wide scan's, and the results
// are equal bit for bit. Halo rows before the tile (warp 0) are starts
// holding 0, and no row reads them: a row below the shift is a start.
//
// Block-wide (deeper windows): scan_bounded's steps, two barriers each.
template <int R>
__device__ __forceinline__ void scan_rows(float (&v)[R], float seen, int depth, float* buf,
                                          int r) {
    if (depth <= WINDOW_DEPTH) {
        const int lane = r & 31;
        float h[R];
        float hs = 1.f;
#pragma unroll
        for (int j = 0; j < R; ++j) h[j] = r >= 32 ? buf[j * TILE + r - 32] : 0.f;
        if (r >= 32) hs = buf[R * TILE + r - 32];
        for (int k = 0; k < depth; ++k) {
            const int shift = 1 << k;
            const int src = (lane - shift) & 31;
            const bool inside = lane >= shift;  // the predecessor is a lane of the warp
            const bool add = r >= shift && seen == 0.f;
            const bool add_h = inside && hs == 0.f;
            const float ps = __shfl_sync(FULL_MASK, seen, src);
            const float phs = __shfl_sync(FULL_MASK, hs, src);
            // value by value: each shuffle reads every lane's value before
            // any lane updates it
#pragma unroll
            for (int j = 0; j < R; ++j) {
                const float pv = __shfl_sync(FULL_MASK, v[j], src);
                const float ph = __shfl_sync(FULL_MASK, h[j], src);
                if (add) v[j] = __fadd_rn(v[j], inside ? pv : ph);
                if (add_h) h[j] = __fadd_rn(h[j], ph);
            }
            seen = r >= shift ? fmaxf(seen, inside ? ps : phs) : 1.f;
            if (inside) hs = fmaxf(hs, phs);
        }
        return;
    }
    for (int k = 0, shift = 1; k < depth && shift < TILE; ++k, shift <<= 1) {
        float pv[R];
        float ps = 0.f;
        if (r >= shift) {
#pragma unroll
            for (int j = 0; j < R; ++j) pv[j] = buf[j * TILE + r - shift];
            ps = buf[R * TILE + r - shift];
        }
        __syncthreads();
        if (r >= shift) {
            if (seen == 0.f) {
#pragma unroll
                for (int j = 0; j < R; ++j) v[j] = __fadd_rn(v[j], pv[j]);
            }
            seen = fmaxf(seen, ps);
        } else {
            seen = 1.f;
        }
#pragma unroll
        for (int j = 0; j < R; ++j) buf[j * TILE + r] = v[j];
        buf[R * TILE + r] = seen;
        __syncthreads();
    }
}

// Row r's C results with the widest aligned stores (out rows are C floats).
template <int C>
__device__ __forceinline__ void store_row(float* o, const float (&x)[C]) {
    if constexpr (C % 4 == 0) {
#pragma unroll
        for (int q = 0; q < C / 4; ++q)
            reinterpret_cast<float4*>(o)[q] =
                make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    } else if constexpr (C % 2 == 0) {
#pragma unroll
        for (int q = 0; q < C / 2; ++q)
            reinterpret_cast<float2*>(o)[q] = make_float2(x[2 * q], x[2 * q + 1]);
    } else {
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] = x[c];
    }
}

// The pair-level tail: -1 where a cross pair's fails exceed its threshold.
template <int C>
__device__ __forceinline__ void store_pairs(float* o, const float (&v)[2 * C], float thr,
                                            float selff) {
    float x[C];
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = (v[C + c] > thr && selff == 0.f) ? -1.f : v[c];
    store_row<C>(o, x);
}

// K1's arguments: tile-major pos [T, 3C, CAP], uv [T, TILE], gtab
// [T, 3, P, TILE], aux [T, 7, TILE]; out [T * TILE, C] rows.
struct FusedStreamArgs {
    const float* pos;
    const int32_t* uv;
    const float* gtab;
    const float* aux;
    float* out;
    int tiles, depth1, depth2;
};

// K1's shared memory: two stages of (uv, raw node table) that TMA fills,
// two interleaved node tables, and the two scans' buffers.
template <int C>
struct FusedStreamSmem {
    static constexpr int NODE = 3 * C * CAP;  // floats of one node table
    static constexpr int ROWV = 2 * C + 1;    // scan floats per row
    uint64_t bar[2];
    int32_t uv[2][TILE];
    float raw[2][NODE];
    float4 node[2][CAP * C];  // [slot][conformer] of (x, y, z, unused)
    float scan1[ROWV * TILE];
    float scan2[ROWV * TILE];
};

// K1: the streaming design (see the file header).
template <int C>
__global__ void __launch_bounds__(TILE, 1) fused_stream_kernel(FusedStreamArgs a) {
    using Smem = FusedStreamSmem<C>;
    constexpr int NODE = Smem::NODE;
    extern __shared__ __align__(16) unsigned char smem_bytes[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_bytes);
    const int r = threadIdx.x;
    const int grid = gridDim.x;
    int t = blockIdx.x;
    if (t >= a.tiles) return;

    auto stage = [&](int tt, int s) {  // one thread: tile tt's tables -> stage s
        mbar_expect(&sm.bar[s], (TILE + NODE) * 4);
        bulk_copy(sm.uv[s], a.uv + (long long)tt * TILE, TILE * 4, &sm.bar[s]);
        bulk_copy(sm.raw[s], a.pos + (long long)tt * NODE, NODE * 4, &sm.bar[s]);
    };
    auto interleave = [&](int s) {  // the block: raw [3C, CAP] -> node [CAP][C]
        for (int i = r; i < NODE; i += TILE) {
            const int row = i / CAP, slot = i % CAP;  // row = 3 * conformer + axis
            reinterpret_cast<float*>(&sm.node[s][slot * C + row / 3])[row % 3] = sm.raw[s][i];
        }
    };

    if (r == 0) {
        mbar_init(&sm.bar[0]);
        mbar_init(&sm.bar[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (r == 0) {
        stage(t, 0);
        if (t + grid < a.tiles) stage(t + grid, 1);
    }
    mbar_wait(&sm.bar[0], 0);
    interleave(0);
    __syncthreads();

    for (int j = 0; t < a.tiles; ++j, t += grid) {
        const int s = j & 1;
        const bool next = t + grid < a.tiles;
        // selection: a 16-byte load per node and conformer
        const int32_t uvp = sm.uv[s][r];
        const float4* nu = &sm.node[s][(uvp / CAP) * C];
        const float4* nw = &sm.node[s][(uvp % CAP) * C];
        float d[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const float4 pu = nu[c], pw = nw[c];
            d[c] = distance3(pu.x, pu.y, pu.z, pw.x, pw.y, pw.z);
        }
        // the Gaussian tables, coalesced; four model pairs' loads in flight
        // at a time (all eight ran slower on the H100: 24 live loads crowd
        // the 64 registers a 1024-thread block allows)
        const float* g = a.gtab + (long long)t * 3 * P * TILE + r;
        float v[2 * C];
#pragma unroll
        for (int i = 0; i < 2 * C; ++i) v[i] = 0.f;
#pragma unroll 4
        for (int p = 0; p < P; ++p)
            gauss_entry<C>(d, g[p * TILE], g[(P + p) * TILE], g[(2 * P + p) * TILE], v);
        const float* ax = a.aux + (long long)t * 7 * TILE + r;
        const float fb = ax[0], fp = ax[TILE];
        const float mninv = ax[2 * TILE], mnhalf = ax[3 * TILE], gate = ax[4 * TILE];
        const float thr = ax[5 * TILE], selff = ax[6 * TILE];

        // sub -> block: scores and pass counts scan together
#pragma unroll
        for (int i = 0; i < 2 * C; ++i) sm.scan1[i * TILE + r] = v[i];
        sm.scan1[2 * C * TILE + r] = fb;
        if (next) {  // tile j+1's tables have landed (issued a tile ago)
            mbar_wait(&sm.bar[s ^ 1], ((j + 1) >> 1) & 1);
            interleave(s ^ 1);
        }
        __syncthreads();
        if (r == 0 && t + 2 * grid < a.tiles) {  // stage s is read: tile j+2's tables
            fence_proxy_async();
            stage(t + 2 * grid, s);
        }
        scan_rows<2 * C>(v, fb, a.depth1, sm.scan1, r);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            v[c] = __fmul_rn(v[c], mninv);                 // block score
            v[C + c] = (v[C + c] < mnhalf) ? gate : 0.f;   // block fail
        }
        // block -> pair: [block_score; block_fail] scan together
#pragma unroll
        for (int i = 0; i < 2 * C; ++i) sm.scan2[i * TILE + r] = v[i];
        sm.scan2[2 * C * TILE + r] = fp;
        __syncthreads();
        scan_rows<2 * C>(v, fp, a.depth2, sm.scan2, r);
        store_pairs<C>(a.out + ((long long)t * TILE + r) * C, v, thr, selff);
    }
}

// K2's arguments: dt [T, C, TILE], gid [T, TILE], tab [T, g_cap, r_pad],
// aux [T, 3, TILE]; out [T * TILE, C] rows.
struct V3StreamArgs {
    const float* dt;
    const int32_t* gid;
    const float* tab;
    const float* aux;
    float* out;
    int tiles, g_cap, r_pad, mn_cap, depth, stages;
};

// K2's shared memory, byte offsets for `stages` (2: double buffers; 1:
// single ones, for tables too large for two): the mbarriers, each stage's
// per-group entry limits, gid and group table, and the scan buffers.
struct V3Layout {
    long long lim, gid, tab, scan, total;
};

__host__ __device__ inline V3Layout v3_layout(int c, int g_cap, int r_pad, int stages) {
    V3Layout l;
    l.lim = 16;
    l.gid = l.lim + ((4LL * stages * g_cap + 15) / 16) * 16;
    l.tab = l.gid + 4LL * stages * TILE;
    l.scan = l.tab + 4LL * stages * g_cap * r_pad;
    l.total = l.scan + 4LL * stages * (2 * c + 1) * TILE;
    return l;
}

// K2: the streaming design (see the file header).
template <int C>
__global__ void __launch_bounds__(TILE, 1) v3_stream_kernel(V3StreamArgs a) {
    constexpr int ROWV = 2 * C + 1;
    extern __shared__ __align__(16) unsigned char smem_bytes[];
    const int stages = a.stages;
    const V3Layout L = v3_layout(C, a.g_cap, a.r_pad, stages);
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem_bytes);
    int* lim_s = reinterpret_cast<int*>(smem_bytes + L.lim);          // [stages][g_cap]
    int32_t* gid_s = reinterpret_cast<int32_t*>(smem_bytes + L.gid);  // [stages][TILE]
    float* tab_s = reinterpret_cast<float*>(smem_bytes + L.tab);      // [stages][g_cap * r_pad]
    float* scan_s = reinterpret_cast<float*>(smem_bytes + L.scan);    // [stages][ROWV * TILE]
    const int tab_n = a.g_cap * a.r_pad;
    const int r = threadIdx.x;
    const int grid = gridDim.x;
    int t = blockIdx.x;
    if (t >= a.tiles) return;

    auto stage = [&](int tt, int s) {  // one thread: tile tt's gid and table -> stage s
        mbar_expect(&bar[s], (TILE + tab_n) * 4);
        bulk_copy(gid_s + s * TILE, a.gid + (long long)tt * TILE, TILE * 4, &bar[s]);
        bulk_copy(tab_s + (long long)s * tab_n, a.tab + (long long)tt * tab_n, tab_n * 4,
                  &bar[s]);
    };
    auto limits = [&](int s) {  // each group's entries up to its last of weight > 0
        const float* tab = tab_s + (long long)s * tab_n;
        for (int gi = r; gi < a.g_cap; gi += TILE) {
            const float* w = tab + (long long)gi * a.r_pad + 2 * a.mn_cap;
            int n = a.mn_cap;
            while (n > 0 && !(w[n - 1] > 0.f)) --n;
            lim_s[s * a.g_cap + gi] = n;
        }
    };

    if (r == 0) {
        mbar_init(&bar[0]);
        mbar_init(&bar[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (r == 0) {
        stage(t, 0);
        if (stages == 2 && t + grid < a.tiles) stage(t + grid, 1);
    }
    if (stages == 2) {
        mbar_wait(&bar[0], 0);
        limits(0);
        __syncthreads();
    }

    // the row's streams (distances, pair-start flag, threshold, is_self),
    // loaded a tile ahead into registers
    float d[C], fp, thr, selff;
    auto load_streams = [&](int tt) {
        const float* dt_t = a.dt + (long long)tt * C * TILE + r;
#pragma unroll
        for (int c = 0; c < C; ++c) d[c] = dt_t[c * TILE];
        const float* aux_t = a.aux + (long long)tt * 3 * TILE + r;
        fp = aux_t[0];
        thr = aux_t[TILE];
        selff = aux_t[2 * TILE];
    };
    load_streams(t);
    for (int j = 0; t < a.tiles; ++j, t += grid) {
        const int s = stages == 2 ? (j & 1) : 0;
        const bool next = t + grid < a.tiles;
        if (stages == 1) {  // the table staged after the last tile's barrier
            mbar_wait(&bar[0], j & 1);
            limits(0);
            __syncthreads();
        }
        float v[2 * C];
#pragma unroll
        for (int i = 0; i < 2 * C; ++i) v[i] = 0.f;
        // a slot outside the table selects nothing (the one-hot select's zero
        // row): no terms, no passes, mnhalf 0
        const int gi = gid_s[s * TILE + r];
        float mnhalf = 0.f;
        if (gi >= 0 && gi < a.g_cap) {
            const float* grp = tab_s + (long long)s * tab_n + (long long)gi * a.r_pad;
            const int n = lim_s[s * a.g_cap + gi];
            for (int k = 0; k < n; ++k)
                gauss_entry<C>(d, grp[k], grp[a.mn_cap + k], grp[2 * a.mn_cap + k], v);
            mnhalf = grp[3 * a.mn_cap];
        }
        const float gate = __fsub_rn(1.f, selff);  // fails count on cross pairs only
#pragma unroll
        for (int c = 0; c < C; ++c) v[C + c] = (v[C + c] < mnhalf) ? gate : 0.f;

        float* buf = scan_s + (long long)s * ROWV * TILE;
#pragma unroll
        for (int i = 0; i < 2 * C; ++i) buf[i * TILE + r] = v[i];
        buf[2 * C * TILE + r] = fp;
        const float fp_t = fp, thr_t = thr, selff_t = selff;
        if (next) load_streams(t + grid);  // in flight through the barrier and the scan
        if (stages == 2 && next) {  // tile j+1's table has landed (issued a tile ago)
            mbar_wait(&bar[s ^ 1], ((j + 1) >> 1) & 1);
            limits(s ^ 1);
        }
        __syncthreads();
        if (r == 0 && t + stages * grid < a.tiles) {  // stage s is read: its next tile
            fence_proxy_async();
            stage(t + stages * grid, s);
        }
        scan_rows<2 * C>(v, fp_t, a.depth, buf, r);
        store_pairs<C>(a.out + ((long long)t * TILE + r) * C, v, thr_t, selff_t);
    }
}

// --- P4 ohbf16's second design: K1 with the selection on wgmma --------------

// The selection's shapes at C conformers: each bf16 part of a node table is
// [NPAD, CAP], its 3C coordinate columns padded to a multiple of 8, K-major
// (one column = CAP bf16 = 128 bytes along k); the three parts stand one
// after another, ROWS columns in all. A wgmma chain takes one part (N =
// NPAD): three parts side by side in one chain (N = 48 at C = 4) left
// ptxas unable to allocate within the 64 registers a 1024-thread block
// allows.
template <int C>
struct MmaShape {
    static constexpr int K3 = 3 * C;
    static constexpr int NPAD = (K3 + 7) / 8 * 8;
    static constexpr int NT = NPAD / 8;  // n8 tiles of one part
    static constexpr int ROWS = 3 * NPAD;
};

// x's exact three-way bf16 split (split_bf16's arithmetic), as bits.
__device__ __forceinline__ void split3_bf16(float x, uint32_t (&p)[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const __nv_bfloat16 b = __float2bfloat16_rz(x);
        p[k] = __bfloat16_as_ushort(b);
        x = __fsub_rn(x, __bfloat162float(b));
    }
}

// Byte offset of bf16 (column n, slot k) of a K-major operand with the
// 128-byte swizzle: 128 bytes per column, the 16-byte chunk k / 8 XORed
// with n % 8 (the address bits [4, 7) with [7, 10) of a 1024-byte aligned
// base, as the wgmma descriptor's layout type 1 reads them).
__device__ __forceinline__ int sw128_offset(int n, int k) {
    return n * 128 + ((((k >> 3) ^ n) & 7) << 4) + (k & 7) * 2;
}

// The wgmma descriptor of that operand at `p` (1024-byte aligned): start
// address >> 4, LBO 1 (unused by a swizzled K-major operand), SBO 1024
// bytes between 8-column groups, layout type 1 (128-byte swizzle). A k step
// of 16 bf16 adds 32 bytes (2) to the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from reading the accumulators before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// d += A · B: one wgmma m64nNk16, A the warpgroup's [64, 16] bf16 one-hot
// from registers (each warp its 16 rows, mma.sync's A fragment), B the
// [16, N] operand of `desc`, d the f32 accumulator (mma.sync's C fragment
// per n8 tile). scale-d is always 1: the chains zero d first. (With d left
// uninitialised and scale-d 0 on a chain's first step, the H100 returned
// the previous chain's results in d: the other side's positions.)
template <int N>
struct WgmmaBf16;

template <>
struct WgmmaBf16<8> {
    static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                               uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
            : "memory");
    }
};

template <>
struct WgmmaBf16<16> {
    static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7}, "
            "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
            : "memory");
    }
};

template <>
struct WgmmaBf16<24> {
    static __device__ __forceinline__ void run(float (&d)[12], const uint32_t (&a)[4],
                                               uint64_t desc) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7,"
            " %8, %9, %10, %11}, "
            "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
            : "memory");
    }
};

// sqrt((dx²+dy²)+dz²), distance3's arithmetic on differences already formed.
__device__ __forceinline__ float norm3(float dx, float dy, float dz) {
    return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz)));
}

// Where the warp stages difference (row rho of a 16-row half, column col):
// in the warp's own rows of a scan buffer (float `chunk` * TILE + lane,
// 2C + 1 chunks of 32), column pairs per chunk, rotated by 8 lanes per
// chunk so that the 32 lanes of an accumulator store hit 32 banks and the
// 16 lanes that read a column hit 16.
__device__ __forceinline__ int stage_slot(int rho, int col) {
    const int chunk = col >> 1;
    return chunk * TILE + ((((col & 1) << 4) + rho + 8 * (chunk & 3)) & 31);
}

// Conformer distances of the warp's 32 rows from the tile's three bf16
// parts (`parts`, MmaShape's layout). Per 16-row half h (the warp's slice
// of its warpgroup's 64-row M-tile), side (u, then w) and part: the
// unsigned one-hot of the rows' slots (built in registers once per half,
// side and k step, for all three parts) times the part over 4 k steps of
// 16 slots; its only nonzero product is
// part * 1, so every column is the part exactly (an 8-bit value no
// accumulator rounds). The parts are summed (hi + mid) + lo with
// __fadd_rn, which is x exactly; dx = pos_u - pos_w with __fsub_rn in the
// accumulator layout; the half's 3C differences per row are staged in
// `stage` (stage_slot) and the row's own thread forms sqrt((dx²+dy²)+dz²).
// Every row's distances are K1's, bit for bit.
template <int C>
__device__ __forceinline__ void mma_select_distances(const uint16_t* parts, int32_t uvp,
                                                     float* stage, int lane, float (&d)[C]) {
    using S = MmaShape<C>;
    constexpr int NT = S::NT;
    const int g = lane >> 2, q = lane & 3;
    const uint64_t desc = sw128_desc(parts);
    const int node[2] = {uvp / CAP, uvp % CAP};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float x[NT][4];  // side u's positions, then the differences
#pragma unroll
        for (int side = 0; side < 2; ++side) {
            const int ia = __shfl_sync(FULL_MASK, node[side], 16 * h + g);
            const int ib = __shfl_sync(FULL_MASK, node[side], 16 * h + g + 8);
            float pos[NT][4];
            uint32_t a[CAP / 16][4];
#pragma unroll
            for (int ks = 0; ks < CAP / 16; ++ks) {
                const int k = 16 * ks + 2 * q;
                a[ks][0] = onehot_pair(ia, k);
                a[ks][1] = onehot_pair(ib, k);
                a[ks][2] = onehot_pair(ia, k + 8);
                a[ks][3] = onehot_pair(ib, k + 8);
            }
#pragma unroll
            for (int part = 0; part < 3; ++part) {
                float acc[4 * NT];
#pragma unroll
                for (int i = 0; i < 4 * NT; ++i) acc[i] = 0.f;
                wgmma_fence();
#pragma unroll
                for (int ks = 0; ks < CAP / 16; ++ks)
                    WgmmaBf16<S::NPAD>::run(acc, a[ks], desc + part * S::NPAD * 8 + 2 * ks);
                wgmma_commit_wait();
                fence_regs(acc);
                // acc[4 nt + e]: row g (+8 for e >= 2) of the half, column
                // 8 nt + 2q + (e & 1)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        pos[nt][e] = part == 0 ? acc[4 * nt + e] : __fadd_rn(pos[nt][e], acc[4 * nt + e]);
                }
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    x[nt][e] = side == 0 ? pos[nt][e] : __fsub_rn(x[nt][e], pos[nt][e]);
            }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = 8 * nt + 2 * q + (e & 1);
                if (col < S::K3) stage[stage_slot(g + 8 * (e >> 1), col)] = x[nt][e];
            }
        }
        __syncwarp();
        if ((lane >> 4) == h) {
            const int rho = lane & 15;
#pragma unroll
            for (int c = 0; c < C; ++c)
                d[c] = norm3(stage[stage_slot(rho, 3 * c)], stage[stage_slot(rho, 3 * c + 1)],
                             stage[stage_slot(rho, 3 * c + 2)]);
        }
        __syncwarp();  // read before the next half, or the warp's scan rows, overwrite them
    }
}

// K1's arguments, and the optional [T, C, TILE] distances out.
struct FusedStreamMmaArgs {
    FusedStreamArgs k1;
    float* dist;
};

// Its shared memory: K1's, with each stage's interleaved node table
// replaced by the three bf16 parts (first, 1024-byte aligned for the
// swizzle; a stage is a whole number of 1024-byte atoms).
template <int C>
struct FusedStreamMmaSmem {
    static constexpr int NODE = 3 * C * CAP;
    static constexpr int ROWV = 2 * C + 1;
    uint16_t parts[2][MmaShape<C>::ROWS * CAP];
    uint64_t bar[2];
    int32_t uv[2][TILE];
    float raw[2][NODE];
    float scan1[ROWV * TILE];
    float scan2[ROWV * TILE];
};

// The dynamic shared memory a block asks for: the layout plus the slack to
// round its base up to 1024 bytes.
template <int C>
__host__ __device__ constexpr int fused_stream_mma_smem() {
    return (int)sizeof(FusedStreamMmaSmem<C>) + 1024;
}

// P4 ohbf16, the second design: K1 (fused_stream_kernel) with the node
// selection on wgmma (mma_select_distances). Where K1 interleaves a landed
// node table, the block splits it into the three bf16 parts, written in
// the swizzled layout the B descriptor reads and double-buffered like K1's
// tables, then fences them into the async proxy before the barrier that
// precedes their first wgmma. Each warp stages its differences in its own
// rows of scan1: no other warp reads or writes them between the barrier
// after tile j's first scan and the next tile's first barrier, and the
// warp writes its next scan rows only after its selection has read them.
template <int C>
__global__ void __launch_bounds__(TILE, 1) fused_stream_mma_kernel(FusedStreamMmaArgs args) {
    using Smem = FusedStreamMmaSmem<C>;
    using S = MmaShape<C>;
    constexpr int NODE = Smem::NODE;
    const FusedStreamArgs& a = args.k1;
    extern __shared__ __align__(16) unsigned char smem_bytes[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_bytes + ((1024u - (smem_u32(smem_bytes) & 1023u)) & 1023u));
    const int r = threadIdx.x;
    const int lane = r & 31;
    const int grid = gridDim.x;
    int t = blockIdx.x;
    if (t >= a.tiles) return;

    auto stage = [&](int tt, int s) {  // one thread: tile tt's tables -> stage s
        mbar_expect(&sm.bar[s], (TILE + NODE) * 4);
        bulk_copy(sm.uv[s], a.uv + (long long)tt * TILE, TILE * 4, &sm.bar[s]);
        bulk_copy(sm.raw[s], a.pos + (long long)tt * NODE, NODE * 4, &sm.bar[s]);
    };
    auto split = [&](int s) {  // the block: raw [3C, CAP] -> parts[s], then the fence
        unsigned char* dst = reinterpret_cast<unsigned char*>(sm.parts[s]);
        for (int i = r; i < NODE / 2; i += TILE) {  // slots k, k + 1 of column n
            const int n = i / (CAP / 2), k = 2 * (i % (CAP / 2));
            const float2 x = reinterpret_cast<const float2*>(sm.raw[s])[i];
            uint32_t p0[3], p1[3];
            split3_bf16(x.x, p0);
            split3_bf16(x.y, p1);
#pragma unroll
            for (int part = 0; part < 3; ++part)
                *reinterpret_cast<uint32_t*>(dst + sw128_offset(part * S::NPAD + n, k)) =
                    p0[part] | (p1[part] << 16);
        }
        fence_proxy_async();
    };

    if (r == 0) {
        mbar_init(&sm.bar[0]);
        mbar_init(&sm.bar[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the padding columns [3C, NPAD) of every part and stage hold zeros
    constexpr int PADW = (S::NPAD - S::K3) * CAP / 2;  // 32-bit words per part
    if constexpr (PADW > 0) {
        for (int i = r; i < 2 * 3 * PADW; i += TILE) {
            const int sp = i / PADW, w = i % PADW;  // (stage, part), word
            reinterpret_cast<uint32_t*>(sm.parts[sp / 3])[((sp % 3) * S::NPAD + S::K3) * CAP / 2 + w] = 0u;
        }
    }
    __syncthreads();
    if (r == 0) {
        stage(t, 0);
        if (t + grid < a.tiles) stage(t + grid, 1);
    }
    mbar_wait(&sm.bar[0], 0);
    split(0);
    __syncthreads();

    for (int j = 0; t < a.tiles; ++j, t += grid) {
        const int s = j & 1;
        const bool next = t + grid < a.tiles;
        // selection on the tensor cores, staged in the warp's rows of scan1
        float d[C];
        mma_select_distances<C>(sm.parts[s], sm.uv[s][r], sm.scan1 + (r & ~31), lane, d);
        if (args.dist != nullptr) {
#pragma unroll
            for (int c = 0; c < C; ++c) args.dist[((long long)t * C + c) * TILE + r] = d[c];
        }
        // from here on K1's loop: the Gaussian tables, coalesced
        const float* g = a.gtab + (long long)t * 3 * P * TILE + r;
        float v[2 * C];
#pragma unroll
        for (int i = 0; i < 2 * C; ++i) v[i] = 0.f;
#pragma unroll 4
        for (int p = 0; p < P; ++p)
            gauss_entry<C>(d, g[p * TILE], g[(P + p) * TILE], g[(2 * P + p) * TILE], v);
        const float* ax = a.aux + (long long)t * 7 * TILE + r;
        const float fb = ax[0], fp = ax[TILE];
        const float mninv = ax[2 * TILE], mnhalf = ax[3 * TILE], gate = ax[4 * TILE];
        const float thr = ax[5 * TILE], selff = ax[6 * TILE];

        // sub -> block: scores and pass counts scan together
#pragma unroll
        for (int i = 0; i < 2 * C; ++i) sm.scan1[i * TILE + r] = v[i];
        sm.scan1[2 * C * TILE + r] = fb;
        if (next) {  // tile j+1's tables have landed (issued a tile ago)
            mbar_wait(&sm.bar[s ^ 1], ((j + 1) >> 1) & 1);
            split(s ^ 1);
        }
        __syncthreads();
        if (r == 0 && t + 2 * grid < a.tiles) {  // stage s is read: tile j+2's tables
            fence_proxy_async();
            stage(t + 2 * grid, s);
        }
        scan_rows<2 * C>(v, fb, a.depth1, sm.scan1, r);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            v[c] = __fmul_rn(v[c], mninv);                 // block score
            v[C + c] = (v[C + c] < mnhalf) ? gate : 0.f;   // block fail
        }
        // block -> pair: [block_score; block_fail] scan together
#pragma unroll
        for (int i = 0; i < 2 * C; ++i) sm.scan2[i * TILE + r] = v[i];
        sm.scan2[2 * C * TILE + r] = fp;
        __syncthreads();
        scan_rows<2 * C>(v, fp, a.depth2, sm.scan2, r);
        store_pairs<C>(a.out + ((long long)t * TILE + r) * C, v, thr, selff);
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

// The persistent grid: the SMs times the blocks of `kernel` that fit on one
// at `smem` bytes of dynamic shared memory.
template <typename K>
int resident_blocks(K kernel, int smem, int& blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TILE, smem);
    blocks = sms * per_sm;
    if (e != cudaSuccess) return (int)e;
    return blocks > 0 ? 0 : -3;
}

template <int C>
int launch_fused_stream_c(const FusedStreamArgs& a, cudaStream_t stream) {
    constexpr int smem = (int)sizeof(FusedStreamSmem<C>);
    static_assert(smem <= MAX_SMEM, "block shared memory");
    if (a.tiles <= 0) return 0;
    static bool configured = false;
    if (const int e = allow_smem(fused_stream_kernel<C>, configured)) return e;
    int blocks = 0;
    if (const int e = resident_blocks(fused_stream_kernel<C>, smem, blocks)) return e;
    fused_stream_kernel<C><<<a.tiles < blocks ? a.tiles : blocks, TILE, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int C>
int launch_fused_stream_mma_c(const FusedStreamMmaArgs& a, cudaStream_t stream) {
    constexpr int smem = fused_stream_mma_smem<C>();
    static_assert(smem <= MAX_SMEM, "block shared memory");
    if (a.k1.tiles <= 0) return 0;
    static bool configured = false;
    if (const int e = allow_smem(fused_stream_mma_kernel<C>, configured)) return e;
    int blocks = 0;
    if (const int e = resident_blocks(fused_stream_mma_kernel<C>, smem, blocks)) return e;
    fused_stream_mma_kernel<C><<<a.k1.tiles < blocks ? a.k1.tiles : blocks, TILE, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// K2's table buffers for a [g_cap, r_pad] table: 2 when the double buffers
// fit a block's shared memory, 1 when single ones do, 0 when neither.
inline int v3_stages(int c, int g_cap, int r_pad) {
    for (int stages = 2; stages >= 1; --stages)
        if (v3_layout(c, g_cap, r_pad, stages).total <= MAX_SMEM) return stages;
    return 0;
}

template <int C>
int launch_v3_stream_c(V3StreamArgs a, cudaStream_t stream) {
    a.stages = v3_stages(C, a.g_cap, a.r_pad);
    if (a.stages == 0) return -2;
    if ((long long)a.g_cap * a.r_pad % 4 != 0) return -4;  // TMA moves 16-byte units
    if (a.tiles <= 0) return 0;
    const int smem = (int)v3_layout(C, a.g_cap, a.r_pad, a.stages).total;
    static bool configured = false;
    if (const int e = allow_smem(v3_stream_kernel<C>, configured)) return e;
    int blocks = 0;
    if (const int e = resident_blocks(v3_stream_kernel<C>, smem, blocks)) return e;
    v3_stream_kernel<C><<<a.tiles < blocks ? a.tiles : blocks, TILE, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// Registers and local (spill) bytes per thread, dynamic shared memory per
// block and blocks per SM of `kernel` at `smem` bytes, into out[0..3].
template <typename K>
int kernel_resources(K kernel, long long smem, int* out) {
    if (smem > MAX_SMEM) return -2;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    cudaFuncAttributes fa{};
    int per_sm = 0;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TILE, (int)smem);
    if (e != cudaSuccess) return (int)e;
    out[0] = fa.numRegs;
    out[1] = (int)fa.localSizeBytes;
    out[2] = (int)smem;
    out[3] = per_sm;
    return 0;
}

template <int C>
int resources_c(int kernel, int g_cap, int r_pad, int* out) {
    switch (kernel) {
        case 0:
            return kernel_resources(fused_stream_kernel<C>, sizeof(FusedStreamSmem<C>), out);
        case 1:
            return kernel_resources(screen_tile_kernel<C, FUSED, 0>,
                                    sizeof(float) * smem_floats<C, FUSED, 0>(), out);
        case 2: {
            const int stages = v3_stages(C, g_cap, r_pad);
            if (stages == 0) return -2;
            return kernel_resources(v3_stream_kernel<C>,
                                    v3_layout(C, g_cap, r_pad, stages).total, out);
        }
        case 3:
            return kernel_resources(v3_tile_kernel<C>,
                                    4LL * ((long long)g_cap * r_pad + (2 * C + 1) * TILE), out);
        case 4:
            return kernel_resources(fused_stream_mma_kernel<C>, fused_stream_mma_smem<C>(), out);
        case 5:
            return kernel_resources(screen_tile_kernel<C, FUSED_MMA, 0>,
                                    sizeof(float) * smem_floats<C, FUSED_MMA, 0>(), out);
        default:
            return -1;
    }
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
    const FusedStreamArgs a{pos, uv, gtab, aux, out, tiles, depth1, depth2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(C) launch_fused_stream_c<C>(a, s)
    DISPATCH_C(c, CALL)
#undef CALL
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
// and the scan buffers do not fit a block's shared memory, -4 when a tile's
// table is not a whole number of 16-byte units.
int screen_tiles_v3(const float* dt, const int32_t* gid, const float* tab,
                    const float* aux, float* out, int tiles, int c, int g_cap,
                    int r_pad, int mn_cap, int depth, void* stream) {
    const V3StreamArgs a{dt, gid, tab, aux, out, tiles, g_cap, r_pad, mn_cap, depth, 0};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(C) launch_v3_stream_c<C>(a, s)
    DISPATCH_C(c, CALL)
#undef CALL
}

// K2's first design (v3_tile_kernel), which K2 is held to bit for bit: the
// same arguments and output. Returns -2 when its table and scan buffers do
// not fit a block's shared memory.
int screen_tiles_v3_baseline(const float* dt, const int32_t* gid, const float* tab,
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
// K1 (fused_stream_kernel), 2 ohbf16 K1 with the selection on wgmma
// (fused_stream_mma_kernel), which also writes its distances to dist
// [T, C, TILE] when dist is not null.
int screen_tiles_fused_variant(const float* pos, const int32_t* uv, const float* gtab,
                               const float* aux, float* out, float* dist, int tiles, int c,
                               int depth1, int depth2, int variant, void* stream) {
    const FusedStreamArgs k1{pos, uv, gtab, aux, out, tiles, depth1, depth2};
    const FusedStreamMmaArgs mma{k1, dist};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (variant) {
        case 0:
        case 1: {
            if (dist) return -1;
#define CALL(C) launch_fused_stream_c<C>(k1, s)
            DISPATCH_C(c, CALL)
#undef CALL
        }
        case 2: {
#define CALL(C) launch_fused_stream_mma_c<C>(mma, s)
            DISPATCH_C(c, CALL)
#undef CALL
        }
        default: return -1;
    }
}

// P4 ohbf16's first design (screen_tile_kernel<C, FUSED_MMA>: one block per
// tile, the selection on mma.sync), which the second is held to bit for
// bit: K1's inputs and output, and the distances to dist when not null.
int screen_tiles_ohbf16_baseline(const float* pos, const int32_t* uv, const float* gtab,
                                 const float* aux, float* out, float* dist, int tiles, int c,
                                 int depth1, int depth2, void* stream) {
    TileArgs a = tile_major_args(pos, uv, gtab, aux, out, c, depth1, depth2);
    a.dist = dist;
    return launch<FUSED_MMA>(a, tiles, c, stream);
}

int screen_max_smem() { return MAX_SMEM; }

// Resources of K1 and K2 (kernel 0 K1, 1 K1's first design, 2 K2, 3 K2's
// first design) and of P4 ohbf16 (4 its second design, 5 its first) at c
// conformers, K2 at a [g_cap, r_pad] table: out[0..3] =
// registers per thread, local (spill) bytes per thread, dynamic shared
// memory per block, blocks per SM. Returns -1 for another kernel or c, -2
// when the table does not fit.
int screen_kernel_resources(int kernel, int c, int g_cap, int r_pad, int* out) {
#define CALL(C) resources_c<C>(kernel, g_cap, r_pad, out)
    DISPATCH_C(c, CALL)
#undef CALL
}

}  // extern "C"
