// K6: atom -> voxel-grid rasterization for pocket modeling, hand-written for
// Hopper (sm_90a).
//
// Replaces pharmaconet_tpu/ops/voxelize_pallas.py `voxelize_pallas`
// (pallas_call at :145, body `_kernel` at :33). Same function as the plain
// torch version in ops/voxelize.py: per voxel, over the valid atoms,
//   d2  = (dx*dx + dy*dy) + dz*dz          (exact f32, the JAX order)
//   img += exp(-d2 * inv2s2) * feats[atom]  where d2 <= fr2   (33 channels)
//   occ |= d2 <= mr2
// with the voxel centre origin + (float)i * res and origin = center - half
// in f32. Built with -fmad=false and no fast math, and every step of the
// distance is an explicitly rounded intrinsic, so the decisions d2 <= fr2
// and d2 <= mr2, and with them the occupancy, are bit-equal to the plain
// version. The image sums atoms in ascending order (the plain version sums
// them in a matrix product), so it agrees within float rounding.
//
// What bounds it on this card: bytes. The [64^3, 33] f32 image alone is
// 34.6 MB; the useful arithmetic (about 123 voxels per atom within 1.5 A,
// ~76 operations each) is far below what the SMs do in that time.
//
// Design (not the TPU's): the TPU kernel pads channels to 128 lanes and
// runs a dense voxel x atom product through the MXU. Here one block owns a
// BRICK^3 brick of voxels, one thread per voxel. The block culls the atom
// list to the atoms within the brick's box grown by the larger radius
// (plus a margin far above f32 rounding), compacting them into shared
// memory in ascending atom order with a ballot scan; whenever the staged
// list could overflow, the block consumes it and starts again. Each
// thread keeps its 33 channel sums in registers and writes its voxel's
// row of the [D,H,W,C] image once. This first design stays launchable
// (`voxelize_launch`, `voxelize_cuda.voxelize_pallas_baseline`) as the
// baseline the second is held to bit for bit.
//
// Second design (`voxelize_binned_launch`, the one the port runs), for what
// held the first back: every brick culled all atoms (512 blocks x 4096
// atoms read from L2, two barriers and a serial prefix per 512), every
// thread stored its own 132-byte row (32 sectors per warp store), and dense
// bricks kept 33 accumulators per thread through the whole cull.
//  * Phase 1, `voxelize_bin_kernel`, one block per x column of the grid:
//    one ordered ballot compaction of the valid atoms whose x lies in the
//    column's window [vx - cull, vx + cull], into that column's list
//    (float4: x, y, z, atom index; ascending atom order; room for every
//    atom, so it cannot overflow).
//  * Phase 2, `voxelize_tile_kernel`, one block per output tile: TILE_VOX
//    voxels = rows of one x slab (every z up to TILE_VOX), so a tile's
//    image is one contiguous span of the [D,H,W,C] layout (16,896 bytes).
//    The block stages the column list in shared memory in rounds of STAGE
//    entries (a longer list takes more rounds). Each warp owns 32
//    consecutive voxels; it culls each round to its own y/z box with a
//    ballot and walks its candidates in ascending order. For a candidate
//    within the feature radius of some of its voxels, the warp holds the
//    atom's 33 features (lane c: channel c) and adds r * f to each such
//    voxel's row of the tile image in shared memory: two lane-parallel
//    adds per hit instead of 33 serial ones. A row's address is only ever
//    touched by the lane of its channel, so no barrier is needed between
//    hits. Then the tile's image leaves in coalesced 16-byte stores and its
//    occupancy in 32-byte warp stores. Small tiles keep 8 blocks on an SM,
//    so one block's stores overlap the others' culls. Phase 2 is a
//    programmatic dependent launch: it zeroes its images while phase 1
//    ends.
//  * Exactness: each voxel adds its contributions in ascending atom order,
//    acc = __fadd_rn(acc, __fmul_rn(r, f)) from 0, with r and d2 computed
//    as in the first design, so the image is bit-equal to the first
//    design's and the occupancy to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#define BRICK 8
#define THREADS (BRICK * BRICK * BRICK)
#define CAP 1024  // culled atoms staged in shared memory per round
#define NCH 33    // feature channels (the protein point cloud's)

struct __align__(16) StagedAtom {
  float x, y, z;
  int index;
};

__global__ void __launch_bounds__(THREADS)
voxelize_kernel(const float* __restrict__ pos,             // [A, 3]
                const float* __restrict__ feats,           // [A, NCH]
                const unsigned char* __restrict__ valid,   // [A] bool
                const float* __restrict__ center,          // [3]
                float* __restrict__ image,                 // [dim^3, NCH]
                unsigned char* __restrict__ occ,           // [dim^3] bool
                int n_atoms, int dim, float res, float half, float fr2, float mr2,
                float inv2s2, float cull) {
  __shared__ StagedAtom list[CAP];
  __shared__ int warp_counts[THREADS / 32];

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int x0 = blockIdx.x * BRICK, y0 = blockIdx.y * BRICK, z0 = blockIdx.z * BRICK;
  const int ix = x0 + t / (BRICK * BRICK);
  const int iy = y0 + (t / BRICK) % BRICK;
  const int iz = z0 + t % BRICK;
  const bool inside = ix < dim && iy < dim && iz < dim;

  const float ox = __fsub_rn(center[0], half);
  const float oy = __fsub_rn(center[1], half);
  const float oz = __fsub_rn(center[2], half);
  const float vx = __fadd_rn(ox, __fmul_rn((float)ix, res));
  const float vy = __fadd_rn(oy, __fmul_rn((float)iy, res));
  const float vz = __fadd_rn(oz, __fmul_rn((float)iz, res));

  // the brick's box of voxel centres (clipped to the grid), grown by `cull`
  const int x1 = min(x0 + BRICK, dim) - 1, y1 = min(y0 + BRICK, dim) - 1,
            z1 = min(z0 + BRICK, dim) - 1;
  const float lox = __fadd_rn(ox, __fmul_rn((float)x0, res)) - cull;
  const float hix = __fadd_rn(ox, __fmul_rn((float)x1, res)) + cull;
  const float loy = __fadd_rn(oy, __fmul_rn((float)y0, res)) - cull;
  const float hiy = __fadd_rn(oy, __fmul_rn((float)y1, res)) + cull;
  const float loz = __fadd_rn(oz, __fmul_rn((float)z0, res)) - cull;
  const float hiz = __fadd_rn(oz, __fmul_rn((float)z1, res)) + cull;

  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
  bool hit = false;
  int count = 0;  // staged atoms; the same value in every thread

  for (int base = 0; base < n_atoms; base += THREADS) {
    const int a = base + t;
    bool keep = false;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (a < n_atoms && valid[a]) {
      px = pos[3 * a];
      py = pos[3 * a + 1];
      pz = pos[3 * a + 2];
      keep = px >= lox && px <= hix && py >= loy && py <= hiy && pz >= loz && pz <= hiz;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_counts[warp] = __popc(mask);
    __syncthreads();
    int offset = count, total = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      const int n = warp_counts[w];
      offset += w < warp ? n : 0;
      total += n;
    }
    if (keep) {
      StagedAtom s;
      s.x = px;
      s.y = py;
      s.z = pz;
      s.index = a;
      list[offset + __popc(mask & ((1u << lane) - 1u))] = s;
    }
    __syncthreads();
    count += total;

    if (count > CAP - THREADS || base + THREADS >= n_atoms) {
      for (int j = 0; j < count; ++j) {
        const StagedAtom s = list[j];
        const float dx = __fsub_rn(vx, s.x);
        const float dy = __fsub_rn(vy, s.y);
        const float dz = __fsub_rn(vz, s.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        hit = hit || d2 <= mr2;
        if (d2 <= fr2) {
          const float r = expf(__fmul_rn(-d2, inv2s2));
          const float* f = feats + (size_t)s.index * NCH;
#pragma unroll
          for (int c = 0; c < NCH; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(r, __ldg(f + c)));
        }
      }
      __syncthreads();  // the list is refilled from slot 0
      count = 0;
    }
  }

  if (inside) {
    const size_t flat = ((size_t)ix * dim + iy) * dim + iz;
    float* out = image + flat * NCH;
#pragma unroll
    for (int c = 0; c < NCH; ++c) out[c] = acc[c];
    occ[flat] = hit ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// Second design (see the header): phase 1 bins the atoms by x column,
// phase 2 rasterizes one contiguous tile per block.
// ---------------------------------------------------------------------------
#define FULL_MASK 0xffffffffu
#define BIN_THREADS 1024
#define BIN_ROUNDS 4  // atoms per lane held in registers per chunk of phase 1
#define TILE_VOX 128  // voxels per tile, one thread each
#define STAGE 256     // column-list entries staged in shared memory per round
#define TILE_FLOATS (TILE_VOX * NCH)       // the staged tile image
#define TILE_SMEM (TILE_FLOATS * 4 + STAGE * 16)
#define TILE_MIN_BLOCKS (1024 / TILE_VOX)  // 64 registers a thread

static_assert(NCH > 32 && NCH <= 64, "lane c holds channels c and 32 + c");
static_assert(TILE_VOX % 32 == 0 && TILE_FLOATS % 4 == 0, "whole warps and float4s");

// Programmatic dependent launch (sm_90): phase 1 lets phase 2 start its
// prologue early; phase 2 waits for phase 1's results before reading them.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__global__ void __launch_bounds__(BIN_THREADS)
voxelize_bin_kernel(const float* __restrict__ pos,            // [A, 3]
                    const unsigned char* __restrict__ valid,  // [A] bool
                    const float* __restrict__ center,         // [3]
                    float4* __restrict__ lists,               // [dim, A] (x, y, z, index)
                    int* __restrict__ counts,                 // [dim]
                    int n_atoms, float res, float half, float cull) {
  __shared__ int warp_counts[BIN_THREADS / 32];
  launch_dependents();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ix = blockIdx.x;
  const float vx = __fadd_rn(__fsub_rn(center[0], half), __fmul_rn((float)ix, res));
  const float lo = vx - cull, hi = vx + cull;
  float4* out = lists + (size_t)ix * n_atoms;

  int done = 0;  // entries written by earlier chunks
  for (int c0 = 0; c0 < n_atoms; c0 += BIN_THREADS * BIN_ROUNDS) {
    // warp w holds atoms c0 + w*32*BIN_ROUNDS + r*32 + lane in registers,
    // every load issued before the first is used
    const int wa = c0 + warp * 32 * BIN_ROUNDS + lane;
    float x[BIN_ROUNDS], y[BIN_ROUNDS], z[BIN_ROUNDS];
    bool ok[BIN_ROUNDS];
#pragma unroll
    for (int r = 0; r < BIN_ROUNDS; ++r) {
      const int a = min(wa + 32 * r, n_atoms - 1);
      x[r] = pos[3 * a];
      y[r] = pos[3 * a + 1];
      z[r] = pos[3 * a + 2];
      ok[r] = valid[a] != 0;
    }
    unsigned mask[BIN_ROUNDS];
    int n = 0;
#pragma unroll
    for (int r = 0; r < BIN_ROUNDS; ++r) {
      const bool keep = wa + 32 * r < n_atoms && ok[r] && x[r] >= lo && x[r] <= hi;
      mask[r] = __ballot_sync(FULL_MASK, keep);
      n += __popc(mask[r]);
    }
    if (lane == 0) warp_counts[warp] = n;
    __syncthreads();
    int offset = done, total = 0;
    for (int w = 0; w < BIN_THREADS / 32; ++w) {
      const int c = warp_counts[w];
      offset += w < warp ? c : 0;
      total += c;
    }
#pragma unroll
    for (int r = 0; r < BIN_ROUNDS; ++r) {
      if (mask[r] >> lane & 1u)
        out[offset + __popc(mask[r] & ((1u << lane) - 1u))] =
            make_float4(x[r], y[r], z[r], __int_as_float(wa + 32 * r));
      offset += __popc(mask[r]);
    }
    done += total;
    __syncthreads();  // warp_counts is rewritten by the next chunk
  }
  if (threadIdx.x == 0) counts[ix] = done;
}

// The tiles: `rows` y rows of `zlen` z voxels each (zlen = dim up to
// TILE_VOX, else rows = 1 and the z rows are cut into segments), so a
// tile's voxels are one contiguous span of the [D,H,W] order.
struct Tiling {
  int rows, tiles_y, zlen, tiles_z;
};

static Tiling tiling(int dim) {
  Tiling t;
  t.zlen = dim < TILE_VOX ? dim : TILE_VOX;
  t.tiles_z = (dim + t.zlen - 1) / t.zlen;
  t.rows = TILE_VOX / t.zlen;
  t.tiles_y = (dim + t.rows - 1) / t.rows;
  return t;
}

__global__ void __launch_bounds__(TILE_VOX, TILE_MIN_BLOCKS)
voxelize_tile_kernel(const float4* __restrict__ lists,      // [dim, A] from phase 1
                     const int* __restrict__ counts,        // [dim]
                     const float* __restrict__ feats,       // [A, NCH]
                     const float* __restrict__ center,      // [3]
                     float* __restrict__ image,             // [dim^3, NCH]
                     unsigned char* __restrict__ occ,       // [dim^3] bool
                     Tiling tl, int n_atoms, int dim, float res, float half, float fr2,
                     float mr2, float inv2s2, float cull) {
  extern __shared__ float4 smem4[];  // [TILE_FLOATS / 4] image, then [STAGE] list
  float* img = reinterpret_cast<float*>(smem4);
  float4* stage = smem4 + TILE_FLOATS / 4;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ix = blockIdx.z;
  const int iy0 = blockIdx.y * tl.rows, iz0 = blockIdx.x * tl.zlen;
  const int nz = min(tl.zlen, dim - iz0);
  const int nvox = min(tl.rows, dim - iy0) * nz;  // this tile's voxels
  const bool inside = t < nvox;
  // t / nz = t / zlen for every voxel: a z segment shorter than zlen is a
  // tile of one row
  const int ly = t / tl.zlen, lz = t - ly * tl.zlen;
  const int iy = iy0 + ly, iz = iz0 + lz;

  // prologue (overlaps phase 1): zero the staged image, place the voxels
  for (int i = t; i < TILE_FLOATS / 4; i += TILE_VOX) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float ox = __fsub_rn(center[0], half);
  const float oy = __fsub_rn(center[1], half);
  const float oz = __fsub_rn(center[2], half);
  const float vx = __fadd_rn(ox, __fmul_rn((float)ix, res));
  const float vy = __fadd_rn(oy, __fmul_rn((float)iy, res));
  const float vz = __fadd_rn(oz, __fmul_rn((float)iz, res));

  // the warp's box of voxel centres in y and z, grown by `cull` (x: the
  // column list's window), from its first and last voxel
  const int last = max(min(31, nvox - 1 - warp * 32), 0);
  const bool active = warp * 32 < nvox;
  const int y_lo = __shfl_sync(FULL_MASK, iy, 0), y_hi = __shfl_sync(FULL_MASK, iy, last);
  int z_lo = __shfl_sync(FULL_MASK, iz, 0), z_hi = __shfl_sync(FULL_MASK, iz, last);
  if (y_lo != y_hi) {  // the warp's voxels span rows: every z of the tile
    z_lo = iz0;
    z_hi = iz0 + nz - 1;
  }
  const float loy = __fadd_rn(oy, __fmul_rn((float)y_lo, res)) - cull;
  const float hiy = __fadd_rn(oy, __fmul_rn((float)y_hi, res)) + cull;
  const float loz = __fadd_rn(oz, __fmul_rn((float)z_lo, res)) - cull;
  const float hiz = __fadd_rn(oz, __fmul_rn((float)z_hi, res)) + cull;
  float* rows_of_warp = img + (size_t)warp * 32 * NCH;
  bool hit = false;

  wait_for_prerequisite();  // phase 1's lists and counts are complete
  const float4* list = lists + (size_t)ix * n_atoms;
  const int count = counts[ix];
  // the first round's entries are loaded beside the count, not after it
  for (int i = t; i < min(STAGE, n_atoms); i += TILE_VOX) stage[i] = list[i];
  for (int base = 0; base < count; base += STAGE) {
    const int n = min(STAGE, count - base);
    if (base) {
      __syncthreads();  // every warp is done with the last round
      for (int i = t; i < n; i += TILE_VOX) stage[i] = list[base + i];
    }
    __syncthreads();  // the stage is loaded (the first time: and the image zeroed)
    if (!active) continue;
    for (int j0 = 0; j0 < n; j0 += 32) {
      bool keep = false;
      if (j0 + lane < n) {
        const float4 s = stage[j0 + lane];
        keep = s.y >= loy && s.y <= hiy && s.z >= loz && s.z <= hiz;
      }
      unsigned cand = __ballot_sync(FULL_MASK, keep);
      while (cand) {  // candidates in ascending atom order
        const float4 s = stage[j0 + __ffs(cand) - 1];
        cand &= cand - 1;
        const float dx = __fsub_rn(vx, s.x);
        const float dy = __fsub_rn(vy, s.y);
        const float dz = __fsub_rn(vz, s.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        hit = hit || d2 <= mr2;
        const bool near = inside && d2 <= fr2;
        unsigned hits = __ballot_sync(FULL_MASK, near);
        if (!hits) continue;
        const float r = near ? expf(__fmul_rn(-d2, inv2s2)) : 0.0f;
        const float* f = feats + (size_t)__float_as_int(s.w) * NCH;
        const float f_lo = __ldg(f + lane);
        const float f_hi = lane < NCH - 32 ? __ldg(f + 32 + lane) : 0.0f;
        do {  // each voxel within the radius, one at a time
          const int h = __ffs(hits) - 1;
          hits &= hits - 1;
          const float rh = __shfl_sync(FULL_MASK, r, h);
          float* row = rows_of_warp + h * NCH;
          row[lane] = __fadd_rn(row[lane], __fmul_rn(rh, f_lo));
          if (lane < NCH - 32) row[32 + lane] = __fadd_rn(row[32 + lane], __fmul_rn(rh, f_hi));
        } while (hits);
      }
    }
  }

  const size_t flat0 = ((size_t)ix * dim + iy0) * dim + iz0;
  if (inside) occ[flat0 + t] = hit ? 1 : 0;
  __syncthreads();  // the image is complete (with no atoms: zeroed)
  float* dst = image + flat0 * NCH;
  const int nf = nvox * NCH;
  if (((uintptr_t)dst & 15) == 0 && (nf & 3) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = t; i < nf / 4; i += TILE_VOX) dst4[i] = smem4[i];
  } else {
    for (int i = t; i < nf; i += TILE_VOX) dst[i] = img[i];
  }
}

// Registers and local bytes per thread, shared memory per block and
// resident blocks per SM of `kernel` with `threads` threads and `dynamic`
// bytes of dynamic shared memory, into out[0..3].
template <typename K>
static int resources(K kernel, int threads, int dynamic, int* out) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       dynamic);
  cudaFuncAttributes fa{};
  int per_sm = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, dynamic);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes + dynamic;
  out[3] = per_sm;
  return 0;
}

extern "C" {

int voxelize_channels() { return NCH; }

// Returns the launch's cudaError_t (0 on success).
int voxelize_launch(const void* pos, const void* feats, const void* valid, const void* center,
                    void* image, void* occ, int n_atoms, int dim, float res, float half,
                    float fr2, float mr2, float inv2s2, float cull, void* stream) {
  const int bricks = (dim + BRICK - 1) / BRICK;
  dim3 grid(bricks, bricks, bricks);
  voxelize_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)feats, (const unsigned char*)valid,
      (const float*)center, (float*)image, (unsigned char*)occ, n_atoms, dim, res, half, fr2,
      mr2, inv2s2, cull);
  return (int)cudaGetLastError();
}

// The second design's tiling: TILE_VOX, STAGE into out[0..1].
void voxelize_tiling(int* out) {
  out[0] = TILE_VOX;
  out[1] = STAGE;
}

// Phase 1 on `stream`: `lists` holds dim x n_atoms float4 and `counts`
// dim ints of scratch. Returns the launch's cudaError_t (0 on success).
int voxelize_bin_launch(const void* pos, const void* valid, const void* center, void* lists,
                        void* counts, int n_atoms, int dim, float res, float half, float cull,
                        void* stream) {
  voxelize_bin_kernel<<<dim, BIN_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const unsigned char*)valid, (const float*)center, (float4*)lists,
      (int*)counts, n_atoms, res, half, cull);
  return (int)cudaGetLastError();
}

// Phase 2 on `stream`, as a programmatic dependent launch of what precedes
// it there (it reads `lists` and `counts` only once that has finished).
int voxelize_tile_launch(const void* lists, const void* counts, const void* feats,
                         const void* center, void* image, void* occ, int n_atoms, int dim,
                         float res, float half, float fr2, float mr2, float inv2s2, float cull,
                         void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      voxelize_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const Tiling tl = tiling(dim);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tl.tiles_z, tl.tiles_y, dim);
  cfg.blockDim = dim3(TILE_VOX);
  cfg.dynamicSmemBytes = TILE_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, voxelize_tile_kernel, (const float4*)lists, (const int*)counts, (const float*)feats,
      (const float*)center, (float*)image, (unsigned char*)occ, tl, n_atoms, dim, res, half,
      fr2, mr2, inv2s2, cull);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Phase 1 then phase 2 on `stream`. Returns the first failing launch's
// cudaError_t (0 on success).
int voxelize_binned_launch(const void* pos, const void* feats, const void* valid,
                           const void* center, void* image, void* occ, void* lists,
                           void* counts, int n_atoms, int dim, float res, float half, float fr2,
                           float mr2, float inv2s2, float cull, void* stream) {
  const int rc = voxelize_bin_launch(pos, valid, center, lists, counts, n_atoms, dim, res, half,
                                     cull, stream);
  if (rc != 0) return rc;
  return voxelize_tile_launch(lists, counts, feats, center, image, occ, n_atoms, dim, res, half,
                              fr2, mr2, inv2s2, cull, stream);
}

// Resources of 0: the first design (voxelize_kernel), 1: phase 1
// (voxelize_bin_kernel), 2: phase 2 (voxelize_tile_kernel), into out[0..3]
// (registers, local bytes, shared bytes per block, blocks per SM).
int voxelize_kernel_resources(int kernel, int* out) {
  switch (kernel) {
    case 0: return resources(voxelize_kernel, THREADS, 0, out);
    case 1: return resources(voxelize_bin_kernel, BIN_THREADS, 0, out);
    case 2: return resources(voxelize_tile_kernel, TILE_VOX, TILE_SMEM, out);
    default: return -1;
  }
}

}  // extern "C"
