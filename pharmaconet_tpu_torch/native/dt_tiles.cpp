// Prepack-time conformer distances for tile-store v2.
//
// Computes the [T, C, tile] distance stream that K3 (score_tiles_fused_dt,
// pharmaconet_tpu_torch/csrc/screen_fused.cu) reads, from the packed
// per-tile node-position tables and the uv pair encoding that K1 otherwise
// reads to rebuild the distances on the card. A numpy take_along_axis
// gather of the same values runs at ~0.4 us/element on one host core; this
// loop is a plain sequential gather + 8 flops/row.
//
// Compiled with -ffp-contract=off (see native/__init__.py): no FMA
// contraction, so results are BIT-IDENTICAL to the numpy path in
// scoring/screen_tiles.py (same exact f32 sub/mul/add sequence + IEEE
// sqrtf), which keeps the store contents independent of which
// implementation wrote them.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off dt_tiles.cpp -o libdt_tiles.so

#include <cmath>
#include <cstdint>

extern "C" void tile_dt(
    int64_t t,            // number of tiles
    int32_t c,            // conformers
    int32_t tile,         // rows per tile
    int32_t cap,          // node slots per tile
    const float* pos,     // [t, 3c, cap] conformer-major (plane = 3*k+axis)
    const int32_t* uv,    // [t, tile] u_loc * cap + v_loc
    float* out            // [t, c, tile]
) {
    for (int64_t ti = 0; ti < t; ++ti) {
        const float* p = pos + ti * (int64_t)(3 * c) * cap;
        const int32_t* uvt = uv + ti * (int64_t)tile;
        float* o = out + ti * (int64_t)c * tile;
        for (int32_t r = 0; r < tile; ++r) {
            const int32_t u = uvt[r] / cap;
            const int32_t v = uvt[r] % cap;
            for (int32_t k = 0; k < c; ++k) {
                const float* pk = p + (int64_t)(3 * k) * cap;
                const float dx = pk[u] - pk[v];
                const float dy = pk[cap + u] - pk[cap + v];
                const float dz = pk[2 * cap + u] - pk[2 * cap + v];
                float d2 = dx * dx;
                d2 = d2 + dy * dy;
                d2 = d2 + dz * dz;
                o[(int64_t)k * tile + r] = sqrtf(d2);
            }
        }
    }
}
