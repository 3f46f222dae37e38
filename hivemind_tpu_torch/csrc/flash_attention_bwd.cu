// Flash-attention backward for Hopper (sm_90a): the two passes of the standard
// two-pass scheme, from the forward's saved lse and delta = rowsum(dO * O):
//   dQ pass:    dQ = sum_kv dS K
//   dK/dV pass: dV = sum_q P^T dO,  dK = sum_q dS^T Q
// with P = exp(S*scale - lse) recomputed per tile (S = Q K^T) and
// dS = P * (dO V^T - delta) * scale. Tensors are [B, T, H, D], read through their
// strides; lse and delta are [B, H, T] fp32 contiguous.
//
// Replaces: hivemind_tpu/ops/pallas_attention.py — `_flash_backward`, its two
// `pl.pallas_call`s: the dQ pass (body `_flash_bwd_dq_kernel`) and the dK/dV pass
// (body `_flash_bwd_dkv_kernel`), both built on `_bwd_tile`. The plain PyTorch
// versions and the wrappers are hivemind_tpu_torch/ops/flash_attention.py.
//
// What bounds it: operations. The dQ pass does three products per (query, key)
// pair (S, dP, dQ: 6*D operations), the dK/dV pass four (S, dP, dV, dK: 8*D),
// half of that when causal. At ALBERT's training shape [32, 512, 12, 64] the dK/dV
// pass does 8*32*12*512*512*64 = 5.2e10 operations against ~0.2 GB read and
// written: ~260 operations per byte, near the H100's ~295 bf16 operations per
// byte; at the Llama shape [1, 2048, 32, 128] it is far above. The design keeps
// every score, probability and dS in registers (never in device memory) and feeds
// the tensor cores; the accumulators stay in registers across the whole sweep.
//
// The TPU carried dq_acc and dk_acc/dv_acc in VMEM across sequential grid steps;
// blocks here run in parallel in no order, so each sweep is a loop inside the
// block and its accumulators live in registers in fp32. Two passes and no
// atomics: the result is deterministic. P and dS are rounded to bf16 before their
// products: that rounding is the kernels' main difference from the TPU kernel,
// which multiplied fp32 tiles. Columns past T (and above the diagonal when
// causal) are masked to P = 0 explicitly, so nothing relies on a padded lse.
//
// dK/dV pass, bf16 (building blocks in sm90.cuh):
//  * One thread block per (128 KV rows, batch*head); three warpgroups. Two
//    consumer warpgroups own 64 KV rows each, whose K and V stay resident in
//    shared memory; one warp of the third (the producer) streams 64-row Q and dO
//    tiles through a ring of two stages by TMA, and with plain loads the tile's
//    lse (times log2 e) and delta, which a TMA map on [B*H, T] fp32 could not
//    take for a T that is not a multiple of 4. The producer warpgroup gives its
//    registers to the consumers (setmaxnreg 24 / 240): at D = 128 each consumer
//    thread holds dK and dV (64 + 64 fp32) and S^T, dP^T (32 + 32).
//  * S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with every operand
//    K-major in shared memory; P^T and dS^T come out in the accumulator layout,
//    which is the A-register layout, so they are rounded to bf16 in place.
//  * dV += P^T dO and dK += dS^T Q are wgmma with the A operand from registers
//    and dO, Q read MN-major through the transpose-B flag.
//  * Causal: the query loop starts at the diagonal tile; the mask is evaluated
//    only on the two query tiles that meet the diagonal and on the tile holding T.
//  * P^T = 2^(S^T * D^-1/2 * log2(e) - lse * log2(e)) by ex2.approx.
//  * Later work (not here): the forward's ping-pong of the two consumer
//    warpgroups. It holds P^T and dS^T of one tile beside S^T and dP^T of the
//    next: 224 accumulator and fragment registers at D = 128, of the 240 a
//    consumer thread has.
//
// dQ pass, bf16: one block per (64 query rows, batch*head), 4 warps of 16 rows,
// mma.sync m16n8k16; it loops over 64-row KV tiles staged in shared memory
// (ending at the diagonal tile when causal), 16 keys at a time: the scores of two
// 8-column mma tiles are turned into dS, rounded to bf16 and fed straight to the
// dS K product. Later work (not here): the dK/dV pass's design.
//
// fp32 (no served or trained path uses it on the card; it exists so that fp32
// CUDA tensors differentiate): plain FMAs on the CUDA cores, no TF32. A warp owns
// 4 rows (query rows in the dQ kernel, KV rows in the dK/dV kernel); lane j takes
// column j of a 32-wide tile, and each lane accumulates D/32 output columns from
// the per-column terms broadcast by shuffles.

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace {

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;    // [B, H, T]
    const float* delta;  // [B, H, T]
    void* out0;          // dq, or dk
    void* out1;          // dv (dK/dV pass)
    int batch, seq, heads;
    long long q_sb, q_st, q_sh;
    long long k_sb, k_st, k_sh;
    long long v_sb, v_st, v_sh;
    long long d_sb, d_st, d_sh;
    long long o_sb, o_st, o_sh;  // the outputs' layout (one for all)
    float scale;
    int causal;
};

// ------------------------------------------------------------------ bf16 path

constexpr int kTile = 64;  // rows of every tile (query and KV)
constexpr int kWarps = 4;  // 16 rows per warp
constexpr int kPad = 8;    // bf16 elements of padding per shared-memory row

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* ptr) {
    return *reinterpret_cast<const uint32_t*>(ptr);
}

// Stage rows [row0, row0 + kTile) of one (batch, head) slice into shared memory,
// 16 bytes per access; rows at or past `seq` become zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, long long row_stride,
                                          int row0, int seq) {
    constexpr int kChunksPerRow = D / 8;
    for (int i = threadIdx.x; i < kTile * kChunksPerRow; i += kWarps * 32) {
        const int row = i / kChunksPerRow, chunk = i % kChunksPerRow;
        uint4 value = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + row < seq) {
            value = *reinterpret_cast<const uint4*>(src + (row0 + row) * row_stride + chunk * 8);
        }
        *reinterpret_cast<uint4*>(dst + row * (D + kPad) + chunk * 8) = value;
    }
}

// A-operand fragment of rows [r0, r0 + 16), columns [kk*16, kk*16 + 16) of a tile.
template <int S>
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* tile, int r0, int kk, int g, int t) {
    a[0] = load_pair(tile + (r0 + g) * S + kk * 16 + t * 2);
    a[1] = load_pair(tile + (r0 + g + 8) * S + kk * 16 + t * 2);
    a[2] = load_pair(tile + (r0 + g) * S + kk * 16 + t * 2 + 8);
    a[3] = load_pair(tile + (r0 + g + 8) * S + kk * 16 + t * 2 + 8);
}

// acc[16 x 8] += rows [r0, r0+16) of `a_tile` times rows [n0, n0+8) of `b_tile`
// transposed, over the full head dimension: the A·Bᵀ products (S = Q Kᵀ and friends).
template <int D>
__device__ __forceinline__ void mma_abt(float acc[4], const __nv_bfloat16* a_tile, int r0,
                                        const __nv_bfloat16* b_tile, int n0, int g, int t) {
    constexpr int S = D + kPad;
    acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], b[2];
        load_a<S>(a, a_tile, r0, kk, g, t);
        b[0] = load_pair(b_tile + (n0 + g) * S + kk * 16 + t * 2);
        b[1] = load_pair(b_tile + (n0 + g) * S + kk * 16 + t * 2 + 8);
        mma_bf16_16816(acc, a, b);
    }
}

// acc[n] (16 x D in 8-column tiles) += frag (16 x 16, A layout) times rows
// [k0, k0 + 16) of `tile` (16 x D): the products whose B operand is a tile read
// down its rows (dS K, P^T dO, dS^T Q).
template <int D>
__device__ __forceinline__ void mma_ab(float acc[][4], const uint32_t frag[4], const __nv_bfloat16* tile,
                                       int k0, int g, int t) {
    constexpr int S = D + kPad;
    const uint16_t* u16 = reinterpret_cast<const uint16_t*>(tile);
    const int k_row = k0 + t * 2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + g;
        uint32_t b[2];
        b[0] = uint32_t(u16[k_row * S + col]) | (uint32_t(u16[(k_row + 1) * S + col]) << 16);
        b[1] = uint32_t(u16[(k_row + 8) * S + col]) | (uint32_t(u16[(k_row + 9) * S + col]) << 16);
        mma_bf16_16816(acc[n], frag, b);
    }
}

// Write a warp's 16 x D fp32 accumulator as bf16 rows `row_a` and `row_a + 8`:
// acc[4n + e] holds row row_a + 8*(e >> 1), column 8n + 2t + (e & 1), the layout
// of both an mma.sync m16n8 accumulator and a wgmma m64nD one.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride, const float* acc,
                                           int row_a, int seq, int t) {
    const int row_b = row_a + 8;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + t * 2;
        if (row_a < seq) {
            *reinterpret_cast<__nv_bfloat162*>(base + row_a * row_stride + col) =
                __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
        }
        if (row_b < seq) {
            *reinterpret_cast<__nv_bfloat162*>(base + row_b * row_stride + col) =
                __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dq_bf16(const Params p) {
    constexpr int S = D + kPad;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* do_s = q_s + kTile * S;
    __nv_bfloat16* k_s = do_s + kTile * S;
    __nv_bfloat16* v_s = k_s + kTile * S;

    const int bh = blockIdx.y;
    const int b = bh / p.heads, h = bh % p.heads;
    const int q0 = blockIdx.x * kTile;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;

    const __nv_bfloat16* q_base = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* k_base = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
    const __nv_bfloat16* v_base = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
    const __nv_bfloat16* d_base = static_cast<const __nv_bfloat16*>(p.dout) + b * p.d_sb + h * p.d_sh;
    load_tile<D>(q_s, q_base, p.q_st, q0, p.seq);
    load_tile<D>(do_s, d_base, p.d_st, q0, p.seq);

    const int row_a = q0 + r0 + g, row_b = row_a + 8;  // this thread's two query rows
    const long long rows = static_cast<long long>(bh) * p.seq;
    const float lse_a = row_a < p.seq ? p.lse[rows + row_a] : 0.0f;
    const float lse_b = row_b < p.seq ? p.lse[rows + row_b] : 0.0f;
    const float delta_a = row_a < p.seq ? p.delta[rows + row_a] : 0.0f;
    const float delta_b = row_b < p.seq ? p.delta[rows + row_b] : 0.0f;

    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

    const int kv_end = p.causal ? min(p.seq, q0 + kTile) : p.seq;  // causal: stop at the diagonal tile
    for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
        __syncthreads();  // every warp is done with the previous K/V tile (and Q/dO are staged)
        load_tile<D>(k_s, k_base, p.k_st, kv0, p.seq);
        load_tile<D>(v_s, v_base, p.v_st, kv0, p.seq);
        __syncthreads();

#pragma unroll
        for (int kc = 0; kc < kTile / 16; ++kc) {  // 16 keys at a time
            float ds[2][4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int j = 2 * kc + jj;
                float s[4], dp[4];
                mma_abt<D>(s, q_s, r0, k_s, j * 8, g, t);
                mma_abt<D>(dp, do_s, r0, v_s, j * 8, g, t);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = kv0 + j * 8 + t * 2 + (e & 1);
                    const int row = e < 2 ? row_a : row_b;
                    const bool masked = col >= p.seq || (p.causal && col > row);
                    const float prob = masked ? 0.0f : __expf(s[e] * p.scale - (e < 2 ? lse_a : lse_b));
                    ds[jj][e] = prob * (dp[e] - (e < 2 ? delta_a : delta_b)) * p.scale;
                }
            }
            uint32_t ds_frag[4];
            ds_frag[0] = sm90::pack_bf16(ds[0][0], ds[0][1]);
            ds_frag[1] = sm90::pack_bf16(ds[0][2], ds[0][3]);
            ds_frag[2] = sm90::pack_bf16(ds[1][0], ds[1][1]);
            ds_frag[3] = sm90::pack_bf16(ds[1][2], ds[1][3]);
            mma_ab<D>(acc, ds_frag, k_s, kc * 16, g, t);
        }
    }
    __nv_bfloat16* o_base = static_cast<__nv_bfloat16*>(p.out0) + b * p.o_sb + h * p.o_sh;
    store_rows<D>(o_base, p.o_st, &acc[0][0], row_a, p.seq, t);
}

constexpr int kKvRows = 128;  // KV rows per dK/dV block: two consumer warpgroups of 64
constexpr int kQRows = 64;    // query rows per streamed Q / dO tile
constexpr int kStages = 2;    // depth of the Q / dO ring
constexpr int kConsumerWarps = 8;
constexpr int kThreadsDkv = 384;  // two consumer warpgroups and the producer's
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * 24 + 256 * 240 = 384 * 168

struct DkvParams {
    const float* lse;    // [B, H, T]
    const float* delta;  // [B, H, T]
    void* dk;
    void* dv;
    int seq, heads;
    long long o_sb, o_st, o_sh;  // the layout of dk and dv
    float scale;
    int causal;
};

// Shared-memory layout (byte offsets from a 1024-aligned base).
template <int D>
struct DkvTiles {
    static constexpr uint32_t kKvBox = kKvRows * sm90::kSwizzleRowBytes;  // 64 columns x 128 rows: 16 KB
    static constexpr uint32_t kQBox = kQRows * sm90::kSwizzleRowBytes;    // 64 columns x 64 rows: 8 KB
    static constexpr uint32_t kKvTile = kKvBox * (D / sm90::kBoxCols);
    static constexpr uint32_t kQTile = kQBox * (D / sm90::kBoxCols);
    static constexpr uint32_t kK = 0, kV = kKvTile, kQ = 2 * kKvTile, kDo = kQ + kStages * kQTile;
    static constexpr uint32_t kLse = kDo + kStages * kQTile;          // [S][64] fp32: lse * log2(e)
    static constexpr uint32_t kDelta = kLse + kStages * kQRows * 4;    // [S][64] fp32
    static constexpr uint32_t kBarriers = kDelta + kStages * kQRows * 4;  // full_kv, full[S], empty[S]
    static constexpr uint32_t kBytes = kBarriers + (1 + 2 * kStages) * 8 + sm90::kSwizzleAtomBytes;  // + alignment
};

// TMA of one tile of `rows` rows: D/64 boxes of 64 columns, `box_bytes` apart.
template <int D>
__device__ __forceinline__ void load_tile_tma(uint32_t dst, uint32_t box_bytes, const CUtensorMap* map, uint32_t bar,
                                              int h, int row0, int b) {
#pragma unroll
    for (int box = 0; box < D / sm90::kBoxCols; ++box) {
        sm90::tma_load_4d(dst + box * box_bytes, map, bar, box * sm90::kBoxCols, h, row0, b);
    }
}

template <int D>
__global__ void __launch_bounds__(kThreadsDkv, 1)
    flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                       const DkvParams p) {
    using L = DkvTiles<D>;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = sm90::smem_addr(smem_raw);
    const uint32_t base = (raw + sm90::kSwizzleAtomBytes - 1) & ~(sm90::kSwizzleAtomBytes - 1);
    float* lse_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kLse);
    float* delta_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kDelta);
    const uint32_t full_kv = base + L::kBarriers;
    const auto full = [&](int s) { return full_kv + 8 * (1 + s); };
    const auto empty = [&](int s) { return full_kv + 8 * (1 + kStages + s); };

    const int bh = blockIdx.x;
    const int b = bh / p.heads, h = bh % p.heads;
    const int kv0 = blockIdx.y * kKvRows;
    const int q_tiles = (p.seq + kQRows - 1) / kQRows;
    const int q_begin = p.causal ? kv0 / kQRows : 0;  // causal: start at the diagonal tile

    if (threadIdx.x == 0) {
        sm90::mbar_init(full_kv, 1);
        for (int s = 0; s < kStages; ++s) {
            sm90::mbar_init(full(s), 32);  // the producer warp's lanes, one of them with the TMA bytes
            sm90::mbar_init(empty(s), kConsumerWarps);
        }
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (threadIdx.x >= kConsumerWarps * 32) {  // the producer warpgroup; its first warp loads
        sm90::setmaxnreg_dec<kProducerRegs>();
        const int lane = threadIdx.x - kConsumerWarps * 32;
        if (lane < 32) {
            if (lane == 0) {
                sm90::mbar_arrive_expect_tx(full_kv, 2 * L::kKvTile);
                load_tile_tma<D>(base + L::kK, L::kKvBox, &tm_k, full_kv, h, kv0, b);
                load_tile_tma<D>(base + L::kV, L::kKvBox, &tm_v, full_kv, h, kv0, b);
            }
            const float* lse = p.lse + static_cast<long long>(bh) * p.seq;
            const float* delta = p.delta + static_cast<long long>(bh) * p.seq;
            for (int i = q_begin; i < q_tiles; ++i) {
                const int n = i - q_begin, s = n % kStages;
                sm90::mbar_wait(empty(s), ((n / kStages) & 1) ^ 1);  // the first round passes at once
                const int q0 = i * kQRows;
#pragma unroll
                for (int r = lane; r < kQRows; r += 32) {
                    const bool valid = q0 + r < p.seq;
                    lse_s[s * kQRows + r] = valid ? lse[q0 + r] * sm90::kLog2e : 0.0f;
                    delta_s[s * kQRows + r] = valid ? delta[q0 + r] : 0.0f;
                }
                if (lane == 0) {
                    sm90::mbar_arrive_expect_tx(full(s), 2 * L::kQTile);
                    load_tile_tma<D>(base + L::kQ + s * L::kQTile, L::kQBox, &tm_q, full(s), h, q0, b);
                    load_tile_tma<D>(base + L::kDo + s * L::kQTile, L::kQBox, &tm_do, full(s), h, q0, b);
                } else {
                    sm90::mbar_arrive(full(s));
                }
            }
        }
    } else {  // two consumer warpgroups, 64 KV rows each
        sm90::setmaxnreg_inc<kConsumerRegs>();
        const int wg = threadIdx.x / 128;
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int g = lane / 4, t = lane % 4;
        const int row_a = kv0 + wg * 64 + warp * 16 + g;  // this thread's KV rows: row_a, row_a + 8
        const float scale2 = p.scale * sm90::kLog2e;

        float dk[D / 2], dv[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

        const uint32_t k_wg = base + L::kK + wg * 64 * sm90::kSwizzleRowBytes;  // this warpgroup's 64 rows
        const uint32_t v_wg = base + L::kV + wg * 64 * sm90::kSwizzleRowBytes;
        sm90::mbar_wait(full_kv, 0);
        for (int i = q_begin; i < q_tiles; ++i) {
            const int n = i - q_begin, s = n % kStages;
            const uint32_t q_tile = base + L::kQ + s * L::kQTile, do_tile = base + L::kDo + s * L::kQTile;

            float st[kQRows / 2], dpt[kQRows / 2];  // S^T = K Q^T and dP^T = V dO^T: 64 x 64 each
            sm90::mbar_wait(full(s), (n / kStages) & 1);
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                // box kk / 4, then 32 bytes (16 columns) along its swizzled 128-byte rows
                const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                sm90::wgmma_ss(st, sm90::desc_kmajor(k_wg + kv_off), sm90::desc_kmajor(q_tile + q_off), kk > 0);
            }
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const uint32_t kv_off = (kk / 4) * L::kKvBox + (kk % 4) * 32;
                const uint32_t q_off = (kk / 4) * L::kQBox + (kk % 4) * 32;
                sm90::wgmma_ss(dpt, sm90::desc_kmajor(v_wg + kv_off), sm90::desc_kmajor(do_tile + q_off), kk > 0);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(st);
            sm90::fence_regs(dpt);

            // P^T and dS^T in place, column c of the tile being query q0 + c
            const int q0 = i * kQRows;
            const float* lse_t = lse_s + s * kQRows;
            const float* delta_t = delta_s + s * kQRows;
            const bool edge = q0 + kQRows > p.seq || (p.causal && q0 < kv0 + kKvRows);
#pragma unroll
            for (int e = 0; e < kQRows / 2; ++e) {
                const int c = (e / 4) * 8 + 2 * t + (e & 1);
                float prob = sm90::exp2_approx(fmaf(st[e], scale2, -lse_t[c]));
                if (edge) {
                    const int row = row_a + (e & 2) * 4;
                    if (q0 + c >= p.seq || (p.causal && row > q0 + c)) prob = 0.0f;
                }
                st[e] = prob;
                dpt[e] = prob * (dpt[e] - delta_t[c]) * p.scale;
            }
            uint32_t pf[kQRows / 16][4], df[kQRows / 16][4];  // P^T and dS^T as A operands, 16 queries each
#pragma unroll
            for (int kc = 0; kc < kQRows / 16; ++kc) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    pf[kc][r] = sm90::pack_bf16(st[8 * kc + 2 * r], st[8 * kc + 2 * r + 1]);
                    df[kc][r] = sm90::pack_bf16(dpt[8 * kc + 2 * r], dpt[8 * kc + 2 * r + 1]);
                }
            }

            sm90::fence_regs(dv);
            sm90::fence_regs(dk);
            sm90::fence_regs(pf);
            sm90::fence_regs(df);
            sm90::wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < kQRows / 16; ++kc) {  // 16 query rows per k-step: 2048 bytes down the boxes
                sm90::wgmma_rs_tb(dv, pf[kc], sm90::desc_mnmajor(do_tile + kc * 16 * sm90::kSwizzleRowBytes, L::kQBox), 1);
            }
#pragma unroll
            for (int kc = 0; kc < kQRows / 16; ++kc) {
                sm90::wgmma_rs_tb(dk, df[kc], sm90::desc_mnmajor(q_tile + kc * 16 * sm90::kSwizzleRowBytes, L::kQBox), 1);
            }
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(dv);
            sm90::fence_regs(dk);
            if (lane == 0) sm90::mbar_arrive(empty(s));  // this warp is done with stage s
        }
        store_rows<D>(static_cast<__nv_bfloat16*>(p.dk) + b * p.o_sb + h * p.o_sh, p.o_st, dk, row_a, p.seq, t);
        store_rows<D>(static_cast<__nv_bfloat16*>(p.dv) + b * p.o_sb + h * p.o_sh, p.o_st, dv, row_a, p.seq, t);
    }
}

// ------------------------------------------------------------------ fp32 path

constexpr int kRowsPerWarp = 4;
constexpr int kRowsF32 = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kColsF32 = 32;                     // columns per tile: one per lane

// Stage `count` rows of one slice from row `row0` as [count][D + 1] floats (the
// padding keeps both row-per-lane and column-per-lane reads free of bank
// conflicts); rows at or past `seq` become zeros.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long row_stride, int row0,
                                              int count, int seq) {
    for (int i = threadIdx.x; i < count * D; i += kWarps * 32) {
        const int row = i / D, col = i % D;
        dst[row * (D + 1) + col] = row0 + row < seq ? src[(row0 + row) * row_stride + col] : 0.0f;
    }
}

// dQ pass: a warp owns 4 query rows; lane j takes key j of a 32-key tile.
template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dq_f32(const Params p) {
    constexpr int kCols = D / 32;
    constexpr int S = D + 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* q_s = reinterpret_cast<float*>(smem_raw);  // [kRowsF32][S]
    float* do_s = q_s + kRowsF32 * S;
    float* k_s = do_s + kRowsF32 * S;  // [kColsF32][S]
    float* v_s = k_s + kColsF32 * S;

    const int bh = blockIdx.y;
    const int b = bh / p.heads, h = bh % p.heads;
    const int q0 = blockIdx.x * kRowsF32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* q_base = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* k_base = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
    const float* v_base = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
    const float* d_base = static_cast<const float*>(p.dout) + b * p.d_sb + h * p.d_sh;
    load_rows_f32<D>(q_s, q_base, p.q_st, q0, kRowsF32, p.seq);
    load_rows_f32<D>(do_s, d_base, p.d_st, q0, kRowsF32, p.seq);

    const long long rows = static_cast<long long>(bh) * p.seq;
    const int row0 = q0 + warp * kRowsPerWarp;
    float lse[kRowsPerWarp], delta[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        const bool valid = row0 + r < p.seq;
        lse[r] = valid ? p.lse[rows + row0 + r] : 0.0f;
        delta[r] = valid ? p.delta[rows + row0 + r] : 0.0f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
    }

    const int kv_end = p.causal ? min(p.seq, q0 + kRowsF32) : p.seq;
    for (int kv0 = 0; kv0 < kv_end; kv0 += kColsF32) {
        __syncthreads();
        load_rows_f32<D>(k_s, k_base, p.k_st, kv0, kColsF32, p.seq);
        load_rows_f32<D>(v_s, v_base, p.v_st, kv0, kColsF32, p.seq);
        __syncthreads();

        float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.0f;
        for (int d = 0; d < D; ++d) {
            const float k_val = k_s[lane * S + d], v_val = v_s[lane * S + d];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                const int row = warp * kRowsPerWarp + r;
                s[r] = fmaf(q_s[row * S + d], k_val, s[r]);
                dp[r] = fmaf(do_s[row * S + d], v_val, dp[r]);
            }
        }
        const int key = kv0 + lane;
        float ds[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
            const bool masked = key >= p.seq || (p.causal && key > row0 + r);
            const float prob = masked ? 0.0f : expf(s[r] * p.scale - lse[r]);
            ds[r] = prob * (dp[r] - delta[r]) * p.scale;
        }
        for (int j = 0; j < kColsF32; ++j) {
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                const float term = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
                for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(term, k_s[j * S + c * 32 + lane], acc[r][c]);
            }
        }
    }
    float* o_base = static_cast<float*>(p.out0) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        if (row0 + r < p.seq) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) o_base[(row0 + r) * p.o_st + c * 32 + lane] = acc[r][c];
        }
    }
}

// dK/dV pass: a warp owns 4 KV rows; lane j takes query j of a 32-query tile.
template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dkv_f32(const Params p) {
    constexpr int kCols = D / 32;
    constexpr int S = D + 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* k_s = reinterpret_cast<float*>(smem_raw);  // [kRowsF32][S]
    float* v_s = k_s + kRowsF32 * S;
    float* q_s = v_s + kRowsF32 * S;  // [kColsF32][S]
    float* do_s = q_s + kColsF32 * S;

    const int bh = blockIdx.y;
    const int b = bh / p.heads, h = bh % p.heads;
    const int kv0 = blockIdx.x * kRowsF32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* q_base = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* k_base = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
    const float* v_base = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
    const float* d_base = static_cast<const float*>(p.dout) + b * p.d_sb + h * p.d_sh;
    load_rows_f32<D>(k_s, k_base, p.k_st, kv0, kRowsF32, p.seq);
    load_rows_f32<D>(v_s, v_base, p.v_st, kv0, kRowsF32, p.seq);

    const long long rows = static_cast<long long>(bh) * p.seq;
    const int row0 = kv0 + warp * kRowsPerWarp;
    float dk[kRowsPerWarp][kCols], dv[kRowsPerWarp][kCols];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) dk[r][c] = dv[r][c] = 0.0f;
    }

    const int q_begin = p.causal ? kv0 / kColsF32 * kColsF32 : 0;  // causal: from the diagonal tile
    for (int q0 = q_begin; q0 < p.seq; q0 += kColsF32) {
        __syncthreads();
        load_rows_f32<D>(q_s, q_base, p.q_st, q0, kColsF32, p.seq);
        load_rows_f32<D>(do_s, d_base, p.d_st, q0, kColsF32, p.seq);
        __syncthreads();

        const int query = q0 + lane;
        const bool valid = query < p.seq;
        const float lse = valid ? p.lse[rows + query] : 0.0f;
        const float delta = valid ? p.delta[rows + query] : 0.0f;
        float st[kRowsPerWarp], dpt[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) st[r] = dpt[r] = 0.0f;
        for (int d = 0; d < D; ++d) {
            const float q_val = q_s[lane * S + d], do_val = do_s[lane * S + d];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                const int row = warp * kRowsPerWarp + r;
                st[r] = fmaf(k_s[row * S + d], q_val, st[r]);
                dpt[r] = fmaf(v_s[row * S + d], do_val, dpt[r]);
            }
        }
        float pt[kRowsPerWarp], dst[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
            const bool masked = !valid || (p.causal && row0 + r > query);
            pt[r] = masked ? 0.0f : expf(st[r] * p.scale - lse);
            dst[r] = pt[r] * (dpt[r] - delta) * p.scale;
        }
        for (int j = 0; j < kColsF32; ++j) {
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                const float prob = __shfl_sync(0xffffffffu, pt[r], j);
                const float term = __shfl_sync(0xffffffffu, dst[r], j);
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                    dv[r][c] = fmaf(prob, do_s[j * S + c * 32 + lane], dv[r][c]);
                    dk[r][c] = fmaf(term, q_s[j * S + c * 32 + lane], dk[r][c]);
                }
            }
        }
    }
    float* dk_base = static_cast<float*>(p.out0) + b * p.o_sb + h * p.o_sh;
    float* dv_base = static_cast<float*>(p.out1) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        if (row0 + r < p.seq) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                dk_base[(row0 + r) * p.o_st + c * 32 + lane] = dk[r][c];
                dv_base[(row0 + r) * p.o_st + c * 32 + lane] = dv[r][c];
            }
        }
    }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int rows_per_block, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.seq + rows_per_block - 1) / rows_per_block, p.batch * p.heads);
    kernel<<<grid, kWarps * 32, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Params& p, int is_bf16, cudaStream_t stream) {
    if (is_bf16) return launch(flash_bwd_dq_bf16<D>, p, kTile, 4 * kTile * (D + kPad) * sizeof(__nv_bfloat16), stream);
    return launch(flash_bwd_dq_f32<D>, p, kRowsF32, (2 * kRowsF32 + 2 * kColsF32) * (D + 1) * sizeof(float), stream);
}

template <int D>
int launch_dkv_f32(const Params& p, cudaStream_t stream) {
    return launch(flash_bwd_dkv_f32<D>, p, kRowsF32, (2 * kRowsF32 + 2 * kColsF32) * (D + 1) * sizeof(float), stream);
}

template <int D>
int launch_dkv_bf16(const CUtensorMap (&maps)[4], const DkvParams& p, int batch, cudaStream_t stream) {
    constexpr size_t smem = DkvTiles<D>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(batch * p.heads, (p.seq + kKvRows - 1) / kKvRows);
    flash_bwd_dkv_bf16<D><<<grid, kThreadsDkv, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
    return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                   const float* delta, void* out0, void* out1, int batch, int seq, int heads,
                   long long q_sb, long long q_st, long long q_sh, long long k_sb, long long k_st, long long k_sh,
                   long long v_sb, long long v_st, long long v_sh, long long d_sb, long long d_st, long long d_sh,
                   long long o_sb, long long o_st, long long o_sh, int causal, float scale) {
    return Params{q, k, v, dout, lse, delta, out0, out1, batch, seq, heads,
                  q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh, o_sb, o_st, o_sh,
                  scale, causal};
}

}  // namespace

// q, k, v, dout: [B, T, H, D] (bf16 or fp32, last dim contiguous, strides in
// elements); lse, delta: [B, H, T] fp32 contiguous -> dq [B, T, H, D] in q's dtype.
extern "C" int hm_flash_backward_dq(const void* q, const void* k, const void* v, const void* dout,
                                    const float* lse, const float* delta, void* dq,
                                    int batch, int seq, int heads, int head_dim,
                                    long long q_sb, long long q_st, long long q_sh,
                                    long long k_sb, long long k_st, long long k_sh,
                                    long long v_sb, long long v_st, long long v_sh,
                                    long long d_sb, long long d_st, long long d_sh,
                                    long long o_sb, long long o_st, long long o_sh,
                                    int causal, int is_bf16, float scale, cudaStream_t stream) {
    const Params p = make_params(q, k, v, dout, lse, delta, dq, nullptr, batch, seq, heads, q_sb, q_st, q_sh,
                                 k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh, o_sb, o_st, o_sh,
                                 causal, scale);
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (head_dim == 64) return launch_dq<64>(p, is_bf16, stream);
    if (head_dim == 128) return launch_dq<128>(p, is_bf16, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// As above, fp32 only -> dk, dv [B, T, H, D] fp32, sharing one layout (o_*).
extern "C" int hm_flash_backward_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                                         const float* lse, const float* delta, void* dk, void* dv,
                                         int batch, int seq, int heads, int head_dim,
                                         long long q_sb, long long q_st, long long q_sh,
                                         long long k_sb, long long k_st, long long k_sh,
                                         long long v_sb, long long v_st, long long v_sh,
                                         long long d_sb, long long d_st, long long d_sh,
                                         long long o_sb, long long o_st, long long o_sh,
                                         int causal, float scale, cudaStream_t stream) {
    const Params p = make_params(q, k, v, dout, lse, delta, dk, dv, batch, seq, heads, q_sb, q_st, q_sh,
                                 k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh, o_sb, o_st, o_sh,
                                 causal, scale);
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (head_dim == 64) return launch_dkv_f32<64>(p, stream);
    if (head_dim == 128) return launch_dkv_f32<128>(p, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// q, k, v, dout: [B, T, H, D] bf16, each described by its TMA geometry
// (sm90::TmaGeometry; boxes of 64 columns x 64 rows for q and dout, x 128 rows for
// k and v); lse, delta: [B, H, T] fp32 contiguous -> dk, dv [B, T, H, D] bf16,
// sharing one layout (o_*, strides in elements).
extern "C" int hm_flash_backward_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                          const float* lse, const float* delta, void* dk, void* dv,
                                          int batch, int seq, int heads, int head_dim,
                                          const long long* q_geometry, const long long* k_geometry,
                                          const long long* v_geometry, const long long* d_geometry,
                                          long long o_sb, long long o_st, long long o_sh,
                                          int causal, float scale, cudaStream_t stream) {
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (head_dim != 64 && head_dim != 128) return static_cast<int>(cudaErrorInvalidValue);
    const void* bases[4] = {q, k, v, dout};
    const long long* geometries[4] = {q_geometry, k_geometry, v_geometry, d_geometry};
    const int rows[4] = {kQRows, kKvRows, kKvRows, kQRows};
    CUtensorMap maps[4];
    for (int i = 0; i < 4; ++i) {
        const int err = sm90::encode_tma_map(&maps[i], bases[i], *reinterpret_cast<const sm90::TmaGeometry*>(geometries[i]),
                                             rows[i], head_dim);
        if (err != 0) return err;
    }
    const DkvParams p{lse, delta, dk, dv, seq, heads, o_sb, o_st, o_sh, scale, causal};
    if (head_dim == 64) return launch_dkv_bf16<64>(maps, p, batch, stream);
    return launch_dkv_bf16<128>(maps, p, batch, stream);
}
