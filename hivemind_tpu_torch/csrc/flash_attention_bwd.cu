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
// Design, bf16:
//  * The TPU carried dq_acc and dk_acc/dv_acc in VMEM across sequential grid
//    steps; blocks here run in parallel in no order, so each sweep is a loop
//    inside the block and its accumulators live in registers in fp32. Two passes
//    and no atomics: the result is deterministic.
//  * dQ kernel: one block per (64 query rows, batch*head), 4 warps of 16 rows; it
//    loops over 64-row KV tiles, ending at the diagonal tile when causal.
//  * dK/dV kernel: one block per (64 KV rows, batch*head), 4 warps of 16 KV rows;
//    it loops over 64-row query tiles, starting at the diagonal tile when causal.
//    It computes S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T come out
//    in the mma.sync accumulator layout, which is the A-operand layout of P^T dO
//    and dS^T Q (the forward's trick for P V); lse and delta are read per column.
//  * Each tile is walked 16 columns at a time: the scores of two 8-column mma
//    tiles are computed, turned into P and dS, rounded to bf16 and fed straight to
//    the next product, so only 16 score values are live per thread besides the
//    accumulators (64 fp32 per 16 x D tile at D = 128; 128 for dK and dV).
//  * mma.sync m16n8k16, bf16 in, fp32 accumulate. P and dS are rounded to bf16
//    before their products: that rounding is the kernel's main difference from
//    the TPU kernel, which multiplied fp32 tiles.
//  * Rows at or past T load as zeros; columns past T (and above the diagonal when
//    causal) are masked to P = 0 explicitly, so nothing relies on a padded lse.
//  * Later work (not here): ldmatrix.trans for the transposed operands (K in dS K,
//    Q in dS^T Q, dO in P^T dO, read here as 16-bit scalars), cp.async or TMA
//    pipelining, wgmma.
//
// Design, fp32 (no served or trained path uses it on the card; it exists so that
// fp32 CUDA tensors differentiate): plain FMAs on the CUDA cores, no TF32. A warp
// owns 4 rows (query rows in the dQ kernel, KV rows in the dK/dV kernel); lane j
// takes column j of a 32-wide tile, and each lane accumulates D/32 output columns
// from the per-column terms broadcast by shuffles.

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
    return *reinterpret_cast<uint32_t*>(&pair);
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

// Write a warp's 16 x D fp32 accumulator as bf16 rows `row_a` and `row_a + 8`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride, const float acc[][4],
                                           int row_a, int seq, int t) {
    const int row_b = row_a + 8;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + t * 2;
        if (row_a < seq) {
            *reinterpret_cast<__nv_bfloat162*>(base + row_a * row_stride + col) = __floats2bfloat162_rn(acc[n][0], acc[n][1]);
        }
        if (row_b < seq) {
            *reinterpret_cast<__nv_bfloat162*>(base + row_b * row_stride + col) = __floats2bfloat162_rn(acc[n][2], acc[n][3]);
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
            ds_frag[0] = pack_bf16(ds[0][0], ds[0][1]);
            ds_frag[1] = pack_bf16(ds[0][2], ds[0][3]);
            ds_frag[2] = pack_bf16(ds[1][0], ds[1][1]);
            ds_frag[3] = pack_bf16(ds[1][2], ds[1][3]);
            mma_ab<D>(acc, ds_frag, k_s, kc * 16, g, t);
        }
    }
    __nv_bfloat16* o_base = static_cast<__nv_bfloat16*>(p.out0) + b * p.o_sb + h * p.o_sh;
    store_rows<D>(o_base, p.o_st, acc, row_a, p.seq, t);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dkv_bf16(const Params p) {
    constexpr int S = D + kPad;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* v_s = k_s + kTile * S;
    __nv_bfloat16* q_s = v_s + kTile * S;
    __nv_bfloat16* do_s = q_s + kTile * S;
    float* lse_s = reinterpret_cast<float*>(do_s + kTile * S);
    float* delta_s = lse_s + kTile;

    const int bh = blockIdx.y;
    const int b = bh / p.heads, h = bh % p.heads;
    const int kv0 = blockIdx.x * kTile;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;

    const __nv_bfloat16* q_base = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* k_base = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
    const __nv_bfloat16* v_base = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
    const __nv_bfloat16* d_base = static_cast<const __nv_bfloat16*>(p.dout) + b * p.d_sb + h * p.d_sh;
    load_tile<D>(k_s, k_base, p.k_st, kv0, p.seq);
    load_tile<D>(v_s, v_base, p.v_st, kv0, p.seq);

    const int row_a = kv0 + r0 + g, row_b = row_a + 8;  // this thread's two KV rows
    const long long rows = static_cast<long long>(bh) * p.seq;

    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.0f;
        dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
    }

    const int q_begin = p.causal ? kv0 : 0;  // causal: start at the diagonal tile
    for (int q0 = q_begin; q0 < p.seq; q0 += kTile) {
        __syncthreads();  // every warp is done with the previous Q/dO tile
        load_tile<D>(q_s, q_base, p.q_st, q0, p.seq);
        load_tile<D>(do_s, d_base, p.d_st, q0, p.seq);
        for (int i = threadIdx.x; i < kTile; i += kWarps * 32) {
            const bool valid = q0 + i < p.seq;
            lse_s[i] = valid ? p.lse[rows + q0 + i] : 0.0f;
            delta_s[i] = valid ? p.delta[rows + q0 + i] : 0.0f;
        }
        __syncthreads();

#pragma unroll
        for (int kc = 0; kc < kTile / 16; ++kc) {  // 16 queries at a time
            float pt[2][4], dst[2][4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int j = 2 * kc + jj;
                float st[4], dpt[4];
                mma_abt<D>(st, k_s, r0, q_s, j * 8, g, t);
                mma_abt<D>(dpt, v_s, r0, do_s, j * 8, g, t);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = j * 8 + t * 2 + (e & 1);  // query column within the tile
                    const int col = q0 + c;
                    const int row = e < 2 ? row_a : row_b;
                    const bool masked = col >= p.seq || (p.causal && row > col);
                    const float prob = masked ? 0.0f : __expf(st[e] * p.scale - lse_s[c]);
                    pt[jj][e] = prob;
                    dst[jj][e] = prob * (dpt[e] - delta_s[c]) * p.scale;
                }
            }
            uint32_t p_frag[4], ds_frag[4];
            p_frag[0] = pack_bf16(pt[0][0], pt[0][1]);
            p_frag[1] = pack_bf16(pt[0][2], pt[0][3]);
            p_frag[2] = pack_bf16(pt[1][0], pt[1][1]);
            p_frag[3] = pack_bf16(pt[1][2], pt[1][3]);
            ds_frag[0] = pack_bf16(dst[0][0], dst[0][1]);
            ds_frag[1] = pack_bf16(dst[0][2], dst[0][3]);
            ds_frag[2] = pack_bf16(dst[1][0], dst[1][1]);
            ds_frag[3] = pack_bf16(dst[1][2], dst[1][3]);
            mma_ab<D>(dv, p_frag, do_s, kc * 16, g, t);
            mma_ab<D>(dk, ds_frag, q_s, kc * 16, g, t);
        }
    }
    store_rows<D>(static_cast<__nv_bfloat16*>(p.out0) + b * p.o_sb + h * p.o_sh, p.o_st, dk, row_a, p.seq, t);
    store_rows<D>(static_cast<__nv_bfloat16*>(p.out1) + b * p.o_sb + h * p.o_sh, p.o_st, dv, row_a, p.seq, t);
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
int launch_dkv(const Params& p, int is_bf16, cudaStream_t stream) {
    if (is_bf16) {
        const size_t smem = 4 * kTile * (D + kPad) * sizeof(__nv_bfloat16) + 2 * kTile * sizeof(float);
        return launch(flash_bwd_dkv_bf16<D>, p, kTile, smem, stream);
    }
    return launch(flash_bwd_dkv_f32<D>, p, kRowsF32, (2 * kRowsF32 + 2 * kColsF32) * (D + 1) * sizeof(float), stream);
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

// As above -> dk, dv [B, T, H, D] in k's dtype, sharing one layout (o_*).
extern "C" int hm_flash_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                                     const float* lse, const float* delta, void* dk, void* dv,
                                     int batch, int seq, int heads, int head_dim,
                                     long long q_sb, long long q_st, long long q_sh,
                                     long long k_sb, long long k_st, long long k_sh,
                                     long long v_sb, long long v_st, long long v_sh,
                                     long long d_sb, long long d_st, long long d_sh,
                                     long long o_sb, long long o_st, long long o_sh,
                                     int causal, int is_bf16, float scale, cudaStream_t stream) {
    const Params p = make_params(q, k, v, dout, lse, delta, dk, dv, batch, seq, heads, q_sb, q_st, q_sh,
                                 k_sb, k_st, k_sh, v_sb, v_st, v_sh, d_sb, d_st, d_sh, o_sb, o_st, o_sh,
                                 causal, scale);
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (head_dim == 64) return launch_dkv<64>(p, is_bf16, stream);
    if (head_dim == 128) return launch_dkv<128>(p, is_bf16, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}
