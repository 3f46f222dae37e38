// Flash-attention forward for Hopper (sm_90a): out = softmax(Q K^T * D^-1/2) V and
// lse = rowmax + log(rowsum), on [B, T, H, D] tensors read through their strides.
//
// Replaces: hivemind_tpu/ops/pallas_attention.py — `_flash_forward` (the
// `pl.pallas_call` of the kernel body `_flash_kernel`), reached through
// `flash_attention` and `flash_attention_lse`. The plain PyTorch version and the
// wrapper are hivemind_tpu_torch/ops/flash_attention.py.
//
// What bounds it: operations. At the serving shapes (H = 32, D = 128, T = 512 to
// 2048) the two products do 4*T*T*D*H operations (half of that causal) against
// 4*T*H*D*2 bytes in and out: hundreds of operations per byte, above the H100's
// ~295 bf16 operations per byte. The design keeps every score and probability in
// registers (never in device memory) and feeds the tensor cores.
//
// Design, bf16 (the serving path):
//  * One thread block per (query tile of 64 rows, batch*head); 4 warps, each owning
//    16 query rows. The TPU kernel carried its online-softmax state in VMEM across
//    sequential grid steps; blocks here run in parallel in no order, so the KV loop
//    runs inside the block and the carry (row max, row sum, fp32 accumulator) lives
//    in registers.
//  * Q, K and V tiles (64 x D bf16, rows padded by 16 bytes) are staged in dynamic
//    shared memory (52 KB at D = 128, above the 48 KB static cap, hence the opt-in).
//    Rows past T load as zeros; nothing is transposed or padded on the host.
//  * Both products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate). The score
//    accumulator's register layout is exactly the A-operand layout of the P*V
//    product, so probabilities go from registers to the tensor cores as bf16
//    without a trip through shared memory.
//  * Causal: the KV loop ends at the diagonal tile, so no block is skipped by a
//    branch; within a tile, kv_pos > q_pos and kv_pos >= T take the finite -1e30
//    (as the TPU kernel), so fully masked rows stay finite.
//  * Later work (not here): wgmma, TMA loads with an mbarrier pipeline, ldmatrix
//    for the transposed V operand.
//
// Design, fp32: the same online softmax on the CUDA cores with fp32 FMAs only (no
// TF32): a warp owns 4 query rows, lane j scores key j of a 32-key tile, and each
// lane accumulates D/32 output columns from probabilities broadcast by shuffles.

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // large-but-finite, as the TPU kernel

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* out;
    float* lse;  // [B, H, T] contiguous
    int batch, seq, heads;
    long long q_sb, q_st, q_sh;
    long long k_sb, k_st, k_sh;
    long long v_sb, v_st, v_sh;
    long long o_sb, o_st, o_sh;
    float scale;
    int causal;
};

// ------------------------------------------------------------------ bf16 path

constexpr int kTile = 64;      // query rows and KV rows per tile
constexpr int kWarpsBf16 = 4;  // 16 query rows per warp
constexpr int kPad = 8;        // bf16 elements of padding per shared-memory row

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
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long row_stride, int row0, int seq) {
    constexpr int kChunksPerRow = D / 8;
    for (int i = threadIdx.x; i < kTile * kChunksPerRow; i += kWarpsBf16 * 32) {
        const int row = i / kChunksPerRow, chunk = i % kChunksPerRow;
        uint4 value = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + row < seq) {
            value = *reinterpret_cast<const uint4*>(src + (row0 + row) * row_stride + chunk * 8);
        }
        *reinterpret_cast<uint4*>(dst + row * (D + kPad) + chunk * 8) = value;
    }
}

template <int D>
__global__ void __launch_bounds__(kWarpsBf16 * 32) flash_forward_bf16(const Params p) {
    constexpr int S = D + kPad;  // shared-memory row stride in elements
    constexpr int kChunksD = D / 16;
    constexpr int kTilesN = kTile / 8;
    constexpr int kTilesD = D / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* k_s = q_s + kTile * S;
    __nv_bfloat16* v_s = k_s + kTile * S;
    const uint16_t* v_u16 = reinterpret_cast<const uint16_t*>(v_s);

    const int bh = blockIdx.y;
    const int b = bh / p.heads, h = bh % p.heads;
    const int q0 = blockIdx.x * kTile;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;

    const __nv_bfloat16* q_base = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* k_base = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
    const __nv_bfloat16* v_base = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

    load_tile_bf16<D>(q_s, q_base, p.q_st, q0, p.seq);
    __syncthreads();
    uint32_t q_frag[kChunksD][4];
    const int r_lo = warp * 16 + g;  // this thread's two rows in the tile: r_lo, r_lo + 8
#pragma unroll
    for (int kk = 0; kk < kChunksD; ++kk) {
        q_frag[kk][0] = load_pair(q_s + r_lo * S + kk * 16 + t * 2);
        q_frag[kk][1] = load_pair(q_s + (r_lo + 8) * S + kk * 16 + t * 2);
        q_frag[kk][2] = load_pair(q_s + r_lo * S + kk * 16 + t * 2 + 8);
        q_frag[kk][3] = load_pair(q_s + (r_lo + 8) * S + kk * 16 + t * 2 + 8);
    }
    const int row_a = q0 + r_lo, row_b = row_a + 8;  // sequence positions of the two rows

    float acc[kTilesD][4];
#pragma unroll
    for (int n = 0; n < kTilesD; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    float max_a = kNegInf, max_b = kNegInf, sum_a = 0.0f, sum_b = 0.0f;

    const int kv_end = p.causal ? min(p.seq, q0 + kTile) : p.seq;  // causal: stop at the diagonal tile
    for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
        __syncthreads();  // every warp is done with the previous K/V tile
        load_tile_bf16<D>(k_s, k_base, p.k_st, kv0, p.seq);
        load_tile_bf16<D>(v_s, v_base, p.v_st, kv0, p.seq);
        __syncthreads();

        float s[kTilesN][4];
#pragma unroll
        for (int j = 0; j < kTilesN; ++j) {
            s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
            for (int kk = 0; kk < kChunksD; ++kk) {
                uint32_t b_frag[2];
                b_frag[0] = load_pair(k_s + (j * 8 + g) * S + kk * 16 + t * 2);
                b_frag[1] = load_pair(k_s + (j * 8 + g) * S + kk * 16 + t * 2 + 8);
                mma_bf16_16816(s[j], q_frag[kk], b_frag);
            }
        }

        float tile_max_a = kNegInf, tile_max_b = kNegInf;
#pragma unroll
        for (int j = 0; j < kTilesN; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = kv0 + j * 8 + t * 2 + (e & 1);
                const int row = e < 2 ? row_a : row_b;
                const bool masked = col >= p.seq || (p.causal && col > row);
                s[j][e] = masked ? kNegInf : s[j][e] * p.scale;
            }
            tile_max_a = fmaxf(tile_max_a, fmaxf(s[j][0], s[j][1]));
            tile_max_b = fmaxf(tile_max_b, fmaxf(s[j][2], s[j][3]));
        }
#pragma unroll
        for (int offset = 1; offset < 4; offset <<= 1) {  // the 4 threads of a quad share a row
            tile_max_a = fmaxf(tile_max_a, __shfl_xor_sync(0xffffffffu, tile_max_a, offset));
            tile_max_b = fmaxf(tile_max_b, __shfl_xor_sync(0xffffffffu, tile_max_b, offset));
        }
        const float new_max_a = fmaxf(max_a, tile_max_a), new_max_b = fmaxf(max_b, tile_max_b);
        const float corr_a = expf(max_a - new_max_a), corr_b = expf(max_b - new_max_b);
        max_a = new_max_a;
        max_b = new_max_b;

        float part_a = 0.0f, part_b = 0.0f;
#pragma unroll
        for (int j = 0; j < kTilesN; ++j) {
            s[j][0] = expf(s[j][0] - new_max_a);
            s[j][1] = expf(s[j][1] - new_max_a);
            s[j][2] = expf(s[j][2] - new_max_b);
            s[j][3] = expf(s[j][3] - new_max_b);
            part_a += s[j][0] + s[j][1];
            part_b += s[j][2] + s[j][3];
        }
        sum_a = sum_a * corr_a + part_a;  // per-thread partial; the quad is summed at the end
        sum_b = sum_b * corr_b + part_b;
#pragma unroll
        for (int n = 0; n < kTilesD; ++n) {
            acc[n][0] *= corr_a;
            acc[n][1] *= corr_a;
            acc[n][2] *= corr_b;
            acc[n][3] *= corr_b;
        }

#pragma unroll
        for (int kc = 0; kc < kTile / 16; ++kc) {
            uint32_t p_frag[4];
            p_frag[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
            p_frag[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
            p_frag[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
            p_frag[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
            const int k_row = kc * 16 + t * 2;
#pragma unroll
            for (int n = 0; n < kTilesD; ++n) {
                const int col = n * 8 + g;
                uint32_t b_frag[2];
                b_frag[0] = uint32_t(v_u16[k_row * S + col]) | (uint32_t(v_u16[(k_row + 1) * S + col]) << 16);
                b_frag[1] = uint32_t(v_u16[(k_row + 8) * S + col]) | (uint32_t(v_u16[(k_row + 9) * S + col]) << 16);
                mma_bf16_16816(acc[n], p_frag, b_frag);
            }
        }
    }

#pragma unroll
    for (int offset = 1; offset < 4; offset <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, offset);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, offset);
    }
    const float denom_a = fmaxf(sum_a, 1e-30f), denom_b = fmaxf(sum_b, 1e-30f);
    __nv_bfloat16* o_base = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < kTilesD; ++n) {
        const int col = n * 8 + t * 2;
        if (row_a < p.seq) {
            *reinterpret_cast<__nv_bfloat162*>(o_base + row_a * p.o_st + col) =
                __floats2bfloat162_rn(acc[n][0] / denom_a, acc[n][1] / denom_a);
        }
        if (row_b < p.seq) {
            *reinterpret_cast<__nv_bfloat162*>(o_base + row_b * p.o_st + col) =
                __floats2bfloat162_rn(acc[n][2] / denom_b, acc[n][3] / denom_b);
        }
    }
    if (t == 0) {
        float* lse = p.lse + static_cast<long long>(bh) * p.seq;
        if (row_a < p.seq) lse[row_a] = max_a + logf(denom_a);
        if (row_b < p.seq) lse[row_b] = max_b + logf(denom_b);
    }
}

// ------------------------------------------------------------------ fp32 path

constexpr int kWarpsF32 = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsF32 = kWarpsF32 * kRowsPerWarp;  // query rows per block
constexpr int kKeysF32 = 32;                        // keys per tile: one per lane

template <int D>
__global__ void __launch_bounds__(kWarpsF32 * 32) flash_forward_f32(const Params p) {
    constexpr int kCols = D / 32;  // output columns per lane
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* q_s = reinterpret_cast<float*>(smem_raw);  // [kRowsF32][D], read as broadcasts
    float* k_s = q_s + kRowsF32 * D;                   // [kKeysF32][D + 1]: lane j reads row j, no bank conflicts
    float* v_s = k_s + kKeysF32 * (D + 1);             // [kKeysF32][D]: lanes read neighbouring columns

    const int bh = blockIdx.y;
    const int b = bh / p.heads, h = bh % p.heads;
    const int q0 = blockIdx.x * kRowsF32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* q_base = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* k_base = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
    const float* v_base = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

    for (int i = threadIdx.x; i < kRowsF32 * D; i += kWarpsF32 * 32) {
        const int row = i / D, col = i % D;
        q_s[i] = q0 + row < p.seq ? q_base[(q0 + row) * p.q_st + col] : 0.0f;
    }

    float acc[kRowsPerWarp][kCols];
    float row_max[kRowsPerWarp], lane_sum[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        row_max[r] = kNegInf;
        lane_sum[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
    }
    const int row0 = q0 + warp * kRowsPerWarp;  // sequence position of this warp's first row

    const int kv_end = p.causal ? min(p.seq, q0 + kRowsF32) : p.seq;
    for (int kv0 = 0; kv0 < kv_end; kv0 += kKeysF32) {
        __syncthreads();
        for (int i = threadIdx.x; i < kKeysF32 * D; i += kWarpsF32 * 32) {
            const int row = i / D, col = i % D;
            const bool valid = kv0 + row < p.seq;
            k_s[row * (D + 1) + col] = valid ? k_base[(kv0 + row) * p.k_st + col] : 0.0f;
            v_s[row * D + col] = valid ? v_base[(kv0 + row) * p.v_st + col] : 0.0f;
        }
        __syncthreads();

        const int key = kv0 + lane;
        float score[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) score[r] = 0.0f;
        for (int d = 0; d < D; ++d) {
            const float k_val = k_s[lane * (D + 1) + d];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                score[r] = fmaf(q_s[(warp * kRowsPerWarp + r) * D + d], k_val, score[r]);
            }
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
            const bool masked = key >= p.seq || (p.causal && key > row0 + r);
            score[r] = masked ? kNegInf : score[r] * p.scale;
            float tile_max = score[r];
#pragma unroll
            for (int offset = 16; offset > 0; offset >>= 1) {
                tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, offset));
            }
            const float new_max = fmaxf(row_max[r], tile_max);
            const float corr = expf(row_max[r] - new_max);
            row_max[r] = new_max;
            score[r] = expf(score[r] - new_max);
            lane_sum[r] = lane_sum[r] * corr + score[r];
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
        }
        for (int j = 0; j < kKeysF32; ++j) {
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
                const float prob = __shfl_sync(0xffffffffu, score[r], j);
#pragma unroll
                for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(prob, v_s[j * D + c * 32 + lane], acc[r][c]);
            }
        }
    }

    float* o_base = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
        float total = lane_sum[r];
#pragma unroll
        for (int offset = 16; offset > 0; offset >>= 1) total += __shfl_xor_sync(0xffffffffu, total, offset);
        const float denom = fmaxf(total, 1e-30f);
        const int row = row0 + r;
        if (row < p.seq) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) o_base[row * p.o_st + c * 32 + lane] = acc[r][c] / denom;
            if (lane == 0) p.lse[static_cast<long long>(bh) * p.seq + row] = row_max[r] + logf(denom);
        }
    }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int rows_per_block, int threads, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.seq + rows_per_block - 1) / rows_per_block, p.batch * p.heads);
    kernel<<<grid, threads, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Params& p, cudaStream_t stream) {
    const size_t smem = 3 * kTile * (D + kPad) * sizeof(__nv_bfloat16);
    return launch(flash_forward_bf16<D>, p, kTile, kWarpsBf16 * 32, smem, stream);
}

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
    const size_t smem = (kRowsF32 * D + kKeysF32 * (D + 1) + kKeysF32 * D) * sizeof(float);
    return launch(flash_forward_f32<D>, p, kRowsF32, kWarpsF32 * 32, smem, stream);
}

}  // namespace

// q, k, v: [B, T, H, D] (bf16 or fp32, last dim contiguous, strides in elements)
// -> out [B, T, H, D] in the same dtype and lse [B, H, T] fp32 contiguous.
extern "C" int hm_flash_forward(const void* q, const void* k, const void* v, void* out, float* lse,
                                int batch, int seq, int heads, int head_dim,
                                long long q_sb, long long q_st, long long q_sh,
                                long long k_sb, long long k_st, long long k_sh,
                                long long v_sb, long long v_st, long long v_sh,
                                long long o_sb, long long o_st, long long o_sh,
                                int causal, int is_bf16, float scale, cudaStream_t stream) {
    const Params p{q, k, v, out, lse, batch, seq, heads,
                   q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh,
                   scale, causal};
    if (batch <= 0 || seq <= 0 || heads <= 0) return 0;
    if (is_bf16) {
        if (head_dim == 64) return launch_bf16<64>(p, stream);
        if (head_dim == 128) return launch_bf16<128>(p, stream);
    } else {
        if (head_dim == 64) return launch_f32<64>(p, stream);
        if (head_dim == 128) return launch_f32<128>(p, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
