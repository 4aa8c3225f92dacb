// Fused stacked-species DF-ODENet MLP: x (B, F) through S per-species nets
// F -> H1 -> H2 -> H3 -> 1 with exact-erf GELU between layers -> out (B, S).
//
// Replaces deepflame_tpu/ops/pallas_kernels.py::mlp_fused_lanes (kernel
// _mlp_kernel), the DNN chemistry of the low-Mach step. As there, every
// hidden activation stays on chip: a block owns a tile of lanes (rows of x)
// of one species and keeps that tile's activations in shared memory through
// all four layers; only x, the weights and the (B, S) result touch device
// memory.
//
// Three modes, chosen by the weights' type:
//   bf16  x and W rounded to bf16, products summed in f32 on the tensor
//         cores (nvcuda::wmma 16x16x16, f32 accumulators); bias add and GELU
//         in f32; each hidden activation stored as bf16 in shared memory.
//         This is where the Pallas kernel rounds. x, biases and out are f32.
//   f32   plain FMA on the CUDA cores, everything f32.
//   f64   plain FMA on the CUDA cores, everything f64.
//
// What bounds it on an H100: operations. At the main path's shapes (S = 8,
// widths 11 -> 1600 -> 800 -> 400 -> 1, B = 884,736 cells) one call is
// 2 x (11*1600 + 1600*800 + 800*400 + 400) = 3.236 MFLOP per lane and
// species, 22.9 TFLOP in all: 23.2 ms at the 989 TFLOP/s dense bf16 peak,
// against about 26 MB of weights and 76 B per cell of x and out (under
// 0.05 ms at 3.35 TB/s). The design therefore puts the three large layers on
// the tensor cores and keeps activations out of device memory. The weights
// of one species (3.24 MB in bf16; 25.9 MB for eight) stay in the 50 MB L2:
// blocks of one species run side by side (species is the slow grid axis) and
// read their B fragments straight from global memory, four k-steps in flight
// per warp. A 32-lane block reuses each weight fragment for two 16-row
// tiles only, so the weights' L2 traffic, not the tensor cores, limits this
// first version; wgmma, TMA-fed shared-memory weight tiles and a persistent
// schedule are the way past that.
//
// Shared memory per block (dynamic, above 48 KB after cudaFuncSetAttribute):
// region A holds the H1 activations and later the H3 ones, region B holds x
// and later the H2 ones, plus a 16x16 f32 staging tile per warp (bf16 mode).
// In bf16 mode each activation row is padded by 8 values (16 bytes), so that
// the 16 rows of a tensor-core tile start in different banks. At the main
// path's widths: bf16, 32 lanes: 32 x (1608 + 808) x 2 B + 8 KB = 162,816 B;
// f32, 16 lanes, and f64, 8 lanes: 153,600 B (limit 232,448 B).
//
// Entry points (plain C, launch on `stream`, return cudaGetLastError()):
//   mlp_fused_{bf16,f32,f64}(x, W1, b1, W2, b2, W3, b3, W4, b4, out,
//                             B, F, K1, H1, H2, H3, S, stream)
// x (B, F); Wl (S, in, out) row-major with W1's in-dim K1 >= F (rows F..K1-1
// multiply zeros; bf16 needs K1, H1, H2, H3 multiples of 16); bl (S, out);
// out (B, S).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <algorithm>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LANES_BF16 = 32;     // two 16-row tensor-core tiles
constexpr int KSTEPS = 4;          // weight fragments in flight per warp
constexpr int ROW_PAD = 8;         // bf16 values added to each shared row

__device__ __forceinline__ float gelu(float v) {
    return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}
__device__ __forceinline__ double gelu(double v) {
    return 0.5 * v * (1.0 + erf(v * 0.70710678118654752));
}

// ------------------------------------------------------------ bf16 mode

// One hidden layer of the block's 32 lanes on the tensor cores:
// out[r, n] = bf16(gelu(sum_k in[r, k] W[k, n] + b[n])).
// in: shared (32, K), rows K + ROW_PAD apart; W: global (K, N) of this
// species; out: shared (32, N), rows N + ROW_PAD apart. Warp w computes the
// 16-column tiles w, w + WARPS, ... for both row tiles.
__device__ void hidden_layer_tc(const bf16* in, int K,
                                const bf16* __restrict__ W, int N,
                                const float* __restrict__ b, bf16* out,
                                float* stage) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int kt = K / 16, nt = N / 16;
    const int ldi = K + ROW_PAD, ldo = N + ROW_PAD;
    for (int j = warp; j < nt; j += WARPS) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
        wmma::fill_fragment(c0, 0.0f);
        wmma::fill_fragment(c1, 0.0f);
        for (int k0 = 0; k0 < kt; k0 += KSTEPS) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                           wmma::row_major> bw[KSTEPS];
#pragma unroll
            for (int u = 0; u < KSTEPS; ++u)
                if (k0 + u < kt)
                    wmma::load_matrix_sync(
                        bw[u], W + (size_t)(k0 + u) * 16 * N + j * 16, N);
#pragma unroll
            for (int u = 0; u < KSTEPS; ++u) {
                if (k0 + u < kt) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                                   wmma::row_major> a0, a1;
                    wmma::load_matrix_sync(a0, in + (k0 + u) * 16, ldi);
                    wmma::load_matrix_sync(a1, in + 16 * ldi + (k0 + u) * 16,
                                           ldi);
                    wmma::mma_sync(c0, a0, bw[u], c0);
                    wmma::mma_sync(c1, a1, bw[u], c1);
                }
            }
        }
        // epilogue through the warp's f32 staging tile: bias, GELU, bf16
        for (int m = 0; m < 2; ++m) {
            wmma::store_matrix_sync(stage, m == 0 ? c0 : c1, 16,
                                    wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
                const int r = e / 16, c = e % 16;
                const float v = stage[e] + b[j * 16 + c];
                out[(m * 16 + r) * ldo + j * 16 + c] = __float2bfloat16(gelu(v));
            }
            __syncwarp();
        }
    }
}

// The H3 -> 1 output layer: a dot product per lane, summed across a warp;
// in's rows are ld apart.
template <int LANES, typename Tin, typename Tacc, typename Tout>
__device__ void output_layer(const Tin* in, int K, int ld,
                             const Tin* __restrict__ W,
                             const Tout* __restrict__ b, Tout* __restrict__ out,
                             long row0, int B, int S, int s) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < LANES; r += WARPS) {
        Tacc acc = 0;
        for (int k = lane; k < K; k += 32)
            acc += (Tacc)in[r * ld + k] * (Tacc)W[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        const long row = row0 + r;
        if (lane == 0 && row < B)
            out[row * S + s] = (Tout)(acc + (Tacc)b[0]);
    }
}

__global__ void __launch_bounds__(THREADS)
mlp_fused_bf16_kernel(const float* __restrict__ x,
                      const bf16* __restrict__ W1, const float* __restrict__ b1,
                      const bf16* __restrict__ W2, const float* __restrict__ b2,
                      const bf16* __restrict__ W3, const float* __restrict__ b3,
                      const bf16* __restrict__ W4, const float* __restrict__ b4,
                      float* __restrict__ out, int B, int F, int K1, int H1,
                      int H2, int H3, int S) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* act_a = reinterpret_cast<bf16*>(smem);
    bf16* act_b = act_a + LANES_BF16 * (max(H1, H3) + ROW_PAD);
    float* stage = reinterpret_cast<float*>(
        act_b + LANES_BF16 * (max(H2, K1) + ROW_PAD)) + (threadIdx.x / 32) * 256;
    const int s = blockIdx.y;
    const long row0 = (long)blockIdx.x * LANES_BF16;

    // x tile -> region B as bf16, zero past F (the K padding) and past B
    for (int e = threadIdx.x; e < LANES_BF16 * K1; e += THREADS) {
        const int r = e / K1, k = e % K1;
        const long row = row0 + r;
        act_b[r * (K1 + ROW_PAD) + k] =
            __float2bfloat16(row < B && k < F ? x[row * F + k] : 0.0f);
    }
    __syncthreads();
    hidden_layer_tc(act_b, K1, W1 + (size_t)s * K1 * H1, H1, b1 + (size_t)s * H1,
                    act_a, stage);
    __syncthreads();
    hidden_layer_tc(act_a, H1, W2 + (size_t)s * H1 * H2, H2, b2 + (size_t)s * H2,
                    act_b, stage);
    __syncthreads();
    hidden_layer_tc(act_b, H2, W3 + (size_t)s * H2 * H3, H3, b3 + (size_t)s * H3,
                    act_a, stage);
    __syncthreads();
    output_layer<LANES_BF16, bf16, float, float>(
        act_a, H3, H3 + ROW_PAD, W4 + (size_t)s * H3, b4 + s, out, row0, B, S,
        s);
}

// ------------------------------------------------------ f32 and f64 modes

// out[r, n] = act(sum_k in[r, k] W[k, n] + b[n]) for the block's LANES
// lanes; thread t computes the columns t, t + THREADS, ... for every lane,
// reading each weight once and the activations as shared-memory broadcasts.
template <int LANES, typename T>
__device__ void hidden_layer_fma(const T* in, int K, const T* __restrict__ W,
                                 int N, const T* __restrict__ b, T* out) {
    for (int n = threadIdx.x; n < N; n += THREADS) {
        T acc[LANES];
#pragma unroll
        for (int r = 0; r < LANES; ++r) acc[r] = 0;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
            const T w = W[(size_t)k * N + n];
#pragma unroll
            for (int r = 0; r < LANES; ++r) acc[r] += in[r * K + k] * w;
        }
#pragma unroll
        for (int r = 0; r < LANES; ++r) out[r * N + n] = gelu(acc[r] + b[n]);
    }
}

template <int LANES, typename T>
__global__ void __launch_bounds__(THREADS)
mlp_fused_fma_kernel(const T* __restrict__ x,
                     const T* __restrict__ W1, const T* __restrict__ b1,
                     const T* __restrict__ W2, const T* __restrict__ b2,
                     const T* __restrict__ W3, const T* __restrict__ b3,
                     const T* __restrict__ W4, const T* __restrict__ b4,
                     T* __restrict__ out, int B, int F, int K1, int H1, int H2,
                     int H3, int S) {
    extern __shared__ __align__(128) unsigned char smem[];
    T* act_a = reinterpret_cast<T*>(smem);
    T* act_b = act_a + LANES * max(H1, H3);
    const int s = blockIdx.y;
    const long row0 = (long)blockIdx.x * LANES;

    for (int e = threadIdx.x; e < LANES * F; e += THREADS) {
        const long row = row0 + e / F;
        act_b[e] = row < B ? x[row0 * F + e] : T(0);
    }
    __syncthreads();
    // W1's rows F..K1-1 (padding) are never read
    hidden_layer_fma<LANES, T>(act_b, F, W1 + (size_t)s * K1 * H1, H1,
                               b1 + (size_t)s * H1, act_a);
    __syncthreads();
    hidden_layer_fma<LANES, T>(act_a, H1, W2 + (size_t)s * H1 * H2, H2,
                               b2 + (size_t)s * H2, act_b);
    __syncthreads();
    hidden_layer_fma<LANES, T>(act_b, H2, W3 + (size_t)s * H2 * H3, H3,
                               b3 + (size_t)s * H3, act_a);
    __syncthreads();
    output_layer<LANES, T, T, T>(act_a, H3, H3, W4 + (size_t)s * H3, b4 + s,
                                 out, row0, B, S, s);
}

template <typename K, typename Tx, typename Tw, typename Tb>
int launch(K kernel, int lanes, size_t smem, const void* x, const void* W1,
           const void* b1, const void* W2, const void* b2, const void* W3,
           const void* b3, const void* W4, const void* b4, void* out, int B,
           int F, int K1, int H1, int H2, int H3, int S, void* stream) {
    if (B <= 0) return 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((B + lanes - 1) / lanes, S);
    kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const Tx*)x, (const Tw*)W1, (const Tb*)b1, (const Tw*)W2,
        (const Tb*)b2, (const Tw*)W3, (const Tb*)b3, (const Tw*)W4,
        (const Tb*)b4, (Tx*)out, B, F, K1, H1, H2, H3, S);
    return (int)cudaGetLastError();
}

}  // namespace

#define MLP_ARGS const void *x, const void *W1, const void *b1, const void *W2, \
    const void *b2, const void *W3, const void *b3, const void *W4,            \
    const void *b4, void *out, int B, int F, int K1, int H1, int H2, int H3,   \
    int S, void *stream
#define MLP_PASS x, W1, b1, W2, b2, W3, b3, W4, b4, out, B, F, K1, H1, H2, H3, \
    S, stream

extern "C" int mlp_fused_bf16(MLP_ARGS) {
    const size_t smem = (size_t)LANES_BF16
                        * (std::max(H1, H3) + std::max(H2, K1) + 2 * ROW_PAD)
                        * sizeof(bf16) + (size_t)WARPS * 256 * sizeof(float);
    return launch<decltype(&mlp_fused_bf16_kernel), float, bf16, float>(
        mlp_fused_bf16_kernel, LANES_BF16, smem, MLP_PASS);
}

extern "C" int mlp_fused_f32(MLP_ARGS) {
    constexpr int lanes = 16;
    const size_t smem = (size_t)lanes * (std::max(H1, H3) + std::max(H2, F))
                        * sizeof(float);
    return launch<decltype(&mlp_fused_fma_kernel<lanes, float>), float, float,
                  float>(mlp_fused_fma_kernel<lanes, float>, lanes, smem,
                         MLP_PASS);
}

extern "C" int mlp_fused_f64(MLP_ARGS) {
    constexpr int lanes = 8;
    const size_t smem = (size_t)lanes * (std::max(H1, H3) + std::max(H2, F))
                        * sizeof(double);
    return launch<decltype(&mlp_fused_fma_kernel<lanes, double>), double,
                  double, double>(mlp_fused_fma_kernel<lanes, double>, lanes,
                                  smem, MLP_PASS);
}
