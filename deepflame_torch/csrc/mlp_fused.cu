// Fused stacked-species DF-ODENet MLP: x (B, F) through S per-species nets
// F -> H1 -> H2 -> H3 -> 1 with exact-erf GELU between layers -> out (B, S).
//
// Replaces deepflame_tpu/ops/pallas_kernels.py::mlp_fused_lanes (kernel
// _mlp_kernel), the DNN chemistry of the low-Mach step. Three modes, chosen by
// the weights' type:
//   bf16  x and W rounded to bf16, products summed in f32 on the tensor
//         cores, bias and GELU (erff) in f32, each hidden activation stored
//         as bf16; x, biases and out are f32. This is where the Pallas kernel
//         rounds.
//   f32   plain FMA on the CUDA cores, everything f32.
//   f64   plain FMA on the CUDA cores, everything f64.
//
// ---- bf16: what bounds it on an H100, and what the design does about it.
// At the DNN path's shapes (B = 884,736 cells, S = 8, widths
// 11 -> 1600 -> 800 -> 400 -> 1) one call is 22.9 TFLOP of products, 23.16 ms
// at the 989 TFLOP/s dense bf16 tensor-core peak: operations bound it. Three
// costs stand beside that bound:
//  1. The activations. One lane's hidden activations are 5.6 KB of bf16, so a
//     block's 227 KB of shared memory holds about 40 lanes, far too few for
//     the tensor cores to outrun the L2 reads of the weights (a tile of M lanes
//     does 2M operations per weight byte). So the activations go through
//     device memory in bf16, layer by layer, over chunks of lanes: h1 (S, C,
//     H1) and h2 (S, C, H2), scratch the wrapper allocates. That is 68 GB a
//     call (h1 and h2 written and read), 20.3 ms at 3.35 TB/s, under the
//     products of layers 2 and 3 that read them.
//  2. The products. Layers 2 and 3 are one persistent GEMM kernel: wgmma
//     m64n200k16 (A and B in shared memory, f32 accumulators in registers)
//     fed by TMA with 128-byte swizzle through a ring of 3 mbarrier stages.
//     One producer warp issues the loads and two consumer warpgroups the
//     wgmma, 128 lanes x 200 columns a tile; a block walks the tiles with a
//     stride of the grid, and consecutive tiles share their lanes (the column
//     tile varies fastest), so each activation tile is read from device
//     memory about once and from L2 by the blocks beside it. The weights are
//     packed K-major (W^T) once, by the caller, and loaded under an L2
//     evict-last policy; the activation tiles and the h2 stores are marked
//     evict-first / streaming.
//  3. The GELUs: 19.8 G exact-erf GELUs a call, 11.3 G of them in layer 1,
//     on the CUDA cores. In the GEMM kernel seven epilogue warps take each
//     finished tile from the consumers as f32 in shared memory and apply
//     bias, GELU and the bf16 rounding while the consumers run the next
//     tile's products, so the GELUs of layers 2 and 3 overlap the tensor
//     cores instead of following them. Layer 1 (K = 16, too thin for wgmma)
//     runs mma.sync m16n8k16 on the tensor cores and spends its CUDA-core
//     instructions on the GELUs and on 16-byte stores of h1.
// Layer 4 (the dot product with w4, plus b4) runs in layer 3's epilogue: each
// 40 columns of a row add their GELU activations times w4 into a partial sum
// (S, H3 / 40, C), and a last small kernel adds the partials in column order
// plus b4 (no atomics: the result is the same every run). Layer 3 thus takes
// the same 128 x 200 tiles as layer 2, not 64 lanes x all 400 columns, which
// would need 41 % more shared-memory fill per product.
//
// The f32 hand-off tile (104 KB) leaves room for 3 stages of 41 KB in the
// GEMM's ring. Clusters of two blocks sharing each weight tile by TMA
// multicast, and TMA prefetch of the activation tiles into L2, were tried
// and were slower; they are not used.
//
// bf16 kernels of one chunk of C lanes (n valid, m = n rounded up to 128):
//   mlp_fused_l1_kernel    x -> h1, grid (m / 128, S), 256 threads
//   mlp_fused_gemm_kernel  h1 -> h2, then h2 -> partials; persistent, one
//                          block of 512 threads per SM over (m / 128) x
//                          ceil(N / 200) x S tiles
//   mlp_fused_out_kernel   partials -> out, one thread per (lane, species)
// Rows n..m-1 see x = 0 and are computed but never written to out.
// Widths: K1 (F padded), H1, H2 and H3 multiples of 16. A last column tile
// narrower than 200 is masked in the epilogue (its weight rows past the
// species' own are read, or zero-filled by TMA past the tensor, and never
// stored); K past a multiple of 64 is zero-filled by TMA; layer 1 keeps x
// in registers for K1 up to 64 and re-reads it per product beyond.
// The walk over the lanes (chunk, launches, scratch layout) is decided here
// alone, by bf16_plan; the wrapper asks mlp_fused_bf16_plan for the scratch
// bytes and the entry point refuses a smaller scratch.
//
// ---- f32 and f64: one block owns a tile of lanes of one species and keeps
// its activations in shared memory through all four layers (16 lanes f32,
// 8 lanes f64); each thread computes whole columns on the CUDA cores.
//
// Entry points (plain C, launch on `stream`, return cudaGetLastError(), or
// -1 when a TMA descriptor cannot be made):
//   mlp_fused_bf16_plan(B, S, K1, H1, H2, H3, &chunk, &launches, &bytes)
//     the lanes of one chunk, the CUDA launches of one call and the bytes
//     of scratch it needs; cudaErrorInvalidValue for widths it does not take
//   mlp_fused_bf16(x, W1t, b1, W2t, b2, W3t, b3, W4, b4, out, scratch,
//                  scratch_bytes, B, F, K1, H1, H2, H3, S, stream)
//     W1t (S, H1, K1), W2t (S, H2, H1), W3t (S, H3, H2) row-major (K-major
//     operands); scratch at least the plan's bytes, 256-byte aligned (h1
//     (S, chunk, H1) and h2 (S, chunk, H2) bf16, layer 4's partials
//     (S, ceil(H3 / 40), chunk) f32). Launches 4 kernels per chunk of lanes.
//   mlp_fused_{f32,f64}(x, W1, b1, W2, b2, W3, b3, W4, b4, out,
//                       B, F, K1, H1, H2, H3, S, stream)
//     Wl (S, in, out) row-major.
// x (B, F); bl (S, out); W4 (S, H3, 1); out (B, S).
#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float gelu(float v) {
    return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}
__device__ __forceinline__ double gelu(double v) {
    return 0.5 * v * (1.0 + erf(v * 0.70710678118654752));
}
__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------ bf16 mode

constexpr int TILE_M = 128;       // lanes of a GEMM tile: two m64 warpgroups
constexpr int TILE_N = 200;       // wgmma N of a tile
constexpr int BK = 64;            // k per stage: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;                  // two consumer warpgroups
constexpr int PRODUCER = CONSUMERS;             // one producer warp
constexpr int EPILOGUE = CONSUMERS + 32;        // then the epilogue warps
constexpr int EPI_WARPS = 7;
constexpr int EPI_THREADS = 32 * EPI_WARPS;
constexpr int GEMM_THREADS = EPILOGUE + EPI_THREADS;    // 512
constexpr int SEG = 40;           // layer 4: columns of one partial sum
constexpr int A_BYTES = TILE_M * BK * 2;        // 16,384 B
constexpr int B_BYTES = TILE_N * BK * 2;        // 25,600 B, 25 x 1024
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 41,984 B
// f32 tile handed to the epilogue; rows padded to 204 floats so that the
// epilogue's 16-byte reads down a column hit 8 different bank groups
constexpr int EP_LD = TILE_N + 4;
constexpr int EP_BYTES = TILE_M * EP_LD * 4;    // 104,448 B
constexpr int GEMM_SMEM = 1024 + STAGES * STAGE_BYTES + EP_BYTES
                          + (2 * STAGES + 2) * 8;       // 231,488 B
constexpr int L1_ROWS = 128;      // layer 1: 16 lanes per warp, 8 warps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 1024-byte aligned start of the dynamic shared memory (the 128-byte swizzle
// pattern repeats every 8 rows of 128 B and is tied to the address bits)
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
    return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// L2 cache policies: evict_last for the weights, which every tile of a
// species reads again, evict_first for the activations, read by the few
// blocks beside each other and then dead
__device__ __forceinline__ uint64_t l2_evict_last() {
    uint64_t p;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
    return p;
}
__device__ __forceinline__ uint64_t l2_evict_first() {
    uint64_t p;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
    return p;
}

// TMA: the box at (column c0, row c1) of `map` into shared memory at dst,
// completion reported to `bar` as transferred bytes, under L2 policy `pol`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         uint64_t pol) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "l"(pol) : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with
// 128-byte swizzle: rows of 64 bf16 (128 B), 8-row groups 1024 B apart.
// Adding 2 to it moves the start 32 B (16 values of k) along the row.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)   // start address
           | ((uint64_t)1 << 16)                      // leading offset (unused)
           | ((uint64_t)(1024 >> 4) << 32)            // stride: 8 rows
           | ((uint64_t)1 << 62);                     // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// the accumulators are read or written only after the wgmma that owns them
__device__ __forceinline__ void fence_acc(float (&d)[100]) {
#pragma unroll
    for (int i = 0; i < 100; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 200, f32) += A (64 x 16) B (16 x 200), both K-major in shared
// memory. Thread t of the warpgroup holds d[4j + q] at row
// 16 (t / 32) + (t % 32) / 4 + 8 (q / 2), column 8 j + 2 (t % 4) + q % 2.
__device__ __forceinline__ void wgmma_m64n200(float (&d)[100], uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99}, %100, %101, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99])
        : "l"(da), "l"(db), "r"(1));
}

// d (16 x 8, f32) += A (16 x 16) B (16 x 8), bf16 fragments in registers
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of k step ks for lanes r and r + 8 of x: a[i] holds lane
// r + 8 (i % 2), k = 16 ks + 2 q + 8 (i / 2) and k + 1, rounded to bf16 and
// zero past F and past n
__device__ __forceinline__ void x_fragment(uint32_t (&a)[4],
                                           const float* __restrict__ x, int r,
                                           int n, int F, int ks, int q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = r + 8 * (i % 2), k = 16 * ks + 2 * q + 8 * (i / 2);
        const float* xr = x + (size_t)row * F;
        a[i] = bf16x2_bits(row < n && k < F ? xr[k] : 0.0f,
                           row < n && k + 1 < F ? xr[k + 1] : 0.0f);
    }
}

// Layer 1: h1[s, r, :] = bf16(gelu(bf16(x[r]) W1[s] + b1[s])) on the tensor
// cores (mma.sync m16n8k16). Warp w takes lanes r0 + 16 w .. +16. With
// KS = K1 / 16 (at most 4) its x rows stay in A fragments in registers; with
// KS = 0 (any K1) each product reads its fragment from x again (L1). It
// walks H1 in 32-column steps, four 8-column products each (those past H1,
// a multiple of 16, are skipped), reading each B fragment as two 32-bit
// loads of W1^T (K-major, cached in L1). The bf16 results go through the
// warp's 16 x 32 patch of shared memory (rows of 20 words: the fragment
// writes and the 16-byte reads are free of bank conflicts) and out with
// 16-byte stores, a whole 32-byte sector per row.
template <int KS>
__global__ void __launch_bounds__(THREADS)
mlp_fused_l1_kernel(const float* __restrict__ x, const bf16* __restrict__ W1t,
                    const float* __restrict__ b1, bf16* __restrict__ h1,
                    int n, int C, int F, int K1, int H1) {
    constexpr int LD = 20;                    // patch row: 16 words + 4
    __shared__ __align__(16) uint32_t patch[WARPS][16 * LD];
    const int s = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, q = lane % 4;
    const int r0 = blockIdx.x * L1_ROWS + warp * 16, r = r0 + g;   // and r + 8
    const int ksteps = KS > 0 ? KS : K1 / 16;
    uint32_t a[KS > 0 ? KS : 1][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) x_fragment(a[ks], x, r, n, F, ks, q);
    const bf16* w = W1t + ((size_t)s * H1 + g) * K1 + 2 * q;
    const float* bias = b1 + (size_t)s * H1 + 2 * q;
    uint32_t* p = patch[warp];
    // this thread's two 16-byte pieces of the patch: row lane % 16, words
    // pc .. pc + 7, columns n0 + 2 pc .. + 15
    const int pr = lane % 16, pc = 8 * (lane / 16);
    bf16* o = h1 + ((size_t)s * C + r0 + pr) * H1 + 2 * pc;
    for (int n0 = 0; n0 < H1; n0 += 32) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            if (n0 + 8 * t >= H1) break;      // the same for the whole warp
            float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int ks = 0; ks < ksteps; ++ks) {
                if (KS == 0) x_fragment(a[0], x, r, n, F, ks, q);
                const uint32_t* wk = reinterpret_cast<const uint32_t*>(
                    w + (size_t)(n0 + 8 * t) * K1 + 16 * ks);
                mma_m16n8k16(d, a[KS > 0 ? ks : 0], __ldg(wk), __ldg(wk + 4));
            }
            const float2 bb = __ldg(reinterpret_cast<const float2*>(
                bias + n0 + 8 * t));
            // columns n0 + 8 t + 2 q, + 1 of lanes r and r + 8: word 4 t + q
            p[g * LD + 4 * t + q] =
                bf16x2_bits(gelu(d[0] + bb.x), gelu(d[1] + bb.y));
            p[(g + 8) * LD + 4 * t + q] =
                bf16x2_bits(gelu(d[2] + bb.x), gelu(d[3] + bb.y));
        }
        __syncwarp();
        if (n0 + 2 * pc < H1) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
                *reinterpret_cast<uint4*>(o + n0 + 8 * h) =
                    *reinterpret_cast<const uint4*>(p + pr * LD + pc + 4 * h);
        }
        __syncwarp();
    }
}

struct Tile { int s, m0, n0; };

// tile i of the (S, m_tiles, nt) walk, the column tile fastest
__device__ __forceinline__ Tile tile_at(int i, int m_tiles, int nt) {
    const int per = m_tiles * nt, r = i % per;
    return {i / per, (r / nt) * TILE_M, (r % nt) * TILE_N};
}

// Layers 2 and 3: for each tile (s, m0, n0), v = A[s, m0:m0+128, :K]
// Bt[s, n0:n0+200, :K]^T + bias[s, n0:n0+200] and then, for the columns
// n0 + c < N,
//   LAST = false: h_out[s, m0 + r, n0 + c] = bf16(gelu(v))   (h2, width N)
//   LAST = true:  part[s, (n0 + c0) / 40, m0 + r]
//                   = sum_{c0 <= c < c0 + 40} bf16(gelu(v)) w4[s, n0 + c]
// A (S * C, K) and Bt (S * N, K) bf16 through TMA maps. Persistent: block b
// takes tiles b, b + grid, ... Roles: threads 0-255 two consumer warpgroups (rows 0-63 and 64-127 of the
// tile, 100 f32 accumulators a thread), 256 the producer, 288-511 the
// epilogue warps. The producer runs ahead into the next tile while the
// consumers hand a finished tile to the epilogue through shared memory
// (ep_full / ep_empty), so loads, products and GELUs overlap.
template <bool LAST>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
mlp_fused_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const float* __restrict__ bias,
                      const bf16* __restrict__ w4, bf16* __restrict__ h_out,
                      float* __restrict__ part, int C, int m_tiles, int K,
                      int N, int tiles) {
    extern __shared__ uint8_t gemm_raw[];
    uint8_t* stages = aligned_smem(gemm_raw);
    float* ep = reinterpret_cast<float*>(stages + STAGES * STAGE_BYTES);
    uint64_t* full = reinterpret_cast<uint64_t*>(ep + TILE_M * EP_LD);
    uint64_t* empty = full + STAGES;
    uint64_t* ep_full = empty + STAGES;
    uint64_t* ep_empty = ep_full + 1;
    const int t = threadIdx.x, nt = (N + TILE_N - 1) / TILE_N;
    if (t == 0) {
        for (int i = 0; i < STAGES; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], CONSUMERS / 32);
        }
        mbar_init(ep_full, CONSUMERS);
        mbar_init(ep_empty, EPI_THREADS);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (t >= EPILOGUE) {                                   // epilogue
        const int e = t - EPILOGUE;
        uint32_t ep_phase = 0;
        for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
            const Tile tl = tile_at(i, m_tiles, nt);
            const float* b = bias + (size_t)tl.s * N + tl.n0;
            const int nv = min(TILE_N, N - tl.n0);         // valid columns
            mbar_wait(ep_full, ep_phase);
            if (!LAST) {
                // 4 columns of one row an item: one 16-byte read, one 8-byte
                // store; a warp's stores cover 256 contiguous bytes, marked
                // streaming so that they do not push the weights out of L2
                bf16* o = h_out + ((size_t)tl.s * C + tl.m0) * N + tl.n0;
                for (int it = e; it < TILE_M * (TILE_N / 4); it += EPI_THREADS) {
                    const int row = it / (TILE_N / 4), col = 4 * (it % (TILE_N / 4));
                    if (col >= nv) continue;
                    const float4 v = *reinterpret_cast<const float4*>(
                        ep + row * EP_LD + col);
                    const float4 bb = __ldg(reinterpret_cast<const float4*>(b + col));
                    uint2 u;
                    u.x = bf16x2_bits(gelu(v.x + bb.x), gelu(v.y + bb.y));
                    u.y = bf16x2_bits(gelu(v.z + bb.z), gelu(v.w + bb.w));
                    __stcs(reinterpret_cast<uint2*>(o + (size_t)row * N + col), u);
                }
            } else {
                // 40 columns of one row an item, in order; a segment that
                // reaches past N sums its valid columns only
                const bf16* w = w4 + (size_t)tl.s * N + tl.n0;
                const int nseg = (N + SEG - 1) / SEG;
                float* pt = part + ((size_t)tl.s * nseg + tl.n0 / SEG) * C
                            + tl.m0;
                for (int it = e; it < TILE_M * (TILE_N / SEG); it += EPI_THREADS) {
                    const int row = it / (TILE_N / SEG), c0 = SEG * (it % (TILE_N / SEG));
                    if (c0 >= nv) continue;
                    const float* v_row = ep + row * EP_LD;
                    float p = 0.0f;
#pragma unroll 5
                    for (int col = c0; col < c0 + SEG; col += 4) {
                        if (col >= nv) break;
                        const float4 v = *reinterpret_cast<const float4*>(v_row + col);
                        const float4 bb = __ldg(reinterpret_cast<const float4*>(b + col));
                        const uint2 wr = __ldg(reinterpret_cast<const uint2*>(w + col));
                        const float2 w01 = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(&wr.x));
                        const float2 w23 = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(&wr.y));
                        p += round_bf16(gelu(v.x + bb.x)) * w01.x;
                        p += round_bf16(gelu(v.y + bb.y)) * w01.y;
                        p += round_bf16(gelu(v.z + bb.z)) * w23.x;
                        p += round_bf16(gelu(v.w + bb.w)) * w23.y;
                    }
                    pt[(size_t)(c0 / SEG) * C + row] = p;
                }
            }
            mbar_arrive(ep_empty);
            ep_phase ^= 1;
        }
    } else if (t >= CONSUMERS) {                           // producer
        if (t == PRODUCER) {
            const uint64_t pol_a = l2_evict_first(), pol_b = l2_evict_last();
            int stage = 0;
            uint32_t phase = 0;
            for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
                const Tile tl = tile_at(i, m_tiles, nt);
                for (int k0 = 0; k0 < K; k0 += BK) {
                    mbar_wait(&empty[stage], phase ^ 1);
                    mbar_expect_tx(&full[stage], STAGE_BYTES);
                    uint8_t* sp = stages + stage * STAGE_BYTES;
                    tma_load(sp, &map_a, &full[stage], k0, tl.s * C + tl.m0,
                             pol_a);
                    tma_load(sp + A_BYTES, &map_b, &full[stage], k0,
                             tl.s * N + tl.n0, pol_b);
                    if (++stage == STAGES) { stage = 0; phase ^= 1; }
                }
            }
        }
    } else {                                               // consumers
        // warpgroup g computes rows 64 g .. 64 g + 63 of each tile. A stage
        // is released once the wgmma of the next one has been issued and its
        // own has completed. Past K the TMA boxes are zero-filled, so a last
        // partial stage adds zeros; every k step is issued (a wgmma under a
        // condition makes ptxas serialize them all).
        const int g = t / 128, warp = (t % 128) / 32, lane = t % 32;
        const int r = g * 64 + warp * 16 + lane / 4, c = 2 * (lane % 4);
        int stage = 0;
        uint32_t phase = 0, ep_phase = 0;
        float d[100];
        for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
#pragma unroll
            for (int j = 0; j < 100; ++j) d[j] = 0.0f;
            fence_acc(d);
            int prev = -1;
            for (int k0 = 0; k0 < K; k0 += BK) {
                mbar_wait(&full[stage], phase);
                uint8_t* sp = stages + stage * STAGE_BYTES;
                const uint64_t da = sw128_desc(sp + g * 64 * BK * 2);
                const uint64_t db = sw128_desc(sp + A_BYTES);
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < BK / 16; ++k)
                    wgmma_m64n200(d, da + 2 * k, db + 2 * k);
                wgmma_commit();
                wgmma_wait<1>();
                if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
                prev = stage;
                if (++stage == STAGES) { stage = 0; phase ^= 1; }
            }
            wgmma_wait<0>();
            fence_acc(d);
            if (lane == 0) mbar_arrive(&empty[prev]);
            // hand the tile to the epilogue once it has read the last one
            mbar_wait(ep_empty, ep_phase ^ 1);
#pragma unroll
            for (int j = 0; j < TILE_N / 8; ++j) {
                *reinterpret_cast<float2*>(ep + r * EP_LD + 8 * j + c) =
                    make_float2(d[4 * j], d[4 * j + 1]);
                *reinterpret_cast<float2*>(ep + (r + 8) * EP_LD + 8 * j + c) =
                    make_float2(d[4 * j + 2], d[4 * j + 3]);
            }
            mbar_arrive(ep_full);
            ep_phase ^= 1;
        }
    }
}

// Layer 4's sum: out[r, s] = (part[s, 0, r] + part[s, 1, r] + ...) + b4[s]
__global__ void mlp_fused_out_kernel(const float* __restrict__ part,
                                     const float* __restrict__ b4,
                                     float* __restrict__ out, int n, int C,
                                     int S, int nseg) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n * S) return;
    const int r = i / S, s = i % S;
    float v = 0.0f;
    for (int j = 0; j < nseg; ++j) v += part[((size_t)s * nseg + j) * C + r];
    out[i] = v + b4[s];
}

// The bf16 walk over B lanes: chunks of `chunk` lanes (2^19 lanes x species
// a chunk, cut to the 128-lane tile, or all B lanes when fewer), 4 launches
// each, and the scratch of one chunk: h1, h2 and layer 4's partials, each
// starting on a 256-byte boundary.
constexpr long CHUNK_LANE_SPECIES = 1L << 19;
constexpr int BF16_LAUNCHES = 4;

struct Plan {
    int chunk = 0, launches = 0;
    size_t h2_at = 0, part_at = 0, bytes = 0;
};

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

bool bf16_plan(long B, int S, int K1, int H1, int H2, int H3, Plan* p) {
    if (B < 0 || S <= 0 || K1 <= 0 || H1 <= 0 || H2 <= 0 || H3 <= 0
        || K1 % 16 || H1 % 16 || H2 % 16 || H3 % 16)
        return false;
    const long tiles = (B + TILE_M - 1) / TILE_M;
    const long most = std::max<long>(1, CHUNK_LANE_SPECIES / S / TILE_M);
    p->chunk = (int)(TILE_M * std::max<long>(1, std::min(most, tiles)));
    p->launches = (int)(BF16_LAUNCHES * ((B + p->chunk - 1) / p->chunk));
    const size_t lanes = (size_t)S * p->chunk;
    p->h2_at = align256(lanes * H1 * sizeof(bf16));
    p->part_at = p->h2_at + align256(lanes * H2 * sizeof(bf16));
    p->bytes = p->part_at + lanes * ((H3 + SEG - 1) / SEG) * sizeof(float);
    return true;
}

// cuTensorMapEncodeTiled, fetched from the driver at run time so that the
// library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (err != cudaSuccess || q != cudaDriverEntryPointSuccess)
            p = nullptr;
        return reinterpret_cast<EncodeTiled>(p);
    }();
    return fn;
}

// TMA descriptor of a row-major (rows, cols) bf16 matrix read in boxes of
// box_rows x 64 with 128-byte swizzle; reads past the edges give zeros
bool bf16_map(CUtensorMap* map, const void* base, uint64_t rows,
              uint64_t cols, uint32_t box_rows) {
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {cols * sizeof(bf16)};
    const cuuint32_t box[2] = {BK, box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KS>
void launch_l1(dim3 grid, cudaStream_t st, const void* x, const void* W1t,
               const void* b1, void* h1, int n, int C, int F, int K1, int H1) {
    mlp_fused_l1_kernel<KS><<<grid, THREADS, 0, st>>>(
        (const float*)x, (const bf16*)W1t, (const float*)b1, (bf16*)h1, n, C,
        F, K1, H1);
}

// ------------------------------------------------------ f32 and f64 modes

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

template <typename K, typename T>
int launch_fma(K kernel, int lanes, size_t smem, const void* x, const void* W1,
               const void* b1, const void* W2, const void* b2, const void* W3,
               const void* b3, const void* W4, const void* b4, void* out,
               int B, int F, int K1, int H1, int H2, int H3, int S,
               void* stream) {
    if (B <= 0) return 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((B + lanes - 1) / lanes, S);
    kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)W1, (const T*)b1, (const T*)W2, (const T*)b2,
        (const T*)W3, (const T*)b3, (const T*)W4, (const T*)b4, (T*)out, B,
        F, K1, H1, H2, H3, S);
    return (int)cudaGetLastError();
}

// one persistent GEMM launch: a block per SM, at most one per tile
template <bool LAST>
cudaError_t launch_gemm(cudaStream_t st, const CUtensorMap& a,
                        const CUtensorMap& b, const float* bias, const bf16* w4,
                        bf16* h_out, float* part, int C, int m_tiles, int K,
                        int N, int S, int sms) {
    cudaError_t err = cudaFuncSetAttribute(
        mlp_fused_gemm_kernel<LAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        GEMM_SMEM);
    if (err != cudaSuccess) return err;
    const int tiles = m_tiles * ((N + TILE_N - 1) / TILE_N) * S;
    mlp_fused_gemm_kernel<LAST><<<std::min(tiles, sms), GEMM_THREADS,
                                  GEMM_SMEM, st>>>(
        a, b, bias, w4, h_out, part, C, m_tiles, K, N, tiles);
    return cudaGetLastError();
}

}  // namespace

extern "C" int mlp_fused_bf16_plan(long long B, int S, int K1, int H1, int H2,
                                   int H3, int* chunk, int* launches,
                                   long long* bytes) {
    Plan p;
    if (!bf16_plan((long)B, S, K1, H1, H2, H3, &p))
        return (int)cudaErrorInvalidValue;
    *chunk = p.chunk;
    *launches = p.launches;
    *bytes = (long long)p.bytes;
    return 0;
}

extern "C" int mlp_fused_bf16(const void* x, const void* W1t, const void* b1,
                              const void* W2t, const void* b2,
                              const void* W3t, const void* b3, const void* W4,
                              const void* b4, void* out, void* scratch,
                              long long scratch_bytes, int B, int F, int K1,
                              int H1, int H2, int H3, int S, void* stream) {
    Plan plan;
    if (!bf16_plan(B, S, K1, H1, H2, H3, &plan) || F > K1
        || (B > 0 && (scratch_bytes < (long long)plan.bytes
                      || reinterpret_cast<uintptr_t>(scratch) % 256)))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const int chunk = plan.chunk;
    uint8_t* base = static_cast<uint8_t*>(scratch);
    void* h1 = base;
    void* h2 = base + plan.h2_at;
    void* part = base + plan.part_at;
    CUtensorMap map_h1, map_w2, map_h2, map_w3;
    if (!bf16_map(&map_h1, h1, (uint64_t)S * chunk, H1, TILE_M)
        || !bf16_map(&map_w2, W2t, (uint64_t)S * H2, H1, TILE_N)
        || !bf16_map(&map_h2, h2, (uint64_t)S * chunk, H2, TILE_M)
        || !bf16_map(&map_w3, W3t, (uint64_t)S * H3, H2, TILE_N))
        return -1;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    for (long c0 = 0; c0 < B; c0 += chunk) {
        const int n = (int)std::min<long>(chunk, B - c0);
        const int m_tiles = (n + TILE_M - 1) / TILE_M;
        const dim3 l1_grid(m_tiles * TILE_M / L1_ROWS, S);
        const void* xc = (const float*)x + c0 * F;
        switch (K1 / 16) {
            case 1: launch_l1<1>(l1_grid, st, xc, W1t, b1, h1, n, chunk, F, K1, H1); break;
            case 2: launch_l1<2>(l1_grid, st, xc, W1t, b1, h1, n, chunk, F, K1, H1); break;
            case 3: launch_l1<3>(l1_grid, st, xc, W1t, b1, h1, n, chunk, F, K1, H1); break;
            case 4: launch_l1<4>(l1_grid, st, xc, W1t, b1, h1, n, chunk, F, K1, H1); break;
            default: launch_l1<0>(l1_grid, st, xc, W1t, b1, h1, n, chunk, F, K1, H1); break;
        }
        err = cudaGetLastError();
        if (err == cudaSuccess)
            err = launch_gemm<false>(st, map_h1, map_w2, (const float*)b2,
                                     nullptr, (bf16*)h2, nullptr, chunk,
                                     m_tiles, H1, H2, S, sms);
        if (err == cudaSuccess)
            err = launch_gemm<true>(st, map_h2, map_w3, (const float*)b3,
                                    (const bf16*)W4, nullptr, (float*)part,
                                    chunk, m_tiles, H2, H3, S, sms);
        if (err != cudaSuccess) return (int)err;
        mlp_fused_out_kernel<<<(n * S + 255) / 256, 256, 0, st>>>(
            (const float*)part, (const float*)b4, (float*)out + c0 * S, n,
            chunk, S, (H3 + SEG - 1) / SEG);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

#define MLP_ARGS const void *x, const void *W1, const void *b1, const void *W2, \
    const void *b2, const void *W3, const void *b3, const void *W4,            \
    const void *b4, void *out, int B, int F, int K1, int H1, int H2, int H3,   \
    int S, void *stream
#define MLP_PASS x, W1, b1, W2, b2, W3, b3, W4, b4, out, B, F, K1, H1, H2, H3, \
    S, stream

extern "C" int mlp_fused_f32(MLP_ARGS) {
    constexpr int lanes = 16;
    const size_t smem = (size_t)lanes * (std::max(H1, H3) + std::max(H2, F))
                        * sizeof(float);
    return launch_fma<decltype(&mlp_fused_fma_kernel<lanes, float>), float>(
        mlp_fused_fma_kernel<lanes, float>, lanes, smem, MLP_PASS);
}

extern "C" int mlp_fused_f64(MLP_ARGS) {
    constexpr int lanes = 8;
    const size_t smem = (size_t)lanes * (std::max(H1, H3) + std::max(H2, F))
                        * sizeof(double);
    return launch_fma<decltype(&mlp_fused_fma_kernel<lanes, double>), double>(
        mlp_fused_fma_kernel<lanes, double>, lanes, smem, MLP_PASS);
}
