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
//   f32   everything f32, products on the CUDA cores (FFMA).
//   f64   everything f64, products of layers 2 and 3 on the FP64 tensor
//         cores (DMMA), each a fused multiply-add in f64.
// All three walk the lanes the same way: layer by layer through scratch in
// device memory, over chunks of lanes, four launches a chunk.
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
// The walk over the lanes (chunk, launches, scratch layout) of every mode is
// decided here alone, by make_plan; the wrapper asks mlp_fused_plan for the
// scratch bytes and the entry points refuse a smaller scratch.
//
// ---- f32 and f64: what bounds them, and what the design does about it.
// At the DNN path's widths one lane of one species is 3.24 MFLOP, 98.6 % of
// it in layers 2 and 3, and 9.6 KB of f32 hidden activations (19.2 KB f64).
// At B = 884,736 and S = 8 an f32 call is 22.9 TFLOP, 342 ms at the 67
// TFLOP/s FP32 CUDA-core peak: operations bind it, and bind it only if each
// weight fetched into a block serves many lanes and each activation many
// columns. So the modes take the bf16 mode's walk: h1 (S, C, H1) and h2
// (S, C, H2) in the mode's type go through scratch over chunks of C lanes
// (2^20 / 4 lanes x species a chunk in f32, C = 32,768 at S = 8; 2^20 / 8 in
// f64), about 2.5 GB like bf16's. Their rows are padded to a multiple of 4
// values, so every row starts on 16 bytes. Per chunk:
//   mlp_fused_l1_fma_kernel  x -> h1 on the CUDA cores (K1 = 16 is too thin
//       for a tile): a block per 32 lanes x 128 columns, bias and exact
//       GELU, each row of h1 leaving as 16-byte streaming stores. x is read
//       from L1 per product (holding it in registers was measured slower:
//       in f64 it took 254 registers, one block an SM).
//   mlp_fused_sgemm_kernel (f32) / mlp_fused_dgemm_kernel (f64): layers 2
//       and 3, h_out = gelu(h_in W + b) per species, one block per tile of
//       128 lanes x 128 (f32) or 64 (f64) columns, the column tile fastest
//       so that the blocks beside each other read one h_in tile (from L2
//       after the first). A and W k-slices go through a cp.async ring in
//       shared memory, masked (zero-filled) past K and N, so any width is
//       taken. Weights are read once per 128-lane tile: 354 GB of L2 reads
//       at B = 884,736 in f32, against 2.88 TB for blocks of 16 lanes that
//       keep their activations in shared memory.
//       f32: 256 threads, each an 8 x 8 register tile, two blocks an SM, 3
//       stages of 16 k. A is staged k-major (4-byte copies), so a k step
//       reads 2 + 2 float4 of shared memory for 64 FMAs (conflict-free: A's
//       read is a broadcast, B's 16 contiguous float4).
//       f64: 4 warps of 64 x 32 on mma.sync m16n8k4 f64 (DMMA), f64
//       accumulators, 2 stages of 32 k, two blocks an SM, so that one
//       block's GELUs (exact erf in f64, on the FP64 CUDA cores) overlap the
//       other's products; rows of the stages padded (36 and 68 doubles) so
//       that the fragment loads are free of bank conflicts.
//       Epilogue: bias and GELU, streaming 16-byte stores of h2; for layer 3
//       instead the dot product with w4 of the tile's columns, reduced
//       across the threads of a row by shuffles in a fixed order, into
//       partials (S, nseg, C): one per 128 columns in f32, per 32 in f64.
//       A column tile with no valid column for half (f32) or a warp (f64)
//       of it skips those products.
//   mlp_fused_out_kernel  partials -> out in column order, plus b4.
// No atomics anywhere: the result is the same every run.
//
// Entry points (plain C, launch on `stream`, return cudaGetLastError(),
// cudaErrorInvalidValue for what they do not take, or -1 when a TMA
// descriptor cannot be made):
//   mlp_fused_plan(size, B, S, K1, H1, H2, H3, &chunk, &launches, &bytes)
//     mode `size` (bytes of a value: 2 bf16, 4 f32, 8 f64): the lanes of
//     one chunk, the CUDA launches of one call and the bytes of scratch it
//     needs; cudaErrorInvalidValue for widths the mode does not take
//     (bf16: K1, H1, H2, H3 multiples of 16; f32, f64: any width >= 1)
//   mlp_fused_{bf16,f32,f64}(x, W1, b1, W2, b2, W3, b3, W4, b4, out,
//                            scratch, scratch_bytes, B, F, K1, H1, H2, H3,
//                            S, stream)
//     bf16: W1 (S, H1, K1), W2 (S, H2, H1), W3 (S, H3, H2) row-major
//     (K-major operands); f32, f64: Wl (S, in, out) row-major. Scratch at
//     least the plan's bytes, 256-byte aligned. Launches 4 kernels per chunk
//     of lanes.
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
// (T float in bf16 and f32, double in f64)
template <typename T>
__global__ void mlp_fused_out_kernel(const T* __restrict__ part,
                                     const T* __restrict__ b4,
                                     T* __restrict__ out, int n, int C,
                                     int S, int nseg) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n * S) return;
    const int r = i / S, s = i % S;
    T v = 0;
    for (int j = 0; j < nseg; ++j) v += part[((size_t)s * nseg + j) * C + r];
    out[i] = v + b4[s];
}

// f32 GEMM tiles: TILE_M lanes x FMA_N columns, k slices of SK values, a
// ring of FMA_STAGES. f64 tiles: TILE_M x DN (2 x DWN warps of 64 x 32),
// k slices of DK, a ring of DSTAGES; DMMA_K is the k of one f64 product
// (mma.sync m16n8k4, k8 or k16). The defaults are the measured best of the
// variants tools/mlp_fused_ablate.py builds from these defines.
#ifndef MLP_F32_STAGE_K
#define MLP_F32_STAGE_K 16
#endif
#ifndef MLP_F64_STAGE_K
#define MLP_F64_STAGE_K 32
#endif
#ifndef MLP_F64_MMA_K
#define MLP_F64_MMA_K 4
#endif
#ifndef MLP_F64_WARPS_N
#define MLP_F64_WARPS_N 2
#endif
#ifndef MLP_F64_STAGES
#define MLP_F64_STAGES 2
#endif
#ifndef MLP_F32_MIN_BLOCKS
#define MLP_F32_MIN_BLOCKS 2
#endif
constexpr int FMA_N = 128;
constexpr int SK = MLP_F32_STAGE_K;
constexpr int FMA_STAGES = 3;
constexpr int DK = MLP_F64_STAGE_K;
constexpr int DMMA_K = MLP_F64_MMA_K;
constexpr int DWN = MLP_F64_WARPS_N;
constexpr int DN = 32 * DWN;
constexpr int DTHREADS = 64 * DWN;
constexpr int DSTAGES = MLP_F64_STAGES;
static_assert(SK % 16 == 0 && DK % 16 == 0 && DK % DMMA_K == 0
              && (DMMA_K == 4 || DMMA_K == 8 || DMMA_K == 16)
              && (DWN == 2 || DWN == 4) && DSTAGES >= 2,
              "stage k: a multiple of 16; DMMA k: 4, 8 or 16; 2 or 4 warp "
              "columns; 2 stages or more");
constexpr int SEG_F64 = 32;       // f64 layer 4: columns of one partial sum

// The walk over B lanes in mode `size` (bytes of a value: 2 bf16, 4 f32, 8
// f64): chunks of `chunk` lanes (2^20 / size lanes x species a chunk, cut
// to the 128-lane tile, or all B lanes when fewer), 4 launches each, and
// the scratch of one chunk: h1 (S, chunk, ld1) and h2 (S, chunk, ld2) in
// the mode's type, then layer 4's partials (S, nseg, chunk), f32 in bf16,
// each starting on a 256-byte boundary. The row strides are the widths in
// bf16, the widths rounded up to 4 values in f32 and f64.
constexpr long CHUNK_BYTES = 1L << 20;
constexpr int LAUNCHES = 4;

struct Plan {
    int chunk = 0, launches = 0, ld1 = 0, ld2 = 0, nseg = 0;
    size_t h2_at = 0, part_at = 0, bytes = 0;
};

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

bool make_plan(int size, long B, int S, int K1, int H1, int H2, int H3,
               Plan* p) {
    const bool bf16 = size == 2;
    if (B < 0 || S <= 0 || K1 <= 0 || H1 <= 0 || H2 <= 0 || H3 <= 0
        || (bf16 ? (K1 % 16 || H1 % 16 || H2 % 16 || H3 % 16)
                 : size != 4 && size != 8))
        return false;
    const long tiles = (B + TILE_M - 1) / TILE_M;
    const long most = std::max<long>(1, CHUNK_BYTES / size / S / TILE_M);
    p->chunk = (int)(TILE_M * std::max<long>(1, std::min(most, tiles)));
    p->launches = (int)(LAUNCHES * ((B + p->chunk - 1) / p->chunk));
    p->ld1 = bf16 ? H1 : (H1 + 3) / 4 * 4;
    p->ld2 = bf16 ? H2 : (H2 + 3) / 4 * 4;
    const int seg = bf16 ? SEG : size == 4 ? FMA_N : SEG_F64;
    p->nseg = (H3 + seg - 1) / seg;
    const size_t lanes = (size_t)S * p->chunk;
    p->h2_at = align256(lanes * p->ld1 * size);
    p->part_at = p->h2_at + align256(lanes * p->ld2 * size);
    p->bytes = p->part_at + lanes * p->nseg * (bf16 ? sizeof(float) : size);
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

// ------------------------------------------------------ f32 and f64 modes

constexpr int L1_LANES = 32;              // layer 1: lanes of a block, 4 a warp
// layer 1 holds x in registers for F up to L1_KR (0: never; measured
// slower, tools/mlp_fused_ablate.py)
#ifndef MLP_L1_KR
#define MLP_L1_KR 0
#endif
constexpr int L1_KR = MLP_L1_KR;
// blocks of layer 1 an SM at least (their GELUs are long dependent chains
// of f64 FMAs: more warps hide them)
#ifndef MLP_L1_MIN_BLOCKS
#define MLP_L1_MIN_BLOCKS 4
#endif
constexpr int L1_MIN_BLOCKS = MLP_L1_MIN_BLOCKS;
constexpr int SA_LD = TILE_M + 4;         // f32: a k row of an A stage
constexpr int SGEMM_SMEM = FMA_STAGES * SK * (SA_LD + FMA_N) * 4;  // 49,920 B
constexpr int DA_LD = DK + 4;          // f64: a lane row of an A stage
constexpr int DB_LD = DN + 4;             // f64: a k row of a W stage
constexpr int DGEMM_SMEM = DSTAGES * (TILE_M * DA_LD + DK * DB_LD) * 8;
                                          // 108,544 B by default

// asynchronous copy of `bytes` (4, 8 or 16) from device to shared memory,
// of which the first `valid` are read and the rest zero-filled; src must be
// a valid address even when valid is 0
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int valid) {
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     :: "r"(smem_u32(dst)), "l"(src), "r"(valid) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                     :: "r"(smem_u32(dst)), "l"(src), "n"(BYTES), "r"(valid)
                     : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// 4 consecutive values from read-only memory: one or two 16-byte loads when
// VEC (p 16-byte aligned) and all 4 are valid, else `valid` scalar loads
// and zeros
__device__ __forceinline__ void ldg_vec4(const float* p, float (&v)[4]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void ldg_vec4(const double* p, double (&v)[4]) {
    const double2 u = __ldg(reinterpret_cast<const double2*>(p));
    const double2 w = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = u.x; v[1] = u.y; v[2] = w.x; v[3] = w.y;
}
template <bool VEC, typename T>
__device__ __forceinline__ void ldg4(const T* __restrict__ p, int valid,
                                     T (&v)[4]) {
    if (VEC && valid >= 4) {
        ldg_vec4(p, v);
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = j < valid ? __ldg(p + j) : T(0);
    }
}
// 4 consecutive values to a 16-byte aligned address, streaming (evict-first)
__device__ __forceinline__ void stcs4(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void stcs4(double* p, const double (&v)[4]) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
    __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]));
}
__device__ __forceinline__ float fma_t(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
    return fma(a, b, c);
}
template <typename T>
__device__ __forceinline__ T ldg_or_0(const T* __restrict__ p, int i, int n) {
    return i < n ? __ldg(p + i) : T(0);
}

// Layer 1: h1[s, r, c] = gelu(sum_{k < F} x[r, k] W1[s, k, c] + b1[s, c]).
// A block takes 32 lanes of one species and 128 columns (blockIdx.z), warp
// w lanes r0 .. r0 + 3, its 32 threads 4 columns each, so that a row of h1
// leaves as 512 contiguous bytes of 16-byte streaming stores. With KR > 0
// (F <= KR) the warp's x rows are held in registers; with KR = 0 (any F)
// each product reads x again (one address for the whole warp, from L1). W1's
// rows F..K1-1 (padding) are never read. VEC: H1 a multiple of 16 bytes and
// W1, b1 16-byte aligned.
template <typename T, int KR, bool VEC>
__global__ void __launch_bounds__(THREADS, L1_MIN_BLOCKS)
mlp_fused_l1_fma_kernel(const T* __restrict__ x, const T* __restrict__ W1,
                        const T* __restrict__ b1, T* __restrict__ h1,
                        int ld1, int n, int C, int F, int K1, int H1) {
    const int s = blockIdx.y, lane = threadIdx.x % 32;
    const int r0 = blockIdx.x * L1_LANES + 4 * (threadIdx.x / 32);
    T xr[4][KR > 0 ? KR : 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < KR; ++k)
            xr[i][k] = r0 + i < n && k < F
                       ? __ldg(x + (size_t)(r0 + i) * F + k) : T(0);
    const T* w = W1 + (size_t)s * K1 * H1;
    const T* b = b1 + (size_t)s * H1;
    T* o = h1 + ((size_t)s * C + r0) * ld1;
    const int c = 128 * blockIdx.z + 4 * lane;
    if (c < H1) {
        T acc[4][4] = {};
        if constexpr (KR > 0) {
#pragma unroll
            for (int k = 0; k < KR; ++k) {
                if (k >= F) break;
                T wk[4];
                ldg4<VEC>(w + (size_t)k * H1 + c, H1 - c, wk);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fma_t(xr[i][k], wk[j], acc[i][j]);
            }
        } else {
            for (int k = 0; k < F; ++k) {
                T wk[4];
                ldg4<VEC>(w + (size_t)k * H1 + c, H1 - c, wk);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const T xi = r0 + i < n
                                 ? __ldg(x + (size_t)(r0 + i) * F + k) : T(0);
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fma_t(xi, wk[j], acc[i][j]);
                }
            }
        }
        T bb[4];
        ldg4<VEC>(b + c, H1 - c, bb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            T v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = gelu(acc[i][j] + bb[j]);
            stcs4(o + (size_t)i * ld1 + c, v);        // c + 3 < ld1
        }
    }
}

// tile (s, m0, n0) of block b in the (S, m_tiles, nt) walk, the column tile
// fastest
__device__ __forceinline__ Tile fma_tile(int m_tiles, int nt, int tn) {
    const int per = m_tiles * nt, r = blockIdx.x % per;
    return {(int)blockIdx.x / per, (r / nt) * TILE_M, (r % nt) * tn};
}

// f32 stage of k slice k0: A (128 lanes x SK k of h_in, rows lda apart, a
// multiple of 4) into as[k][lane] through 4-byte copies (a warp takes 8 k x
// 4 lanes: 32-byte reads, conflict-free writes), W (SK k x 128 columns)
// into bs[k][col] through 16-byte copies (VEC: N a multiple of 4 and W
// 16-byte aligned) or 4-byte ones. Zero-filled past K and N.
template <bool VEC>
__device__ __forceinline__ void sgemm_load(float* as, float* bs,
                                           const float* a_g, int lda,
                                           const float* w_g, int K, int N,
                                           int k0, int n0) {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < TILE_M * SK / THREADS; ++i) {
        const int idx = t + THREADS * i;
        const int k = idx % 8 + 8 * (idx / (8 * TILE_M)), m = idx / 8 % TILE_M;
        const bool ok = k0 + k < K;
        cp_async<4>(as + k * SA_LD + m,
                    ok ? a_g + (size_t)m * lda + k0 + k : a_g, ok ? 4 : 0);
    }
    if (VEC) {
#pragma unroll
        for (int i = 0; i < SK * FMA_N / 4 / THREADS; ++i) {
            const int idx = t + THREADS * i;
            const int k = idx / (FMA_N / 4), c = 4 * (idx % (FMA_N / 4));
            const int valid = k0 + k < K ? 4 * min(max(N - n0 - c, 0), 4) : 0;
            cp_async<16>(bs + k * FMA_N + c,
                         valid ? w_g + (size_t)(k0 + k) * N + n0 + c : w_g,
                         valid);
        }
    } else {
#pragma unroll
        for (int i = 0; i < SK * FMA_N / THREADS; ++i) {
            const int idx = t + THREADS * i;
            const int k = idx / FMA_N, c = idx % FMA_N;
            const bool ok = k0 + k < K && n0 + c < N;
            cp_async<4>(bs + k * FMA_N + c,
                        ok ? w_g + (size_t)(k0 + k) * N + n0 + c : w_g,
                        ok ? 4 : 0);
        }
    }
}

// the products of one f32 stage: thread (tx, ty) holds rows 4 ty + i and
// 64 + 4 ty + i, columns 4 tx + j and (NJ = 8) 64 + 4 tx + j
template <int NJ>
__device__ __forceinline__ void sgemm_stage(const float* as, const float* bs,
                                            int tx, int ty,
                                            float (&acc)[8][8]) {
#pragma unroll
    for (int k = 0; k < SK; ++k) {
        float a[8], b[8];
        const float4 a0 = *reinterpret_cast<const float4*>(as + k * SA_LD + 4 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(as + k * SA_LD + 64 + 4 * ty);
        const float4 b0 = *reinterpret_cast<const float4*>(bs + k * FMA_N + 4 * tx);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        if (NJ == 8) {
            const float4 b1 = *reinterpret_cast<const float4*>(bs + k * FMA_N + 64 + 4 * tx);
            b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
}

// f32 layers 2 and 3: for the block's tile (s, m0, n0), v = A[s, m0:m0+128,
// :K] W[s, :K, n0:n0+128] + bias[s, n0:n0+128], then for the columns
// n0 + c < N
//   LAST = false: h_out[s, m0 + r, n0 + c] = gelu(v)        (h2, stride ldo)
//   LAST = true:  part[s, n0 / 128, m0 + r] = sum_c gelu(v) w4[s, n0 + c]
// A (S, C, lda) and W (S, K, N) row-major.
template <bool VEC, bool LAST>
__global__ void __launch_bounds__(THREADS, MLP_F32_MIN_BLOCKS)
mlp_fused_sgemm_kernel(const float* __restrict__ A, int lda,
                       const float* __restrict__ W,
                       const float* __restrict__ bias,
                       const float* __restrict__ w4, float* __restrict__ h_out,
                       int ldo, float* __restrict__ part, int C, int m_tiles,
                       int K, int N) {
    extern __shared__ __align__(16) uint8_t fma_raw[];
    float* as = reinterpret_cast<float*>(fma_raw);
    float* bs = as + FMA_STAGES * SK * SA_LD;
    const int nt = (N + FMA_N - 1) / FMA_N;
    const Tile tl = fma_tile(m_tiles, nt, FMA_N);
    const float* a_g = A + ((size_t)tl.s * C + tl.m0) * lda;
    const float* w_g = W + (size_t)tl.s * K * N;
    const int kts = (K + SK - 1) / SK;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int st = 0; st < FMA_STAGES - 1; ++st) {
        if (st < kts)
            sgemm_load<VEC>(as + st * SK * SA_LD, bs + st * SK * FMA_N,
                            a_g, lda, w_g, K, N, st * SK, tl.n0);
        cp_async_commit();
    }
    float acc[8][8] = {};
    const bool half = tl.n0 + 64 >= N;     // columns 64.. of the tile are past N
    for (int kt = 0; kt < kts; ++kt) {
        // slice kt has landed, and every thread is done with slice kt - 1,
        // whose stage the load of slice kt + STAGES - 1 takes
        cp_async_wait<FMA_STAGES - 2>();
        __syncthreads();
        const int nk = kt + FMA_STAGES - 1;
        if (nk < kts) {
            const int st = nk % FMA_STAGES;
            sgemm_load<VEC>(as + st * SK * SA_LD, bs + st * SK * FMA_N,
                            a_g, lda, w_g, K, N, nk * SK, tl.n0);
        }
        cp_async_commit();
        const int st = kt % FMA_STAGES;
        if (half)
            sgemm_stage<4>(as + st * SK * SA_LD, bs + st * SK * FMA_N,
                           tx, ty, acc);
        else
            sgemm_stage<8>(as + st * SK * SA_LD, bs + st * SK * FMA_N,
                           tx, ty, acc);
    }
    cp_async_wait<0>();
    const float* b = bias + (size_t)tl.s * N;
    if (!LAST) {
        float* o = h_out + ((size_t)tl.s * C + tl.m0) * ldo;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int col = tl.n0 + 64 * h + 4 * tx;
            if (col >= N) continue;
            float bb[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) bb[j] = ldg_or_0(b, col + j, N);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float v[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) v[j] = gelu(acc[i][4 * h + j] + bb[j]);
                const int row = 64 * (i / 4) + 4 * ty + i % 4;
                stcs4(o + (size_t)row * ldo + col, v);    // col + 3 < ldo
            }
        }
    } else {
        // columns past N have v = 0 and weight 0
        const float* w = w4 + (size_t)tl.s * N;
        float wv[8], bv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int col = tl.n0 + 64 * (j / 4) + 4 * tx + j % 4;
            wv[j] = ldg_or_0(w, col, N);
            bv[j] = ldg_or_0(b, col, N);
        }
        float* pt = part + ((size_t)tl.s * nt + tl.n0 / FMA_N) * C + tl.m0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float p = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j) p += gelu(acc[i][j] + bv[j]) * wv[j];
            // the 16 threads of a row (tx = lane % 16), in a fixed order
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                p += __shfl_xor_sync(0xffffffffu, p, off);
            if (tx == 0) pt[64 * (i / 4) + 4 * ty + i % 4] = p;
        }
    }
}

// d (16 x 8) += a (16 x KM) b (KM x 8) in f64 on the tensor cores, KM = 4,
// 8 or 16. Thread (g, q) = (lane / 4, lane % 4) holds a[2 h] at row g and
// a[2 h + 1] at row g + 8, both at column 4 h + q; b[h] at row 4 h + q,
// column g; d rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2 q
// and 2 q + 1.
template <int KM>
__device__ __forceinline__ void dmma_m16n8(double (&d)[4],
                                           const double (&a)[KM / 2],
                                           const double (&b)[KM / 4]) {
    if constexpr (KM == 4)
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
            : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
            : "d"(a[0]), "d"(a[1]), "d"(b[0]));
    else if constexpr (KM == 8)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
              "d"(b[1]));
    else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
            "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
            : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
              "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
              "d"(b[2]), "d"(b[3]));
}

// f64 stage of k slice k0: A (128 lanes x DK k) into as[lane][k] and W (DK
// k x DN columns) into bs[k][col], 16-byte copies (W: VEC, N even and W
// 16-byte aligned) or 8-byte ones; zero-filled past K and N.
template <bool VEC>
__device__ __forceinline__ void dgemm_load(double* as, double* bs,
                                           const double* a_g, int lda,
                                           const double* w_g, int K, int N,
                                           int k0, int n0) {
    const int t = threadIdx.x;
#pragma unroll
    for (int i = 0; i < TILE_M * DK / 2 / DTHREADS; ++i) {
        const int idx = t + DTHREADS * i;
        const int m = idx / (DK / 2), k = 2 * (idx % (DK / 2));
        const int valid = 8 * min(max(K - k0 - k, 0), 2);
        cp_async<16>(as + m * DA_LD + k,
                     valid ? a_g + (size_t)m * lda + k0 + k : a_g, valid);
    }
    if (VEC) {
#pragma unroll
        for (int i = 0; i < DK * DN / 2 / DTHREADS; ++i) {
            const int idx = t + DTHREADS * i;
            const int k = idx / (DN / 2), c = 2 * (idx % (DN / 2));
            const int valid = k0 + k < K ? 8 * min(max(N - n0 - c, 0), 2) : 0;
            cp_async<16>(bs + k * DB_LD + c,
                         valid ? w_g + (size_t)(k0 + k) * N + n0 + c : w_g,
                         valid);
        }
    } else {
#pragma unroll
        for (int i = 0; i < DK * DN / DTHREADS; ++i) {
            const int idx = t + DTHREADS * i;
            const int k = idx / DN, c = idx % DN;
            const bool ok = k0 + k < K && n0 + c < N;
            cp_async<8>(bs + k * DB_LD + c,
                        ok ? w_g + (size_t)(k0 + k) * N + n0 + c : w_g,
                        ok ? 8 : 0);
        }
    }
}

// the A and W fragments of a warp's k step kk in an f64 stage: a_s at the
// warp's row g, column q; b_s at row q, the warp's column g
__device__ __forceinline__ void dgemm_fragments(const double* a_s,
                                                const double* b_s, int kk,
                                                double (&a)[4][DMMA_K / 2],
                                                double (&b)[4][DMMA_K / 4]) {
#pragma unroll
    for (int h = 0; h < DMMA_K / 4; ++h) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
            a[mi][2 * h] = a_s[16 * mi * DA_LD + kk + 4 * h];
            a[mi][2 * h + 1] = a_s[(16 * mi + 8) * DA_LD + kk + 4 * h];
        }
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
            b[nj][h] = b_s[(kk + 4 * h) * DB_LD + 8 * nj];
    }
}

// f64 layers 2 and 3: the f32 kernel's results on tiles of 128 lanes x DN
// columns, with part[s, (n0 + c0) / 32, m0 + r] = sum over the 32 columns
// c0.. of a warp. Warp w computes rows 64 (w % 2) .. + 63 and columns
// 32 (w / 2) .. + 31 of the tile: 4 x 4 DMMA tiles of 16 x 8, 64 f64
// accumulators a thread.
template <bool VEC, bool LAST>
__global__ void __launch_bounds__(DTHREADS, 256 / DTHREADS)
mlp_fused_dgemm_kernel(const double* __restrict__ A, int lda,
                       const double* __restrict__ W,
                       const double* __restrict__ bias,
                       const double* __restrict__ w4,
                       double* __restrict__ h_out, int ldo,
                       double* __restrict__ part, int C, int m_tiles, int K,
                       int N) {
    extern __shared__ __align__(16) uint8_t fma_raw[];
    double* as = reinterpret_cast<double*>(fma_raw);
    double* bs = as + DSTAGES * TILE_M * DA_LD;
    const int nt = (N + DN - 1) / DN;
    const Tile tl = fma_tile(m_tiles, nt, DN);
    const double* a_g = A + ((size_t)tl.s * C + tl.m0) * lda;
    const double* w_g = W + (size_t)tl.s * K * N;
    const int kts = (K + DK - 1) / DK;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, q = lane % 4, wm = 64 * (warp % 2), wn = 32 * (warp / 2);
    const bool active = tl.n0 + wn < N;    // the same for the whole warp
#pragma unroll
    for (int st = 0; st < DSTAGES - 1; ++st) {
        if (st < kts)
            dgemm_load<VEC>(as + st * TILE_M * DA_LD, bs + st * DK * DB_LD,
                            a_g, lda, w_g, K, N, st * DK, tl.n0);
        cp_async_commit();
    }
    double acc[4][4][4] = {};
    for (int kt = 0; kt < kts; ++kt) {
        cp_async_wait<DSTAGES - 2>();
        __syncthreads();
        const int nk = kt + DSTAGES - 1;
        if (nk < kts) {
            const int st = nk % DSTAGES;
            dgemm_load<VEC>(as + st * TILE_M * DA_LD, bs + st * DK * DB_LD,
                            a_g, lda, w_g, K, N, nk * DK, tl.n0);
        }
        cp_async_commit();
        if (!active) continue;
        const int st = kt % DSTAGES;
        const double* a_s = as + st * TILE_M * DA_LD + (wm + g) * DA_LD + q;
        const double* b_s = bs + st * DK * DB_LD + q * DB_LD + wn + g;
#pragma unroll
        for (int kk = 0; kk < DK; kk += DMMA_K) {
            double a[4][DMMA_K / 2], b[4][DMMA_K / 4];
            dgemm_fragments(a_s, b_s, kk, a, b);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int nj = 0; nj < 4; ++nj)
                    dmma_m16n8<DMMA_K>(acc[mi][nj], a[mi], b[nj]);
        }
    }
    cp_async_wait<0>();
    if (!active) return;
    const double* b = bias + (size_t)tl.s * N;
    if (!LAST) {
        double* o = h_out + ((size_t)tl.s * C + tl.m0) * ldo;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
            const int col = tl.n0 + wn + 8 * nj + 2 * q;
            if (col >= N) continue;
            const double b0 = ldg_or_0(b, col, N), b1 = ldg_or_0(b, col + 1, N);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int row = wm + 16 * mi + g + 8 * h;
                    __stcs(reinterpret_cast<double2*>(o + (size_t)row * ldo + col),
                           make_double2(gelu(acc[mi][nj][2 * h] + b0),
                                        gelu(acc[mi][nj][2 * h + 1] + b1)));
                }
        }
    } else {
        const double* w = w4 + (size_t)tl.s * N;
        double wv[4][2], bv[4][2];
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = tl.n0 + wn + 8 * nj + 2 * q + e;
                wv[nj][e] = ldg_or_0(w, col, N);
                bv[nj][e] = ldg_or_0(b, col, N);
            }
        const int nseg = (N + SEG_F64 - 1) / SEG_F64;
        double* pt = part + ((size_t)tl.s * nseg + (tl.n0 + wn) / SEG_F64) * C
                     + tl.m0;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                double p = 0.0;
#pragma unroll
                for (int nj = 0; nj < 4; ++nj)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        p += gelu(acc[mi][nj][2 * h + e] + bv[nj][e]) * wv[nj][e];
                // the 4 threads of a row (q), in a fixed order
                p += __shfl_xor_sync(0xffffffffu, p, 1);
                p += __shfl_xor_sync(0xffffffffu, p, 2);
                if (q == 0) pt[wm + 16 * mi + g + 8 * h] = p;
            }
    }
}

// one launch of the f32 or f64 GEMM of layer 2 (LAST false) or 3: a block
// per tile
template <bool VEC, bool LAST>
cudaError_t launch_fma_gemm(cudaStream_t st, const float* A, int lda,
                            const float* W, const float* bias, const float* w4,
                            float* h_out, int ldo, float* part, int C,
                            int m_tiles, int K, int N, int S) {
    const auto kernel = mlp_fused_sgemm_kernel<VEC, LAST>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SGEMM_SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<m_tiles * ((N + FMA_N - 1) / FMA_N) * S, THREADS, SGEMM_SMEM,
             st>>>(A, lda, W, bias, w4, h_out, ldo, part, C, m_tiles, K, N);
    return cudaGetLastError();
}
template <bool VEC, bool LAST>
cudaError_t launch_fma_gemm(cudaStream_t st, const double* A, int lda,
                            const double* W, const double* bias,
                            const double* w4, double* h_out, int ldo,
                            double* part, int C, int m_tiles, int K, int N,
                            int S) {
    const auto kernel = mlp_fused_dgemm_kernel<VEC, LAST>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DGEMM_SMEM);
    if (err != cudaSuccess) return err;
    kernel<<<m_tiles * ((N + DN - 1) / DN) * S, DTHREADS, DGEMM_SMEM,
             st>>>(A, lda, W, bias, w4, h_out, ldo, part, C, m_tiles, K, N);
    return cudaGetLastError();
}

template <bool LAST, typename T>
cudaError_t launch_fma_layer(bool vec, cudaStream_t st, const T* A, int lda,
                            const T* W, const T* bias, const T* w4, T* h_out,
                            int ldo, T* part, int C, int m_tiles, int K, int N,
                            int S) {
    return vec ? launch_fma_gemm<true, LAST>(st, A, lda, W, bias, w4, h_out,
                                             ldo, part, C, m_tiles, K, N, S)
               : launch_fma_gemm<false, LAST>(st, A, lda, W, bias, w4, h_out,
                                              ldo, part, C, m_tiles, K, N, S);
}

template <typename T, int KR, bool VEC>
void launch_l1_fma(dim3 grid, cudaStream_t st, const T* x, const T* W1,
                   const T* b1, T* h1, int ld1, int n, int C, int F, int K1,
                   int H1) {
    mlp_fused_l1_fma_kernel<T, KR, VEC><<<grid, THREADS, 0, st>>>(
        x, W1, b1, h1, ld1, n, C, F, K1, H1);
}

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The f32 or f64 call: the plan's chunks of lanes, each through layer 1,
// the GEMMs of layers 2 and 3, and layer 4's sum
template <typename T>
int run_fma(const void* x_, const void* W1_, const void* b1_, const void* W2_,
            const void* b2_, const void* W3_, const void* b3_, const void* W4_,
            const void* b4_, void* out_, void* scratch,
            long long scratch_bytes, int B, int F, int K1, int H1, int H2,
            int H3, int S, void* stream) {
    Plan plan;
    if (!make_plan(sizeof(T), B, S, K1, H1, H2, H3, &plan) || F > K1
        || (B > 0 && (scratch_bytes < (long long)plan.bytes
                      || reinterpret_cast<uintptr_t>(scratch) % 256)))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const T *x = (const T*)x_, *W1 = (const T*)W1_, *b1 = (const T*)b1_,
            *W2 = (const T*)W2_, *b2 = (const T*)b2_, *W3 = (const T*)W3_,
            *b3 = (const T*)b3_, *W4 = (const T*)W4_, *b4 = (const T*)b4_;
    uint8_t* base = static_cast<uint8_t*>(scratch);
    T* h1 = reinterpret_cast<T*>(base);
    T* h2 = reinterpret_cast<T*>(base + plan.h2_at);
    T* part = reinterpret_cast<T*>(base + plan.part_at);
    // 16-byte loads of a weight row: its width a multiple of 16 bytes
    constexpr int V = 16 / sizeof(T);
    const bool v1 = H1 % V == 0 && aligned16(W1) && aligned16(b1);
    const bool v2 = H2 % V == 0 && aligned16(W2);
    const bool v3 = H3 % V == 0 && aligned16(W3);
    const int chunk = plan.chunk;
    cudaStream_t st = (cudaStream_t)stream;
    for (long c0 = 0; c0 < B; c0 += chunk) {
        const int n = (int)std::min<long>(chunk, B - c0);
        const int m_tiles = (n + TILE_M - 1) / TILE_M;
        const dim3 l1_grid(m_tiles * TILE_M / L1_LANES, S, (H1 + 127) / 128);
        const T* xc = x + c0 * F;
        if (F <= L1_KR) {
            if (v1) launch_l1_fma<T, L1_KR, true>(l1_grid, st, xc, W1, b1, h1, plan.ld1, n, chunk, F, K1, H1);
            else launch_l1_fma<T, L1_KR, false>(l1_grid, st, xc, W1, b1, h1, plan.ld1, n, chunk, F, K1, H1);
        } else {
            if (v1) launch_l1_fma<T, 0, true>(l1_grid, st, xc, W1, b1, h1, plan.ld1, n, chunk, F, K1, H1);
            else launch_l1_fma<T, 0, false>(l1_grid, st, xc, W1, b1, h1, plan.ld1, n, chunk, F, K1, H1);
        }
        cudaError_t err = cudaGetLastError();
        if (err == cudaSuccess)
            err = launch_fma_layer<false>(v2, st, (const T*)h1, plan.ld1, W2,
                                         b2, (const T*)nullptr, h2, plan.ld2,
                                         (T*)nullptr, chunk, m_tiles, H1, H2,
                                         S);
        if (err == cudaSuccess)
            err = launch_fma_layer<true>(v3, st, (const T*)h2, plan.ld2, W3, b3,
                                        W4, (T*)nullptr, 0, part, chunk,
                                        m_tiles, H2, H3, S);
        if (err != cudaSuccess) return (int)err;
        mlp_fused_out_kernel<<<(n * S + 255) / 256, 256, 0, st>>>(
            (const T*)part, b4, (T*)out_ + c0 * S, n, chunk, S, plan.nseg);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace

extern "C" int mlp_fused_plan(int size, long long B, int S, int K1, int H1,
                              int H2, int H3, int* chunk, int* launches,
                              long long* bytes) {
    Plan p;
    if (!make_plan(size, (long)B, S, K1, H1, H2, H3, &p))
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
    if (!make_plan(2, B, S, K1, H1, H2, H3, &plan) || F > K1
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
    const void *b4, void *out, void *scratch, long long scratch_bytes, int B,  \
    int F, int K1, int H1, int H2, int H3, int S, void *stream
#define MLP_PASS x, W1, b1, W2, b2, W3, b3, W4, b4, out, scratch,              \
    scratch_bytes, B, F, K1, H1, H2, H3, S, stream

extern "C" int mlp_fused_f32(MLP_ARGS) { return run_fma<float>(MLP_PASS); }

extern "C" int mlp_fused_f64(MLP_ARGS) { return run_fma<double>(MLP_PASS); }
