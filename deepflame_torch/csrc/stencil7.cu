// General 7-point stencil apply on a periodic-indexed field, batched.
//
//   out[s,i,j,k] = D x + lo_x x[i-1] + hi_x x[i+1] + lo_y x[j-1] + hi_y x[j+1]
//                      + lo_z x[k-1] + hi_z x[k+1]
//
// with neighbour indices wrapped on every axis (the roll semantics of
// FvMatrix.stencil_apply: on cyclic axes the wrap IS the neighbour, on other
// axes the folded boundary coefficients are zero so the wrapped read is
// masked out).
//
// Replaces deepflame_tpu/ops/pallas_kernels.py::stencil_apply_tiled (the
// Krylov matvec of every species, momentum and energy solve). The TPU kernel
// materialises a wrap-padded copy of x and streams x-tiles through VMEM; here
// neighbours are indexed with wrap arithmetic instead, so nothing is copied,
// and one launch covers the whole (S, nx, ny, nz) species or momentum batch.
//
// Bound on an H100: memory. Per cell it reads x, D and six coefficients and
// writes one value (9 values, 13 flops): 36 B per cell in float32 against
// 0.36 flop/B, far below the card's ridge point. One thread per output cell,
// z fastest, so a warp reads 32 consecutive values of each array; the six
// neighbour reads of x hit L1/L2 after the centre reads of nearby threads.
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void stencil7_kernel(const T* __restrict__ x, const T* __restrict__ d,
                                const T* __restrict__ lx, const T* __restrict__ hx,
                                const T* __restrict__ ly, const T* __restrict__ hy,
                                const T* __restrict__ lz, const T* __restrict__ hz,
                                T* __restrict__ out, long long total, int nx,
                                int ny, int nz) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= total) return;
  const int k = (int)(c % nz);
  long long r = c / nz;
  const int j = (int)(r % ny);
  r /= ny;
  const int i = (int)(r % nx);
  const long long base = c - ((long long)i * ny + j) * nz - k;  // start of field s

  const int im = i == 0 ? nx - 1 : i - 1, ip = i == nx - 1 ? 0 : i + 1;
  const int jm = j == 0 ? ny - 1 : j - 1, jp = j == ny - 1 ? 0 : j + 1;
  const int km = k == 0 ? nz - 1 : k - 1, kp = k == nz - 1 ? 0 : k + 1;
  const long long row = ((long long)i * ny + j) * nz;

  T acc = d[c] * x[c];
  acc = acc + lx[c] * x[base + ((long long)im * ny + j) * nz + k] +
        hx[c] * x[base + ((long long)ip * ny + j) * nz + k];
  acc = acc + ly[c] * x[base + ((long long)i * ny + jm) * nz + k] +
        hy[c] * x[base + ((long long)i * ny + jp) * nz + k];
  acc = acc + lz[c] * x[base + row + km] + hz[c] * x[base + row + kp];
  out[c] = acc;
}

template <typename T>
int launch(const void* x, const void* d, const void* lx, const void* hx,
           const void* ly, const void* hy, const void* lz, const void* hz,
           void* out, long long batch, int nx, int ny, int nz, void* stream) {
  const long long total = batch * nx * ny * nz;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  stencil7_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)d, (const T*)lx, (const T*)hx, (const T*)ly,
      (const T*)hy, (const T*)lz, (const T*)hz, (T*)out, total, nx, ny, nz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stencil7_apply_f32(const void* x, const void* d, const void* lx,
                                  const void* hx, const void* ly, const void* hy,
                                  const void* lz, const void* hz, void* out,
                                  long long batch, int nx, int ny, int nz,
                                  void* stream) {
  return launch<float>(x, d, lx, hx, ly, hy, lz, hz, out, batch, nx, ny, nz,
                       stream);
}

extern "C" int stencil7_apply_f64(const void* x, const void* d, const void* lx,
                                  const void* hx, const void* ly, const void* hy,
                                  const void* lz, const void* hz, void* out,
                                  long long batch, int nx, int ny, int nz,
                                  void* stream) {
  return launch<double>(x, d, lx, hx, ly, hy, lz, hz, out, batch, nx, ny, nz,
                        stream);
}
