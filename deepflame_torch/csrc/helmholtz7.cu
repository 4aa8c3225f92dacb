// Variable-coefficient 7-point Helmholtz operator (the pressure-CG matvec):
//
//   out = d x - sum_ax (g_hi (x_+ - x) - g_lo (x - x_-)) / h_ax^2
//
// from a ghost-padded x (nx+2, ny+2, nz+2) and per-axis face coefficients
// g_x (nx+1, ny, nz), g_y (nx, ny+1, nz), g_z (nx, ny, nz+1). Axes with
// inv_h2 == 0 (size-1 axes of 2D cases) are skipped, as in the TPU kernel.
//
// Replaces both deepflame_tpu/ops/pallas_kernels.py::helmholtz_apply and
// ::helmholtz_apply_tiled. The TPU needed two variants only because the whole
// working set fits VMEM at small grids and must be x-tiled at 96^3; a GPU
// kernel reads device memory directly, so one kernel serves every grid size.
//
// Bound on an H100: memory. Per cell it reads x (padded), d and three face
// coefficients and writes one value: about 6 values against 17 flops, far
// below the ridge point. One thread per cell, z fastest, so each warp reads
// consecutive addresses; the x and face-coefficient neighbours of a cell are
// the centre values of nearby threads and come from L1/L2.
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void helmholtz7_kernel(const T* __restrict__ xp, const T* __restrict__ gx,
                                  const T* __restrict__ gy, const T* __restrict__ gz,
                                  const T* __restrict__ d, T* __restrict__ out,
                                  int nx, int ny, int nz, T ihx, T ihy, T ihz) {
  long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)nx * ny * nz;
  if (c >= total) return;
  const int k = (int)(c % nz);
  const long long r = c / nz;
  const int j = (int)(r % ny);
  const int i = (int)(r / ny);

  const int pny = ny + 2, pnz = nz + 2;
  // padded index of cell (i, j, k) is (i+1, j+1, k+1)
  auto P = [&](int a, int b, int e) -> T {
    return xp[((long long)a * pny + b) * pnz + e];
  };
  const T x = P(i + 1, j + 1, k + 1);
  T acc = d[c] * x;
  if (ihx != T(0)) {
    const T ghi = gx[((long long)(i + 1) * ny + j) * nz + k];
    const T glo = gx[((long long)i * ny + j) * nz + k];
    const T fhi = ghi * (P(i + 2, j + 1, k + 1) - x);
    const T flo = glo * (x - P(i, j + 1, k + 1));
    acc = acc - (fhi - flo) * ihx;
  }
  if (ihy != T(0)) {
    const T ghi = gy[((long long)i * (ny + 1) + j + 1) * nz + k];
    const T glo = gy[((long long)i * (ny + 1) + j) * nz + k];
    const T fhi = ghi * (P(i + 1, j + 2, k + 1) - x);
    const T flo = glo * (x - P(i + 1, j, k + 1));
    acc = acc - (fhi - flo) * ihy;
  }
  if (ihz != T(0)) {
    const T ghi = gz[((long long)i * ny + j) * (nz + 1) + k + 1];
    const T glo = gz[((long long)i * ny + j) * (nz + 1) + k];
    const T fhi = ghi * (P(i + 1, j + 1, k + 2) - x);
    const T flo = glo * (x - P(i + 1, j + 1, k));
    acc = acc - (fhi - flo) * ihz;
  }
  out[c] = acc;
}

template <typename T>
int launch(const void* xp, const void* gx, const void* gy, const void* gz,
           const void* d, void* out, int nx, int ny, int nz, double ihx,
           double ihy, double ihz, void* stream) {
  const long long total = (long long)nx * ny * nz;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  helmholtz7_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)xp, (const T*)gx, (const T*)gy, (const T*)gz, (const T*)d,
      (T*)out, nx, ny, nz, (T)ihx, (T)ihy, (T)ihz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int helmholtz7_apply_f32(const void* xp, const void* gx, const void* gy,
                                    const void* gz, const void* d, void* out,
                                    int nx, int ny, int nz, double ihx,
                                    double ihy, double ihz, void* stream) {
  return launch<float>(xp, gx, gy, gz, d, out, nx, ny, nz, ihx, ihy, ihz,
                       stream);
}

extern "C" int helmholtz7_apply_f64(const void* xp, const void* gx, const void* gy,
                                    const void* gz, const void* d, void* out,
                                    int nx, int ny, int nz, double ihx,
                                    double ihy, double ihz, void* stream) {
  return launch<double>(xp, gx, gy, gz, d, out, nx, ny, nz, ihx, ihy, ihz,
                        stream);
}
