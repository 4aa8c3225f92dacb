// ELLPACK sparse matrix-vector product:
//   out[c] = diag[c] * x[c] + sum_{j < w} coef[c, j] * x[nbr[c, j]]
// x, diag, out (n,); nbr (n, w) int32 with every entry in [0, n); coef (n, w).
//
// Replaces deepflame_tpu/ops/pallas_kernels.py::ell_matvec, the pressure-CG
// matvec of the face-list low-Mach step on a general mesh (FvMatrixFL.ell /
// apply_ell; w = 6 on a hex mesh, pad slots point at the row itself with
// coefficient 0). The Pallas kernel keeps x whole in VMEM and gathers from
// it block by block; here every row is independent, so one thread computes
// one row: it reads its w indices and coefficients (contiguous per row, so a
// warp's reads cover whole cache lines), gathers x through the read-only
// cache (__ldg) and sums the w products in slot order before adding the
// diagonal term, the order of the plain version.
//
// Bound on an H100: memory. Each row moves 4 (diag) + 4 (x[c]) + 4w (nbr) +
// 4w (coef) + 4 (out) bytes in float32 (8-byte values in float64); the
// gathers of x mostly hit L1/L2, as neighbouring rows share neighbours
// (x is 2 MB at the jet's 524,288 cells, inside the 50 MB L2). 2(w + 1)
// operations per row are far below the compute peak.
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void ell_matvec_kernel(const T* __restrict__ x,
                                  const T* __restrict__ diag,
                                  const int* __restrict__ nbr,
                                  const T* __restrict__ coef,
                                  T* __restrict__ out, long long n, int w) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int* nb = nbr + c * w;
  const T* cf = coef + c * w;
  T s = T(0);
  for (int j = 0; j < w; ++j) s += cf[j] * __ldg(x + nb[j]);
  out[c] = diag[c] * x[c] + s;
}

template <typename T>
int launch(const void* x, const void* diag, const void* nbr, const void* coef,
           void* out, long long n, int w, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  ell_matvec_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)diag, (const int*)nbr, (const T*)coef, (T*)out,
      n, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ell_matvec_f32(const void* x, const void* diag, const void* nbr,
                              const void* coef, void* out, long long n, int w,
                              void* stream) {
  return launch<float>(x, diag, nbr, coef, out, n, w, stream);
}

extern "C" int ell_matvec_f64(const void* x, const void* diag, const void* nbr,
                              const void* coef, void* out, long long n, int w,
                              void* stream) {
  return launch<double>(x, diag, nbr, coef, out, n, w, stream);
}
