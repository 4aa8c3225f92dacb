// Batched inverse of small n x n matrices by row-equilibrated, unpivoted
// Gauss-Jordan elimination, lanes last: W (n, n, L) -> W^-1 (n, n, L).
//
// Replaces deepflame_tpu/ops/pallas_kernels.py::gj_inverse_lanes, which
// inverts the Rosenbrock matrix W = I - gamma dt J of the stiff chemistry
// (n = species + 1). Same arithmetic as the TPU kernel and the plain version
// (deepflame_tpu/chemistry/integrator.py::_gj_inverse_batched): rows scaled
// by 1/max(max_c |W_rc|, 1e-30), pivots guarded to 1e-30, no pivoting, and
// the columns of the result scaled back. The elimination runs in place on the
// n x n tableau (the right half of [A | I] takes the place of each eliminated
// column), which is the same sequence of updates on half the storage.
//
// Bound on an H100: memory. It reads and writes n^2 values per lane
// (800 B per lane at n = 10 in float32) against about 2 n^3 flops. One thread
// per lane: the lanes-last layout makes each of the n^2 loads and stores
// coalesced across a warp. The tableau lives in shared memory, interleaved by
// thread (element e of thread t at e * blockDim + t), so the n elimination
// passes never touch device memory and the accesses are free of bank
// conflicts. Shared memory bounds n: the block shrinks from 128 to 32 lanes as
// n grows, and n <= 42 in float32 and n <= 29 in float64 fit one 32-lane
// block in the 227 KB a block may use.
#include <cuda_runtime.h>

namespace {

constexpr size_t kMaxSmem = 232448;  // 227 KB: most a block may use on sm_90

template <typename T>
__global__ void gj_inverse_kernel(const T* __restrict__ W, T* __restrict__ out,
                                  int n, long long L) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int t = threadIdx.x, nt = blockDim.x;
  const long long l = (long long)blockIdx.x * nt + t;
  if (l >= L) return;  // no block-wide synchronisation below
  T* M = sm + t;                      // M[e * nt]: element e of this lane
  T* s = sm + (long long)n * n * nt + t;  // s[r * nt]: row scale of row r
  const T tiny = T(1e-30);

  for (int r = 0; r < n; ++r) {
    T mx = T(0);
    for (int c = 0; c < n; ++c) {
      const T v = W[((long long)r * n + c) * L + l];
      M[(r * n + c) * nt] = v;
      const T a = v < T(0) ? -v : v;
      mx = a > mx ? a : mx;
    }
    const T sr = T(1) / (mx > tiny ? mx : tiny);
    s[r * nt] = sr;
    for (int c = 0; c < n; ++c) M[(r * n + c) * nt] *= sr;
  }

  for (int k = 0; k < n; ++k) {
    const T pv = M[(k * n + k) * nt];
    const T g = (pv < T(0) ? -pv : pv) > tiny ? pv : tiny;
    for (int c = 0; c < n; ++c)
      if (c != k) M[(k * n + c) * nt] = M[(k * n + c) * nt] / g;
    M[(k * n + k) * nt] = T(1) / g;
    for (int r = 0; r < n; ++r) {
      if (r == k) continue;
      const T f = M[(r * n + k) * nt];
      for (int c = 0; c < n; ++c)
        if (c != k) M[(r * n + c) * nt] = M[(r * n + c) * nt] - f * M[(k * n + c) * nt];
      M[(r * n + k) * nt] = -f * M[(k * n + k) * nt];
    }
  }

  for (int r = 0; r < n; ++r)
    for (int c = 0; c < n; ++c)
      out[((long long)r * n + c) * L + l] = M[(r * n + c) * nt] * s[c * nt];
}

template <typename T>
int launch(const void* W, void* out, int n, long long L, void* stream) {
  if (L == 0 || n == 0) return 0;
  const size_t per_lane = (size_t)(n * n + n) * sizeof(T);
  int threads = 128;
  while (threads > 32 && threads * per_lane > kMaxSmem) threads /= 2;
  const size_t bytes = threads * per_lane;
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gj_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (L + threads - 1) / threads;
  gj_inverse_kernel<T><<<(unsigned)blocks, threads, bytes, (cudaStream_t)stream>>>(
      (const T*)W, (T*)out, n, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gj_inverse_f32(const void* W, void* out, int n, long long L,
                              void* stream) {
  return launch<float>(W, out, n, L, stream);
}

extern "C" int gj_inverse_f64(const void* W, void* out, int n, long long L,
                              void* stream) {
  return launch<double>(W, out, n, L, stream);
}
