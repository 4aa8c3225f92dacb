// Batched inverse of n x n matrices by row-equilibrated, unpivoted
// Gauss-Jordan elimination, lanes last: W (n, n, L) -> W^-1 (n, n, L).
//
// Replaces deepflame_tpu/ops/pallas_kernels.py::gj_inverse_lanes, which
// inverts the Rosenbrock matrix W = I - gamma dt J of the stiff chemistry
// (n = species + 1). Same arithmetic as the TPU kernel and the plain version
// (deepflame_tpu/chemistry/integrator.py::_gj_inverse_batched): rows scaled
// by 1/max(max_c |W_rc|, 1e-30), pivots guarded to 1e-30, no pivoting, the
// pivot row divided by the pivot (kernel 2: times its reciprocal), and the
// columns of the result scaled back.
// The elimination runs in place on the n x n tableau (the right half of
// [A | I] takes the place of each eliminated column), which is the same
// sequence of updates on half the storage.
//
// Bound on an H100: memory at large L. It reads and writes n^2 values per
// lane (800 B per lane at n = 10 in float32) against about 2 n^3 flops. At
// the chemistry's lane counts (4,096 to 55,296) the bound is a few
// microseconds, so what matters there is the length of one lane's chain of
// dependent operations and how many SMs share the lanes. Two kernels behind
// one entry point per type, chosen by n:
//
// 1. n <= GJ_REG_MAX_N (the chemistry's sizes): n is a template parameter,
//    one thread per lane, the tableau in registers and the elimination fully
//    unrolled, so the n^2 loads of a lane are all in flight at once and each
//    pivot step is ~n^2 independent register FMAs. Lanes-last loads and
//    stores are coalesced across a warp; the row scales wait in shared
//    memory, so that the registers hold the tableau alone. GJ_REG_BLOCK lanes
//    a block (4,096 lanes cover 4,096 / GJ_REG_BLOCK SMs). The largest n:
//    float64 10, the largest that ptxas compiles without spilling; float32
//    14, one below that, since at n = 15 kernel 2 measured faster
//    (tools/gj_inverse_ablate.py).
// 2. every larger n, up to the limit: n at run time, several threads per
//    lane. Each thread holds a tile of the lane's tableau in registers, R
//    rows by C columns (16 x 4 float32, 8 x 4 float64); a block takes G
//    lanes (G a power of two, up to the 32 bytes of a memory sector: 8
//    float32, 4 float64 lanes, fewer where the threads would pass 512), lane
//    fastest, so that loads and stores move runs of G lanes. At each pivot
//    step the owners of column k and of row k publish them through shared
//    memory, one barrier, and every thread updates its tile: R C FMAs from
//    R / 4 (R / 2) vector loads of column k. The pivot row is multiplied
//    by the pivot's reciprocal here (GJ_COLS_DIVIDE=1 divides, as kernel 1
//    does): it measured faster, within the tolerances. The row maxima go
//    through shared memory in two stages (a tile's, then the tiles'). The
//    limit is the largest n whose one-lane block has at most 512 threads:
//    gj_inverse_limits says it.
//
// Both kernels need less than 48 KB of shared memory, so no launch sets a
// function attribute.
#include <cuda_runtime.h>

#ifndef GJ_REG_MAX_N_F32
#define GJ_REG_MAX_N_F32 14
#endif
#ifndef GJ_REG_MAX_N_F64
#define GJ_REG_MAX_N_F64 10
#endif
#ifndef GJ_REG_BLOCK
#define GJ_REG_BLOCK 64
#endif
#ifndef GJ_COLS_DIVIDE
#define GJ_COLS_DIVIDE 0
#endif
#ifndef GJ_COLS_UNROLL
#define GJ_COLS_UNROLL 8
#endif
#ifndef GJ_COLS_R_F32
#define GJ_COLS_R_F32 16
#endif
#ifndef GJ_COLS_R_F64
#define GJ_COLS_R_F64 8
#endif
#ifndef GJ_COLS_C
#define GJ_COLS_C 4
#endif

namespace {

template <typename T> struct RegMax;
template <> struct RegMax<float> {
  static constexpr int n = GJ_REG_MAX_N_F32;
};
template <> struct RegMax<double> {
  static constexpr int n = GJ_REG_MAX_N_F64;
};

template <typename T>
__device__ __forceinline__ T guard(T pv) {
  const T tiny = T(1e-30);
  return (pv < T(0) ? -pv : pv) > tiny ? pv : tiny;
}

// ----------------------------------------------- kernel 1: registers, n fixed

template <typename T, int N>
__global__ void __launch_bounds__(GJ_REG_BLOCK)
gj_inverse_reg_kernel(const T* __restrict__ W, T* __restrict__ out,
                      long long L) {
  __shared__ T s_sh[N][GJ_REG_BLOCK];  // row scales, out of the registers
  const int t = threadIdx.x;
  const long long l = (long long)blockIdx.x * GJ_REG_BLOCK + t;
  if (l >= L) return;  // no block-wide synchronisation below
  const T tiny = T(1e-30);
  T M[N][N];

#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) M[r][c] = W[(long long)(r * N + c) * L + l];

#pragma unroll
  for (int r = 0; r < N; ++r) {
    T mx = T(0);
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const T a = M[r][c] < T(0) ? -M[r][c] : M[r][c];
      mx = a > mx ? a : mx;
    }
    const T sr = T(1) / (mx > tiny ? mx : tiny);
    s_sh[r][t] = sr;
#pragma unroll
    for (int c = 0; c < N; ++c) M[r][c] *= sr;
  }

#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T g = guard(M[k][k]);
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c != k) M[k][c] = M[k][c] / g;
    M[k][k] = T(1) / g;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (r == k) continue;
      const T f = M[r][k];
#pragma unroll
      for (int c = 0; c < N; ++c)
        if (c != k) M[r][c] = M[r][c] - f * M[k][c];
      M[r][k] = -f * M[k][k];
    }
  }

#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c)
      out[(long long)(r * N + c) * L + l] = M[r][c] * s_sh[c][t];
}

// The kernel-1 instantiation for n, searched from N down to 1.
template <typename T, int N>
cudaError_t launch_reg(int n, const T* W, T* out, long long L,
                       cudaStream_t stream) {
  if constexpr (N == 0) {
    return cudaErrorInvalidValue;
  } else {
    if (n != N) return launch_reg<T, N - 1>(n, W, out, L, stream);
    const long long blocks = (L + GJ_REG_BLOCK - 1) / GJ_REG_BLOCK;
    gj_inverse_reg_kernel<T, N><<<(unsigned)blocks, GJ_REG_BLOCK, 0, stream>>>(
        W, out, L);
    return cudaGetLastError();
  }
}

// --------------------------------- kernel 2: register tiles, n at run time

// 16 bytes of T: the shared-memory vector of u that the update reads
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ float4 pack(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ void unpack(float4 a, float (&v)[4]) {
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ double2 pack(const double (&v)[2]) {
    return make_double2(v[0], v[1]);
  }
  static __device__ void unpack(double2 a, double (&v)[2]) {
    v[0] = a.x, v[1] = a.y;
  }
};

// The tile of a thread of kernel 2: R rows by C columns, R C values in
// registers (64 float32, 32 float64: under the 128 registers a thread of a
// 512-thread block may hold).
template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int R = GJ_COLS_R_F32, C = GJ_COLS_C;
};
template <> struct Tile<double> {
  static constexpr int R = GJ_COLS_R_F64, C = GJ_COLS_C;
};
constexpr int kColsThreads = 512;
constexpr size_t kColsSmem = 48 * 1024;  // no function attribute needed

// threads of one lane: row segments x column groups
template <typename T>
constexpr int cols_threads(int n) {
  constexpr int R = Tile<T>::R, C = Tile<T>::C;
  return (n + R - 1) / R * ((n + C - 1) / C);
}

// Thread (j, cg, seg) of a block holds rows seg*R .. seg*R+R-1 of columns
// cg*C .. cg*C+C-1 of lane l0 + j in registers. Pivot step k: the owners of
// column k publish it less e_k (u), the owners of row k publish that row; one
// barrier; then every thread scales its columns' pivot-row entries by the
// pivot's reciprocal (mk; the owner of column k restarts it as e_k with
// mk = 1/g, the right half of [A | I]) and updates its tile, m -= u mk: rows
// r != k as M - col_k row_k, row k as M - (pv - 1) row_k, the plain
// version's M - pv row_k + row_k. Each vector of u read from shared memory
// serves C columns. The steps go
// GJ_COLS_UNROLL at a time, unrolled, and the tile's rows rotate by as many
// after each trip, so that the pivot row is a fixed register row. The two
// published vectors alternate between two buffers.
template <typename T>
__global__ void __launch_bounds__(kColsThreads)
gj_inverse_cols_kernel(const T* __restrict__ W, T* __restrict__ out, int n,
                       long long L, int lg) {
  using V = typename Vec<T>::type;
  constexpr int R = Tile<T>::R, C = Tile<T>::C, VN = Vec<T>::n;
  constexpr int U = GJ_COLS_UNROLL;  // even, divides R
  static_assert(R % U == 0 && U % 2 == 0 && R % VN == 0 && C % VN == 0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = 1 << lg, S = (n + R - 1) / R, CG = (n + C - 1) / C;
  const int ustride = S * R + VN, pstride = CG * C + VN;  // 16-byte rows
  T* u = reinterpret_cast<T*>(smem_raw);  // u[p][j][r]: col_k - e_k
  T* prow = u + 2 * G * ustride;          // prow[p][j][c]: row k
  T* s = prow + 2 * G * pstride;          // s[r][j]: row scales
  T* pmax = s + n * G;                    // pmax[cg][r][j]: a tile's row max
  const int t = threadIdx.x, j = t & (G - 1), tile = t >> lg;
  const int cg = tile % CG, c0 = cg * C, r0 = tile / CG * R;
  const long long l0 = (long long)blockIdx.x * G;
  const bool live = l0 + j < L;
  const T tiny = T(1e-30);

  T m[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int r = r0 + i, c = c0 + q;
      m[i][q] = live && r < n && c < n
                    ? W[(long long)(r * n + c) * L + l0 + j] : T(0);
    }
  // row maxima: each tile's over its C columns, then over the tiles
#pragma unroll
  for (int i = 0; i < R; ++i) {
    T mx = T(0);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const T a = m[i][q] < T(0) ? -m[i][q] : m[i][q];
      mx = a > mx ? a : mx;
    }
    pmax[(cg * S * R + r0 + i) * G + j] = mx;
  }
  __syncthreads();
  for (int i = t; i < n * G; i += blockDim.x) {
    T mx = T(0);
    for (int b = 0; b < CG; ++b) {
      const T a = pmax[b * S * R * G + i];
      mx = a > mx ? a : mx;
    }
    s[i] = T(1) / (mx > tiny ? mx : tiny);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (r0 + i < n) {
      const T sr = s[(r0 + i) * G + j];
#pragma unroll
      for (int q = 0; q < C; ++q) m[i][q] *= sr;
    }

  for (int k0 = 0; k0 < n; k0 += U) {
#pragma unroll
    for (int kk = 0; kk < U; ++kk) {
      const int k = k0 + kk;
      if (k >= n) continue;  // not break: the loop must unroll
      const bool mine = r0 == k / R * R;  // this tile holds row k
      const int qk = k - c0;              // column k's place in the tile
      T* uk = u + (kk & 1) * G * ustride + j * ustride + r0;
      T* pk = prow + (kk & 1) * G * pstride + j * pstride;
#pragma unroll
      for (int q = 0; q < C; ++q)
        if (q == qk) {
#pragma unroll
          for (int i = 0; i < R; i += VN) {
            T v[VN];
#pragma unroll
            for (int x = 0; x < VN; ++x)
              v[x] = i + x == kk && mine ? m[i + x][q] - T(1) : m[i + x][q];
            *reinterpret_cast<V*>(uk + i) = Vec<T>::pack(v);
          }
        }
      if (mine) {
#pragma unroll
        for (int q = 0; q < C; q += VN) {
          T v[VN];
#pragma unroll
          for (int x = 0; x < VN; ++x) v[x] = m[kk][q + x];
          *reinterpret_cast<V*>(pk + c0 + q) = Vec<T>::pack(v);
        }
      }
      __syncthreads();
      const T g = guard(pk[k]);
#if !GJ_COLS_DIVIDE
      const T rg = T(1) / g;
#endif
      T mk[C];
#pragma unroll
      for (int q = 0; q < C; q += VN) {
        T v[VN];
        Vec<T>::unpack(*reinterpret_cast<const V*>(pk + c0 + q), v);
#pragma unroll
        for (int x = 0; x < VN; ++x)
#if GJ_COLS_DIVIDE
          mk[q + x] = v[x] / g;
#else
          mk[q + x] = v[x] * rg;
#endif
      }
#pragma unroll
      for (int q = 0; q < C; ++q)
        if (q == qk) {
          mk[q] = T(1) / g;
#pragma unroll
          for (int i = 0; i < R; ++i) m[i][q] = i == kk && mine ? T(1) : T(0);
        }
#pragma unroll
      for (int i = 0; i < R; i += VN) {
        T ue[VN];
        Vec<T>::unpack(*reinterpret_cast<const V*>(uk + i), ue);
#pragma unroll
        for (int x = 0; x < VN; ++x)
#pragma unroll
          for (int q = 0; q < C; ++q)
            m[i + x][q] = m[i + x][q] - ue[x] * mk[q];
      }
    }
    T first[U][C];
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
      for (int q = 0; q < C; ++q) first[i][q] = m[i][q];
#pragma unroll
    for (int i = 0; i < R - U; ++i)
#pragma unroll
      for (int q = 0; q < C; ++q) m[i][q] = m[i + U][q];
#pragma unroll
    for (int i = 0; i < U; ++i)
#pragma unroll
      for (int q = 0; q < C; ++q) m[R - U + i][q] = first[i][q];
  }

  if (!live) return;
  // register row i holds row r0 + (i + rot) % R
  const int rot = (n + U - 1) / U * U % R;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int c = c0 + q;
    if (c >= n) continue;
    const T sc = s[c * G + j];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = r0 + (i + rot) % R;
      if (r < n) out[(long long)(r * n + c) * L + l0 + j] = m[i][q] * sc;
    }
  }
}

template <typename T>
constexpr size_t cols_smem_bytes(int n, int lg) {
  constexpr int R = Tile<T>::R, C = Tile<T>::C, VN = Vec<T>::n;
  const size_t rows = (n + R - 1) / R * R, cols = (n + C - 1) / C * C;
  return (2 * (rows + VN) + 2 * (cols + VN) + n + cols / C * rows) *
         sizeof(T) << lg;
}

// The library's limit: the largest n of kernel 2 with one lane a block in
// kColsThreads threads (176 in float32, 128 in float64).
template <typename T>
constexpr int limit_n() {
  int n = RegMax<T>::n;
  while (cols_threads<T>(n + 1) <= kColsThreads) ++n;
  return n;
}

// one lane a block fits the static 48 KB at every n up to the limit
template <typename T>
constexpr bool cols_fit() {
  for (int n = RegMax<T>::n + 1; n <= limit_n<T>(); ++n)
    if (cols_smem_bytes<T>(n, 0) > kColsSmem) return false;
  return true;
}
static_assert(cols_fit<float>() && cols_fit<double>());

template <typename T>
cudaError_t launch_cols(int n, const T* W, T* out, long long L,
                        cudaStream_t stream) {
  // lanes a block: up to a 32-byte sector of them, kColsThreads threads
  const int per_lane = cols_threads<T>(n);
  int lg = 0;
  while ((sizeof(T) << (lg + 1)) <= 32 &&
         (per_lane << (lg + 1)) <= kColsThreads &&
         cols_smem_bytes<T>(n, lg + 1) <= kColsSmem)
    ++lg;
  const long long blocks = (L + (1 << lg) - 1) >> lg;
  gj_inverse_cols_kernel<T><<<(unsigned)blocks, per_lane << lg,
                              cols_smem_bytes<T>(n, lg), stream>>>(
      W, out, n, L, lg);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* W, void* out, int n, long long L, void* stream) {
  if (n < 1 || n > limit_n<T>() || L < 0) return (int)cudaErrorInvalidValue;
  if (L == 0) return 0;
  const auto s = (cudaStream_t)stream;
  if (n <= RegMax<T>::n)
    return (int)launch_reg<T, RegMax<T>::n>(n, (const T*)W, (T*)out, L, s);
  return (int)launch_cols<T>(n, (const T*)W, (T*)out, L, s);
}

__global__ void gj_empty_kernel() {}

}  // namespace

extern "C" int gj_inverse_f32(const void* W, void* out, int n, long long L,
                              void* stream) {
  return launch<float>(W, out, n, L, stream);
}

extern "C" int gj_inverse_f64(const void* W, void* out, int n, long long L,
                              void* stream) {
  return launch<double>(W, out, n, L, stream);
}

// The sizes each kernel takes in a type of dtype_bytes (4 or 8): kernel 1
// for n <= *reg_max_n, kernel 2 above it up to *max_n, the library's limit.
extern "C" int gj_inverse_limits(int dtype_bytes, int* reg_max_n, int* max_n) {
  if (dtype_bytes == 4) {
    *reg_max_n = RegMax<float>::n;
    *max_n = limit_n<float>();
  } else if (dtype_bytes == 8) {
    *reg_max_n = RegMax<double>::n;
    *max_n = limit_n<double>();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// One launch of an empty kernel: the floor of a launch's device time, which
// chip_smoke.py prints beside the bounds of small calls.
extern "C" int gj_inverse_empty(void* stream) {
  gj_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
