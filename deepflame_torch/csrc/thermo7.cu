// correctThermo in one launch: the temperature of each cell from its
// absolute enthalpy (or internal energy) and mass fractions by a fixed
// number of clamped Newton steps on the NASA-7 polynomials, and, if asked,
// psi = W_mix / (R T).
//
// Replaces no TPU kernel. The JAX package leaves ThermoData.T_from_h to XLA,
// which fuses the Newton loop into a few device loops. In eager PyTorch
// each Newton step of the same code is about 39 launches over (cells, ns)
// and (cells, ns, 7) tensors (the plain version, chemistry/thermo.py), so
// the 192^3 TGV's correctThermo took about 126 ms a step.
//
// Bound on an H100: per cell it reads h, T_guess and ns mass fractions and
// writes T and psi, 13 values at ns = 9 (368 MB in float32 at 7.08M cells,
// 0.11 ms). The arithmetic is ~24 operations a species a Newton step (two
// Horner polynomials, the coefficient choice, two sums) and two IEEE
// divisions, about 1,800 a cell at ns = 9 and 8 steps: 0.19 ms at the
// float32 peak. So both bounds are near, and the design keeps everything
// after the loads on chip:
// - the per-species table (T_mid, 1/W, and per range a0..a4, a1/2, a2/3,
//   a3/4, a5: `ThermoData.kernel_table`) is staged into shared memory at
//   block start; every thread of a warp reads the same entry, a broadcast.
//   The table is an argument, not a __constant__ symbol, so tables of two
//   mechanisms can be live at once;
// - Y_i / W_i stays in registers for ns up to kRegNs; above that
//   it is read again each step (from L1);
// - Y is read in place through its two strides: the low-Mach solver's
//   species-major fields (cells stride 1) coalesce, a (cells, ns) block is
//   read a row a thread through L1.
//
// The arithmetic is the plain version's: T_guess clamped to [T_min, T_max],
// then exactly `iters` Newton steps, each clamped; per species the range
// by T < T_mid; cp/R = a0 + t (a1 + t (a2 + t (a3 + t a4))) and h/(R T) =
// a0 + t (a1/2 + t (a2/3 + t (a3/4 + t a4 / 5))) + a5 / t (a1/2, a2/3 and
// a3/4 are the same IEEE quotients the plain form takes at every call);
// sums over species in index order. Everything is in the field's type
// with IEEE division (no fast-math flag, no approximate intrinsic); nvcc
// contracts a multiply and an add into one FMA where it can, so results
// differ from the plain version's by rounding only.
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 20;       // table values a species
constexpr int kMaxNs = 256;    // ns x kRow doubles within 48 KB of shared memory
constexpr int kRegNs = 16;     // species whose Y_i / W_i stay in registers
constexpr int kThreads = 256;
// grid cap, each thread striding over cells: at 7.08M x 9 in float32,
// 16 blocks an SM took 1.209 ms, 8 took 1.264 and 4 took 1.360; 128
// threads a block 1.413 (one NVIDIA H100 80GB HBM3 at 700 W)
constexpr int kBlocksPerSm = 16;

// torch.clamp's order (max, then min); a NaN passes through
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// cp_i / R and h_i / (R T) of the species whose table row is `row`
template <typename T>
__device__ __forceinline__ void species(const T* row, T t, T& cpR, T& hRT) {
  // row: T_mid, 1/W, low range (a0..a4, a1/2, a2/3, a3/4, a5), high range
  const T* a = row + (t < row[0] ? 2 : 11);
  cpR = a[0] + t * (a[1] + t * (a[2] + t * (a[3] + t * a[4])));
  hRT = a[0] + t * (a[5] + t * (a[6] + t * (a[7] + t * a[4] / T(5)))) +
        a[8] / t;
}

// One Newton step's mixture sums: sh = sum_i (Y_i / W_i) h_i / (R T) and
// scp = sum_i (Y_i / W_i) cp_i / R
template <typename T, int REG>
__device__ __forceinline__ void sums(const T* tab, const T* yw, const T* y,
                                     long long yss, int ns, T t, T& sh,
                                     T& scp) {
  sh = T(0);
  scp = T(0);
  if (REG > 0) {
#pragma unroll
    for (int i = 0; i < REG; ++i) {
      if (i < ns) {
        T cpR, hRT;
        species(tab + i * kRow, t, cpR, hRT);
        sh += yw[i] * hRT;
        scp += yw[i] * cpR;
      }
    }
  } else {
    for (int i = 0; i < ns; ++i) {
      T cpR, hRT;
      const T* row = tab + i * kRow;
      species(row, t, cpR, hRT);
      const T w = y[i * yss] * row[1];
      sh += w * hRT;
      scp += w * cpR;
    }
  }
}

// energy = 0: Newton on h = h_mass(T, Y) with dh/dT = cp_mass;
// energy = 1: on e = h_mass - R T / W_mix with de/dT = cp_mass - R / W_mix
template <typename T, int REG>
__global__ void __launch_bounds__(kThreads)
    thermo7_kernel(const T* __restrict__ value, const T* __restrict__ Y,
                   long long ysc, long long yss, const T* __restrict__ t_guess,
                   const T* __restrict__ table, T* __restrict__ t_out,
                   T* __restrict__ psi, long long n, int ns, int iters,
                   int energy, T t_min, T t_max, T R) {
  extern __shared__ unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  for (int k = threadIdx.x; k < ns * kRow; k += blockDim.x) tab[k] = table[k];
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < n;
       c += stride) {
    const T* y = Y + c * ysc;
    T yw[REG > 0 ? REG : 1];
    T sw = T(0);
    if (REG > 0) {
#pragma unroll
      for (int i = 0; i < REG; ++i) {
        if (i < ns) {
          yw[i] = y[i * yss] * tab[i * kRow + 1];
          sw += yw[i];
        }
      }
    } else {
      for (int i = 0; i < ns; ++i) sw += y[i * yss] * tab[i * kRow + 1];
    }
    const T w_mix = T(1) / sw;
    const T target = value[c];
    T t = clamp(t_guess[c], t_min, t_max);
    for (int it = 0; it < iters; ++it) {
      T sh, scp;
      sums<T, REG>(tab, yw, y, yss, ns, t, sh, scp);
      const T RT = R * t;
      T f = sh * RT;      // h_mass
      T d = scp * R;      // cp_mass
      if (energy) {
        f = f - RT / w_mix;
        d = d - R / w_mix;
      }
      t = clamp(t - (f - target) / d, t_min, t_max);
    }
    t_out[c] = t;
    if (psi != nullptr) psi[c] = w_mix / (R * t);
  }
}

template <typename T>
int launch(const void* value, const void* Y, long long ysc, long long yss,
           const void* t_guess, const void* table, void* t_out, void* psi,
           long long n, int ns, int iters, int energy, double t_min,
           double t_max, double R, void* stream) {
  if (ns < 1 || ns > kMaxNs || iters < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  const size_t smem = (size_t)ns * kRow * sizeof(T);
  auto kernel = ns <= kRegNs ? thermo7_kernel<T, kRegNs>
                                     : thermo7_kernel<T, 0>;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)value, (const T*)Y, ysc, yss, (const T*)t_guess,
      (const T*)table, (T*)t_out, (T*)psi, n, ns, iters, energy, (T)t_min,
      (T)t_max, (T)R);
  return (int)cudaGetLastError();
}

}  // namespace

// value, t_guess, t_out, psi: n contiguous values (psi may be null); Y: the
// mass fraction of cell c, species i at Y[c * ysc + i * yss]; table: (ns,
// 20) contiguous (ThermoData.kernel_table). Returns cudaGetLastError().
extern "C" int thermo7_f32(const void* value, const void* Y, long long ysc,
                           long long yss, const void* t_guess,
                           const void* table, void* t_out, void* psi,
                           long long n, int ns, int iters, int energy,
                           double t_min, double t_max, double R,
                           void* stream) {
  return launch<float>(value, Y, ysc, yss, t_guess, table, t_out, psi, n, ns,
                       iters, energy, t_min, t_max, R, stream);
}

extern "C" int thermo7_f64(const void* value, const void* Y, long long ysc,
                           long long yss, const void* t_guess,
                           const void* table, void* t_out, void* psi,
                           long long n, int ns, int iters, int energy,
                           double t_min, double t_max, double R,
                           void* stream) {
  return launch<double>(value, Y, ysc, yss, t_guess, table, t_out, psi, n, ns,
                        iters, energy, t_min, t_max, R, stream);
}
