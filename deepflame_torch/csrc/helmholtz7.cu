// Variable-coefficient 7-point Helmholtz operator (the pressure-CG matvec
// and every multigrid level's):
//
//   out = d x - sum_ax (g_hi (x_+ - x) - g_lo (x - x_-)) / h_ax^2
//
// with per-axis face coefficients g_x (nx+1, ny, nz), g_y (nx, ny+1, nz),
// g_z (nx, ny, nz+1). Axes with inv_h2 == 0 (size-1 axes of 2D cases) are
// skipped, and their face arrays are not read, as in the TPU kernel.
//
// Replaces both deepflame_tpu/ops/pallas_kernels.py::helmholtz_apply and
// ::helmholtz_apply_tiled. The TPU kernels take a ghost-padded x and need two
// variants only because the whole working set fits VMEM at small grids and
// must be x-tiled at 96^3. Here one kernel template has two load paths:
//  - the BC form (`helmholtz7_apply_bc_*`) takes the unpadded x (nx, ny, nz)
//    and a ghost rule per axis (cyclic: the neighbour wraps; else ghost =
//    a_lo owner on the low side, a_hi owner on the high side: pad_field's
//    homogeneous relations), so the caller makes no padded copy;
//  - the padded form (`helmholtz7_apply_*`) reads the ghosts of a padded x
//    (nx+2, ny+2, nz+2) from memory, as the TPU kernel does.
//
// Bound on an H100: memory. Per cell it reads x, d and a face value of each
// active axis once and writes one value (6 values in 3D against 22 flops).
// The design makes each of those one coalesced DRAM read and keeps the
// neighbours out of DRAM and L2:
//  - The axes are taken in a logical order (A, B, C): C the last axis longer
//    than one cell, A the first such axis before it, B the other. A 2D
//    (nx, ny, 1) case so marches along x over rows of y, coalesced, and its
//    z face array is never touched.
//  - A thread owns one point q = b nC + c of the (B, C) plane (one integer
//    division, once) and marches along A over a chunk of planes. x at a-1, a
//    and a+1 stay in registers, and the A face read as the high face of plane
//    a is the low face of plane a+1, so A costs one x and one face read a
//    cell. The B and C neighbours and the high B and C faces are the centre
//    values of nearby threads: L1 hits.
//  - Every value of plane a+1 is loaded (register prefetch) before plane a's
//    arithmetic, so each thread keeps a plane's loads in flight.
//  - The chunk length comes from the grid: enough chunks that the launch has
//    about HH_TARGET_BLOCKS blocks, so small grids (multigrid levels, the
//    41 x 100 x 41 chamber) still fill the card. About 135,000 threads in
//    flight (528 blocks of 256) timed best of 34,000 to 270,000 at the
//    main paths' 3D shapes but the chamber's, where 67,000 was 2 % faster
//    (NVIDIA H100 80GB HBM3, 700 W; tools/helmholtz7_ablate.py).
//  - A ghost of the BC form is a neighbour offset and a factor fixed per
//    thread before the march: wrap (cyclic), or the owner itself times a_lo
//    or a_hi. The factors are applied where the values are used, a plane
//    after their loads, so that no multiply waits on a load in flight.
//  - At these sizes the instruction count matters as much as the bytes
//    (about 6,700 cells an SM at 96^3): each column's pointers advance by
//    32-bit plane strides, one instruction each, where 64-bit index
//    products cost about three instructions a load.
// The BC form so reaches 0.61-0.72 of its bytes bound at 96^3, 128 x 64 x
// 64 and 1024 x 512 x 1 in float32 (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py's kernels line).
#include <cuda_runtime.h>

#ifndef HH_THREADS
#define HH_THREADS 256          // threads a block, along the (B, C) plane
#endif
#ifndef HH_TARGET_BLOCKS
#define HH_TARGET_BLOCKS 528    // blocks a launch aims at (4 on each SM)
#endif
#ifndef HH_CHUNK
#define HH_CHUNK 0              // planes a block marches over; 0: from the grid
#endif

namespace {

template <typename T>
struct Params {
  const T* x;          // x at cell (0, 0, 0)
  const T* g[3];       // face arrays of the logical axes A, B, C
  const T* d;
  T* out;
  int n[3];            // cells along A, B, C
  int chunk;           // planes a block marches over
  int xs[3];           // strides of x along A, B, C
  int cs[3];           // strides of d and out
  int gs[3][3];        // gs[L][k]: stride of axis L's face array along k
  T ih[3];             // 1 / h^2 of A, B, C; 0 for a skipped axis
  int cyc[3];          // BC form: cyclic axis
  T alo[3], ahi[3];    // BC form: ghost factors of the low and high sides
};

// Offset and factor of the neighbour across side `hi` of axis k, for a thread
// at index t along it: the neighbour is f * x[own + off].
template <typename T, bool PAD>
__device__ __forceinline__ void neighbour(const Params<T>& p, int k, int t,
                                          bool hi, int& off, T& f) {
  const int s = p.xs[k], n = p.n[k];
  f = T(1);
  if (PAD || (hi ? t < n - 1 : t > 0)) {
    off = hi ? s : -s;
  } else if (p.cyc[k]) {
    off = hi ? -(n - 1) * s : (n - 1) * s;
  } else {
    off = 0;
    f = hi ? p.ahi[k] : p.alo[k];
  }
}

template <typename T>
struct Plane {
  T xn, fn;          // x at plane a+1 as loaded, and its ghost factor
  T gah;             // A face between planes a and a+1
  T bm, bp, cm, cp;  // B and C neighbours at plane a, as loaded
  T gbl, gbh, gcl, gch;
  T dd;
};

template <typename T, bool PAD>
__global__ void __launch_bounds__(HH_THREADS)
helmholtz7_kernel(const Params<T> p) {
  const int nA = p.n[0], nC = p.n[2];
  const int q = blockIdx.x * HH_THREADS + threadIdx.x;
  if (q >= p.n[1] * nC) return;
  const int b = q / nC, c = q - b * nC;
  const int a0 = blockIdx.y * p.chunk;
  const int a1 = min(a0 + p.chunk, nA);
  const bool onA = p.ih[0] != T(0), onB = p.ih[1] != T(0),
             onC = p.ih[2] != T(0);
  const int sA = p.xs[0], cA = p.cs[0], gsA = p.gs[0][0], gsB = p.gs[1][0],
            gsC = p.gs[2][0], gBh = p.gs[1][1], gCh = p.gs[2][2];
  int oBm, oBp, oCm, oCp;
  T fBm, fBp, fCm, fCp;
  neighbour<T, PAD>(p, 1, b, false, oBm, fBm);
  neighbour<T, PAD>(p, 1, b, true, oBp, fBp);
  neighbour<T, PAD>(p, 2, c, false, oCm, fCm);
  neighbour<T, PAD>(p, 2, c, true, oCp, fCp);

  // this thread's column; running pointers at plane a0, each advanced by a
  // plane stride (32-bit) after the plane's loads
  const T* x = p.x + ((long long)b * p.xs[1] + (long long)c * p.xs[2]);
  const long long cell = (long long)b * p.cs[1] + (long long)c * p.cs[2];
  const T* px = x + (long long)a0 * sA;
  const T* pgA = p.g[0] + ((long long)b * p.gs[0][1] + (long long)c * p.gs[0][2]
                           + (long long)(a0 + 1) * gsA);
  const T* pgB = p.g[1] + ((long long)b * p.gs[1][1] + (long long)c * p.gs[1][2]
                           + (long long)a0 * gsB);
  const T* pgC = p.g[2] + ((long long)b * p.gs[2][1] + (long long)c * p.gs[2][2]
                           + (long long)a0 * gsC);
  const T* pd = p.d + (cell + (long long)a0 * cA);
  T* po = p.out + (cell + (long long)a0 * cA);
  // x at planes -1 and nA (the ghosts along A): where, and the factor
  const T* xlo = PAD ? px - sA
                     : x + (p.cyc[0] ? (long long)(nA - 1) * sA : 0LL);
  const T* xhi = PAD ? x + (long long)nA * sA
                     : x + (p.cyc[0] ? 0LL : (long long)(nA - 1) * sA);
  const T flo = (PAD || p.cyc[0]) ? T(1) : p.alo[0];
  const T fhi = (PAD || p.cyc[0]) ? T(1) : p.ahi[0];

  // every load of plane a (px etc. at plane a); factors are applied where
  // the values are used, a plane later, so no instruction waits on a load
  // in flight
  auto load = [&](int a) -> Plane<T> {
    Plane<T> r;
    const T zero = T(0);
    const bool end = a + 1 >= nA;
    r.xn = (a + 1 < a1 || onA) ? __ldg(end ? xhi : px + sA) : zero;
    r.fn = end ? fhi : T(1);
    r.gah = onA ? __ldg(pgA) : zero;
    r.bm = onB ? __ldg(px + oBm) : zero;
    r.bp = onB ? __ldg(px + oBp) : zero;
    r.gbl = onB ? __ldg(pgB) : zero;
    r.gbh = onB ? __ldg(pgB + gBh) : zero;
    r.cm = onC ? __ldg(px + oCm) : zero;
    r.cp = onC ? __ldg(px + oCp) : zero;
    r.gcl = onC ? __ldg(pgC) : zero;
    r.gch = onC ? __ldg(pgC + gCh) : zero;
    r.dd = __ldg(pd);
    px += sA;
    pgA += gsA;
    pgB += gsB;
    pgC += gsC;
    pd += cA;
    return r;
  };

  T xm = T(0), gal = T(0);
  if (onA) {
    xm = a0 > 0 ? __ldg(px - sA) : flo * __ldg(xlo);
    gal = __ldg(pgA - gsA);
  }
  T xc = __ldg(px);
  Plane<T> cur = load(a0);
  for (int a = a0; a < a1; ++a) {
    Plane<T> nxt = cur;
    if (a + 1 < a1) nxt = load(a + 1);  // in flight during plane a's sums
    const T xp = cur.fn * cur.xn;
    T acc = cur.dd * xc;
    if (onA) acc = acc - (cur.gah * (xp - xc) - gal * (xc - xm)) * p.ih[0];
    if (onB)
      acc = acc - (cur.gbh * (fBp * cur.bp - xc)
                   - cur.gbl * (xc - fBm * cur.bm)) * p.ih[1];
    if (onC)
      acc = acc - (cur.gch * (fCp * cur.cp - xc)
                   - cur.gcl * (xc - fCm * cur.cm)) * p.ih[2];
    *po = acc;
    po += cA;
    xm = xc;
    xc = cur.xn;  // plane a+1 < a1 is inside the mesh: its factor is 1
    gal = cur.gah;
    cur = nxt;
  }
}

// C-order strides of an array of shape m
void strides(const long long m[3], long long s[3]) {
  s[2] = 1;
  s[1] = m[2];
  s[0] = m[1] * m[2];
}

template <typename T>
int launch(bool pad, const void* x, const void* gx, const void* gy,
           const void* gz, const void* d, void* out, int nx, int ny, int nz,
           double ihx, double ihy, double ihz, int cyc_mask,
           const double* a, void* stream) {
  const int n[3] = {nx, ny, nz};
  if ((long long)nx * ny * nz == 0) return 0;
  // logical order (A, B, C): C the last axis longer than one cell, A the
  // first one before it (else a size-1 axis), B the other; the active axes
  // keep their order, so the sums are taken as in the plain version
  int C = 2;
  while (C > 0 && n[C] == 1) --C;
  int A = C == 0 ? 1 : 0;
  for (int ax = 0; ax < C; ++ax)
    if (n[ax] > 1) {
      A = ax;
      break;
    }
  const int perm[3] = {A, 3 - A - C, C};

  const long long cm[3] = {nx, ny, nz};
  long long cst[3], xst[3], fst[3][3];
  strides(cm, cst);
  long long x0 = 0;
  // strides are 32-bit in the kernel: a field of 2^31 values or more is not
  // taken
  if ((nx + 2LL) * (ny + 2LL) * (nz + 2LL) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (pad) {
    const long long pm[3] = {nx + 2LL, ny + 2LL, nz + 2LL};
    strides(pm, xst);
    x0 = xst[0] + xst[1] + xst[2];
  } else {
    for (int k = 0; k < 3; ++k) xst[k] = cst[k];
  }
  for (int ax = 0; ax < 3; ++ax) {
    long long fm[3] = {cm[0], cm[1], cm[2]};
    fm[ax] += 1;
    strides(fm, fst[ax]);
  }
  const void* g[3] = {gx, gy, gz};
  const double ih[3] = {ihx, ihy, ihz};
  Params<T> p;
  p.x = (const T*)x + x0;
  p.d = (const T*)d;
  p.out = (T*)out;
  for (int k = 0; k < 3; ++k) {
    const int ax = perm[k];
    p.g[k] = (const T*)g[ax];
    p.n[k] = n[ax];
    p.xs[k] = (int)xst[ax];
    p.cs[k] = (int)cst[ax];
    for (int j = 0; j < 3; ++j) p.gs[k][j] = (int)fst[ax][perm[j]];
    p.ih[k] = (T)ih[ax];
    p.cyc[k] = (cyc_mask >> ax) & 1;
    p.alo[k] = a ? (T)a[2 * ax] : T(1);
    p.ahi[k] = a ? (T)a[2 * ax + 1] : T(1);
  }
  const long long plane = (long long)p.n[1] * p.n[2];
  const long long bx = (plane + HH_THREADS - 1) / HH_THREADS;
  int chunk = HH_CHUNK;
  if (chunk <= 0) {
    long long chunks = (HH_TARGET_BLOCKS + bx - 1) / bx;
    if (chunks > p.n[0]) chunks = p.n[0];
    chunk = (int)((p.n[0] + chunks - 1) / chunks);
  }
  if ((p.n[0] + chunk - 1) / chunk > 65535) chunk = (p.n[0] + 65534) / 65535;
  p.chunk = chunk;
  const dim3 grid((unsigned)bx, (unsigned)((p.n[0] + chunk - 1) / chunk));
  if (pad)
    helmholtz7_kernel<T, true><<<grid, HH_THREADS, 0, (cudaStream_t)stream>>>(p);
  else
    helmholtz7_kernel<T, false><<<grid, HH_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The padded form: xp (nx+2, ny+2, nz+2) with its ghosts filled.
extern "C" int helmholtz7_apply_f32(const void* xp, const void* gx, const void* gy,
                                    const void* gz, const void* d, void* out,
                                    int nx, int ny, int nz, double ihx,
                                    double ihy, double ihz, void* stream) {
  return launch<float>(true, xp, gx, gy, gz, d, out, nx, ny, nz, ihx, ihy,
                       ihz, 0, nullptr, stream);
}

extern "C" int helmholtz7_apply_f64(const void* xp, const void* gx, const void* gy,
                                    const void* gz, const void* d, void* out,
                                    int nx, int ny, int nz, double ihx,
                                    double ihy, double ihz, void* stream) {
  return launch<double>(true, xp, gx, gy, gz, d, out, nx, ny, nz, ihx, ihy,
                        ihz, 0, nullptr, stream);
}

// The BC form: x (nx, ny, nz) unpadded; bit ax of cyc_mask marks a cyclic
// axis, else ghost = alo_ax owner (low side) and ahi_ax owner (high side).
extern "C" int helmholtz7_apply_bc_f32(
    const void* x, const void* gx, const void* gy, const void* gz,
    const void* d, void* out, int nx, int ny, int nz, double ihx, double ihy,
    double ihz, int cyc_mask, double alo_x, double ahi_x, double alo_y,
    double ahi_y, double alo_z, double ahi_z, void* stream) {
  const double a[6] = {alo_x, ahi_x, alo_y, ahi_y, alo_z, ahi_z};
  return launch<float>(false, x, gx, gy, gz, d, out, nx, ny, nz, ihx, ihy,
                       ihz, cyc_mask, a, stream);
}

extern "C" int helmholtz7_apply_bc_f64(
    const void* x, const void* gx, const void* gy, const void* gz,
    const void* d, void* out, int nx, int ny, int nz, double ihx, double ihy,
    double ihz, int cyc_mask, double alo_x, double ahi_x, double alo_y,
    double ahi_y, double alo_z, double ahi_z, void* stream) {
  const double a[6] = {alo_x, ahi_x, alo_y, ahi_y, alo_z, ahi_z};
  return launch<double>(false, x, gx, gy, gz, d, out, nx, ny, nz, ihx, ihy,
                        ihz, cyc_mask, a, stream);
}
