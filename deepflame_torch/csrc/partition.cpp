// Domain partition planners (native host code of the port).
//
// Role parity: OpenFOAM decomposePar, which partitions the mesh across MPI
// ranks before processor patches carry the halos. The port's
// parallel.distributed runs one rank per block of a (dx, dy, dz) grid and
// parallel.distributed_fl one rank per contiguous cell slab; these choose
// the grid and the slabs (deepflame_torch.native, use_native=True).
//
// API (ctypes):
//   part_balance(nx, ny, nz, ndev, out_dims[3])
//       -> choose a 3-axis device grid (dx, dy, dz) minimizing halo surface
//   part_slabs(n, ndev, out_starts[ndev+1])
//       -> balanced 1-axis split points
//   part_halo_indices(nx_local, ny, nz, out_lo, out_hi)
//       -> flat cell indices of the low/high x-boundary layers
#include <cstdint>
#include <climits>

extern "C" {

// Surface-minimizing factorization of ndev into (dx, dy, dz) that divides
// work most evenly over (nx, ny, nz).
void part_balance(int nx, int ny, int nz, int ndev, int* out_dims) {
    long best_cost = LONG_MAX;
    int best[3] = {ndev, 1, 1};
    for (int dx = 1; dx <= ndev; ++dx) {
        if (ndev % dx) continue;
        int rem = ndev / dx;
        for (int dy = 1; dy <= rem; ++dy) {
            if (rem % dy) continue;
            int dz = rem / dy;
            if (dx > nx || dy > ny || dz > nz) continue;
            // halo surface per device (two faces per split axis)
            long sx = (dx > 1) ? 2L * (ny / dy) * (nz / dz) : 0;
            long sy = (dy > 1) ? 2L * (nx / dx) * (nz / dz) : 0;
            long sz = (dz > 1) ? 2L * (nx / dx) * (ny / dy) : 0;
            // imbalance penalty: remainder cells
            long imb = (nx % dx) * 1000L + (ny % dy) * 1000L + (nz % dz) * 1000L;
            long cost = sx + sy + sz + imb;
            if (cost < best_cost) {
                best_cost = cost;
                best[0] = dx; best[1] = dy; best[2] = dz;
            }
        }
    }
    out_dims[0] = best[0];
    out_dims[1] = best[1];
    out_dims[2] = best[2];
}

// Balanced split of n cells over ndev devices: out_starts has ndev+1 entries.
void part_slabs(int n, int ndev, int* out_starts) {
    int base = n / ndev, rem = n % ndev, acc = 0;
    for (int d = 0; d < ndev; ++d) {
        out_starts[d] = acc;
        acc += base + (d < rem ? 1 : 0);
    }
    out_starts[ndev] = acc;
}

// Flat (C-order) indices of the two x-boundary cell layers of a local block.
void part_halo_indices(int nx_local, int ny, int nz,
                       int64_t* out_lo, int64_t* out_hi) {
    int64_t plane = static_cast<int64_t>(ny) * nz;
    for (int64_t j = 0; j < ny; ++j) {
        for (int64_t k = 0; k < nz; ++k) {
            int64_t idx = j * nz + k;
            out_lo[idx] = idx;                              // i = 0
            out_hi[idx] = (nx_local - 1) * plane + idx;     // i = nx-1
        }
    }
}

}  // extern "C"
