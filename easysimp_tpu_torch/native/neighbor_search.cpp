// Fixed-radius neighbor search over cell centers — native replacement for the
// reference's NearestNeighbors.jl KD-tree + inrange queries
// (src/Optimization/FilterCommon.jl:82-90).  Used to build the unstructured
// filter cache; the voxel path needs no search (fixed stencil).
//
// Algorithm: uniform grid hash with bin size = radius; each query point scans
// its 27 neighboring bins.  O(n + total_neighbors) with small constants —
// build+query is ~10x faster than a KD-tree for the fixed-radius,
// all-points-query pattern the filter cache needs.
//
// C ABI (ctypes):
//   nbsearch_count(centers, n, radius, offsets[n+1]) -> total pair count
//   nbsearch_fill(centers, n, radius, offsets, idx[total], weights[total])
// `weights` receives the linear cone weight max(0, R - d) per neighbor.

#include <cstdint>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct GridHash {
    double ox, oy, oz, inv_h;
    int64_t nx, ny, nz;
    std::vector<int64_t> bin_start;   // size nbins+1
    std::vector<int64_t> order;       // point ids sorted by bin

    GridHash(const double* c, int64_t n, double h) {
        double minx = 1e300, miny = 1e300, minz = 1e300;
        double maxx = -1e300, maxy = -1e300, maxz = -1e300;
        for (int64_t i = 0; i < n; ++i) {
            minx = std::min(minx, c[3 * i]);
            maxx = std::max(maxx, c[3 * i]);
            miny = std::min(miny, c[3 * i + 1]);
            maxy = std::max(maxy, c[3 * i + 1]);
            minz = std::min(minz, c[3 * i + 2]);
            maxz = std::max(maxz, c[3 * i + 2]);
        }
        ox = minx; oy = miny; oz = minz;
        inv_h = 1.0 / h;
        nx = std::max<int64_t>(1, (int64_t)((maxx - minx) * inv_h) + 1);
        ny = std::max<int64_t>(1, (int64_t)((maxy - miny) * inv_h) + 1);
        nz = std::max<int64_t>(1, (int64_t)((maxz - minz) * inv_h) + 1);

        const int64_t nbins = nx * ny * nz;
        std::vector<int64_t> count(nbins + 1, 0);
        std::vector<int64_t> bin_of(n);
        for (int64_t i = 0; i < n; ++i) {
            bin_of[i] = bin_index(c[3 * i], c[3 * i + 1], c[3 * i + 2]);
            ++count[bin_of[i] + 1];
        }
        for (int64_t b = 0; b < nbins; ++b) count[b + 1] += count[b];
        bin_start = count;
        order.resize(n);
        std::vector<int64_t> cursor(bin_start.begin(), bin_start.end() - 1);
        for (int64_t i = 0; i < n; ++i) order[cursor[bin_of[i]]++] = i;
    }

    inline int64_t clampi(int64_t v, int64_t lo, int64_t hi) const {
        return v < lo ? lo : (v > hi ? hi : v);
    }

    inline int64_t bin_index(double x, double y, double z) const {
        int64_t ix = clampi((int64_t)((x - ox) * inv_h), 0, nx - 1);
        int64_t iy = clampi((int64_t)((y - oy) * inv_h), 0, ny - 1);
        int64_t iz = clampi((int64_t)((z - oz) * inv_h), 0, nz - 1);
        return ix + nx * (iy + ny * iz);
    }

    template <typename F>
    void for_neighbors(const double* c, int64_t i, double radius, F&& f) const {
        const double r2 = radius * radius;
        const double xi = c[3 * i], yi = c[3 * i + 1], zi = c[3 * i + 2];
        int64_t bx = clampi((int64_t)((xi - ox) * inv_h), 0, nx - 1);
        int64_t by = clampi((int64_t)((yi - oy) * inv_h), 0, ny - 1);
        int64_t bz = clampi((int64_t)((zi - oz) * inv_h), 0, nz - 1);
        for (int64_t dz = -1; dz <= 1; ++dz) {
            int64_t z = bz + dz;
            if (z < 0 || z >= nz) continue;
            for (int64_t dy = -1; dy <= 1; ++dy) {
                int64_t y = by + dy;
                if (y < 0 || y >= ny) continue;
                for (int64_t dx = -1; dx <= 1; ++dx) {
                    int64_t x = bx + dx;
                    if (x < 0 || x >= nx) continue;
                    const int64_t b = x + nx * (y + ny * z);
                    for (int64_t k = bin_start[b]; k < bin_start[b + 1]; ++k) {
                        const int64_t j = order[k];
                        const double ddx = c[3 * j] - xi;
                        const double ddy = c[3 * j + 1] - yi;
                        const double ddz = c[3 * j + 2] - zi;
                        const double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                        if (d2 <= r2) f(j, std::sqrt(d2));
                    }
                }
            }
        }
    }
};

}  // namespace

extern "C" {

// Phase 1: per-point neighbor counts -> prefix offsets[n+1]; returns total.
int64_t nbsearch_count(const double* centers, int64_t n, double radius,
                       int64_t* offsets) {
    GridHash grid(centers, n, radius);
    offsets[0] = 0;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        int64_t cnt = 0;
        grid.for_neighbors(centers, i, radius,
                           [&](int64_t, double) { ++cnt; });
        offsets[i + 1] = cnt;
    }
    for (int64_t i = 0; i < n; ++i) offsets[i + 1] += offsets[i];
    return offsets[n];
}

// Phase 2: fill CSR neighbor ids + cone weights max(0, R - d).
void nbsearch_fill(const double* centers, int64_t n, double radius,
                   const int64_t* offsets, int32_t* idx, double* weights) {
    GridHash grid(centers, n, radius);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        int64_t k = offsets[i];
        grid.for_neighbors(centers, i, radius, [&](int64_t j, double d) {
            idx[k] = (int32_t)j;
            weights[k] = radius - d > 0.0 ? radius - d : 0.0;
            ++k;
        });
    }
}

}  // extern "C"
