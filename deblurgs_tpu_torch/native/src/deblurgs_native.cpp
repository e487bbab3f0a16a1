// deblurgs_tpu native host library: exact 3-NN seeding + COLMAP binary parsing.
//
// TPU-native counterpart of the reference's native runtime components that are
// not device compute (SURVEY.md §2.1): the simple-knn CUDA extension
// (submodules/simple-knn/simple_knn.cu — Morton sort + box-pruned exact K=3)
// becomes a uniform-grid exact 3-NN here (host-side, used for Gaussian scale
// seeding at init), and the COLMAP points3D.bin record walk (pure-Python
// struct loop in the reference's colmap_loader.py:125-155) becomes a single
// buffer pass. Exposed through a C ABI for ctypes (no pybind11 dependency).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libdeblurgs_native.so deblurgs_native.cpp -fopenmp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Exact mean squared distance to the 3 nearest neighbors.
//
// Uniform grid bucketing + expanding-ring search with a ring lower bound:
// a candidate ring at Chebyshev distance r from the query's cell cannot
// contain any point closer than (r-1)*cell, so once the 3rd-best distance
// is below that bound the search is provably complete (same exactness
// contract as the reference's box pruning).
// ---------------------------------------------------------------------------
void knn3_mean_sq(const float* pts, int64_t n, float* out) {
    if (n <= 0) return;
    if (n <= 4) {
        for (int64_t i = 0; i < n; ++i) {
            float best[3] = {1e30f, 1e30f, 1e30f};
            for (int64_t j = 0; j < n; ++j) {
                if (i == j) continue;
                float dx = pts[3 * i] - pts[3 * j];
                float dy = pts[3 * i + 1] - pts[3 * j + 1];
                float dz = pts[3 * i + 2] - pts[3 * j + 2];
                float d2 = dx * dx + dy * dy + dz * dz;
                if (d2 < best[2]) {
                    best[2] = d2;
                    if (best[2] < best[1]) std::swap(best[1], best[2]);
                    if (best[1] < best[0]) std::swap(best[0], best[1]);
                }
            }
            int k = n - 1 < 3 ? (int)(n - 1) : 3;
            float s = 0;
            for (int t = 0; t < k; ++t) s += best[t];
            out[i] = k > 0 ? s / k : 0.0f;
        }
        return;
    }

    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = 0; i < n; ++i)
        for (int d = 0; d < 3; ++d) {
            mn[d] = std::min(mn[d], pts[3 * i + d]);
            mx[d] = std::max(mx[d], pts[3 * i + d]);
        }
    // ~4 points per cell on average
    int G = (int)std::ceil(std::cbrt((double)n / 4.0));
    G = std::max(1, std::min(G, 512));
    float ext[3], cell[3];
    for (int d = 0; d < 3; ++d) {
        ext[d] = std::max(mx[d] - mn[d], 1e-9f);
        cell[d] = ext[d] / G;
    }
    auto cell_of = [&](int64_t i, int d) {
        int c = (int)((pts[3 * i + d] - mn[d]) / cell[d]);
        return std::min(std::max(c, 0), G - 1);
    };

    // counting sort into cells
    const int64_t ncells = (int64_t)G * G * G;
    std::vector<int64_t> counts(ncells + 1, 0);
    std::vector<int32_t> cidx(n);
    for (int64_t i = 0; i < n; ++i) {
        int cx = cell_of(i, 0), cy = cell_of(i, 1), cz = cell_of(i, 2);
        cidx[i] = (cz * G + cy) * G + cx;
        counts[cidx[i] + 1]++;
    }
    for (int64_t c = 0; c < ncells; ++c) counts[c + 1] += counts[c];
    std::vector<int32_t> order(n);
    {
        std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
        for (int64_t i = 0; i < n; ++i) order[cursor[cidx[i]]++] = (int32_t)i;
    }

    const float min_cell = std::min(cell[0], std::min(cell[1], cell[2]));

#pragma omp parallel for schedule(dynamic, 256)
    for (int64_t i = 0; i < n; ++i) {
        const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
        const int cx = cell_of(i, 0), cy = cell_of(i, 1), cz = cell_of(i, 2);
        float best[3] = {1e30f, 1e30f, 1e30f};

        for (int r = 0; r < G; ++r) {
            // provable completeness: ring r's nearest possible point is at
            // least (r-1)*min_cell away from the query
            if (r >= 2) {
                float bound = (r - 1) * min_cell;
                if (best[2] < bound * bound) break;
            }
            int x0 = std::max(cx - r, 0), x1 = std::min(cx + r, G - 1);
            int y0 = std::max(cy - r, 0), y1 = std::min(cy + r, G - 1);
            int z0 = std::max(cz - r, 0), z1 = std::min(cz + r, G - 1);
            bool any = false;
            for (int z = z0; z <= z1; ++z)
                for (int y = y0; y <= y1; ++y)
                    for (int x = x0; x <= x1; ++x) {
                        // only the shell of the ring (interior already done)
                        if (r > 0 && std::abs(x - cx) != r &&
                            std::abs(y - cy) != r && std::abs(z - cz) != r)
                            continue;
                        any = true;
                        int64_t c = ((int64_t)z * G + y) * G + x;
                        for (int64_t t = counts[c]; t < counts[c + 1]; ++t) {
                            int32_t j = order[t];
                            if (j == (int32_t)i) continue;
                            float dx = px - pts[3 * j];
                            float dy = py - pts[3 * j + 1];
                            float dz2 = pz - pts[3 * j + 2];
                            float d2 = dx * dx + dy * dy + dz2 * dz2;
                            if (d2 < best[2]) {
                                best[2] = d2;
                                if (best[2] < best[1]) std::swap(best[1], best[2]);
                                if (best[1] < best[0]) std::swap(best[0], best[1]);
                            }
                        }
                    }
            if (!any && r > 0 && x0 == 0 && y0 == 0 && z0 == 0 &&
                x1 == G - 1 && y1 == G - 1 && z1 == G - 1)
                break;  // searched everything
        }
        out[i] = (best[0] + best[1] + best[2]) / 3.0f;
    }
}

// ---------------------------------------------------------------------------
// COLMAP points3D.bin: one pass over the mmapped/loaded buffer.
// Record: u64 id | 3*f64 xyz | 3*u8 rgb | f64 error | u64 track_len |
//         track_len * (u32 image_id, u32 point2D_idx)
// Returns number of points parsed, or -1 on malformed input.
// ---------------------------------------------------------------------------
int64_t parse_points3d_bin(const uint8_t* buf, int64_t size,
                           double* xyz, uint8_t* rgb, double* err,
                           int64_t max_points) {
    if (size < 8) return -1;
    uint64_t num;
    std::memcpy(&num, buf, 8);
    int64_t off = 8;
    int64_t count = 0;
    for (uint64_t i = 0; i < num && count < max_points; ++i) {
        if (off + 8 + 24 + 3 + 8 + 8 > size) return -1;
        off += 8;  // id
        std::memcpy(xyz + 3 * count, buf + off, 24);
        off += 24;
        std::memcpy(rgb + 3 * count, buf + off, 3);
        off += 3;
        std::memcpy(err + count, buf + off, 8);
        off += 8;
        uint64_t track;
        std::memcpy(&track, buf + off, 8);
        off += 8;
        off += (int64_t)track * 8;
        if (off > size) return -1;
        ++count;
    }
    return count;
}

}  // extern "C"
