// Native host runtime ops of superdsm_tpu_torch: the port's own copy of the
// JAX package's superdsm_tpu/native/watershed.cpp (same code, same symbols;
// tests/test_torch_native.py holds the two libraries bitwise equal).
//
// Marker-based priority-flood watershed (functional counterpart of
// skimage.segmentation.watershed as the reference SuperDSM uses it in
// superdsm/c2freganal.py:37 and superdsm/render.py:388-451), plus a
// chessboard distance transform used by the deformation-basis subsample
// grid.
//
// Exposed as plain C symbols and loaded via ctypes; no Python dependency.

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <functional>
#include <queue>
#include <utility>
#include <vector>
#include <cstring>
#include <limits>

namespace {

// Heap entries are (key, idx) where key packs (value, age) into one uint64
// for a single branchless comparison: the float bits are mapped to a
// monotone unsigned order (sign-magnitude -> biased), the 32-bit age
// tie-breaks pushes in FIFO order. Pushes are bounded by 2*H*W, so a
// uint32 age cannot wrap for any image smaller than ~65k x 65k.
inline uint64_t pack_key(float value, uint32_t age) {
    uint32_t b;
    std::memcpy(&b, &value, 4);
    if (b == 0x80000000u) b = 0;  // -0.0 == +0.0 must stay an age-order tie
    b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    return (static_cast<uint64_t>(b) << 32) | age;
}

using QEntry = std::pair<uint64_t, int32_t>;  // (key, idx), min-ordered

}  // namespace

extern "C" {

// Priority-flood watershed on a 2D grid.
//   image:   H*W float32 (lower values flooded first)
//   markers: H*W int32 (>0 seed labels, 0 elsewhere)
//   mask:    H*W uint8 (1 = floodable) or nullptr for all-true
//   conn:    4 or 8
//   out:     H*W int32 result labels (0 where unreached)
void sdsm_watershed(const float* image, const int32_t* markers,
                    const uint8_t* mask, int32_t H, int32_t W,
                    int32_t conn, int32_t* out) {
    const int64_t n = static_cast<int64_t>(H) * W;
    std::priority_queue<QEntry, std::vector<QEntry>, std::greater<QEntry>> heap;
    uint32_t age = 0;

    const int dr8[8] = {-1, 1, 0, 0, -1, -1, 1, 1};
    const int dc8[8] = {0, 0, -1, 1, -1, 1, -1, 1};
    const int nn = (conn == 8) ? 8 : 4;

    std::vector<uint8_t> queued(n, 0);
    for (int64_t i = 0; i < n; ++i) {
        out[i] = markers[i];
        queued[i] = (markers[i] > 0) ? 1 : 0;
    }

    // Seed the heap with BOUNDARY marker pixels only: an interior marker
    // pixel (every in-bounds floodable neighbor already labeled) pops
    // without labeling anything, so skipping it preserves the output
    // exactly (relative push order among the remaining pixels is
    // unchanged) while shrinking the initial heap by the marker interiors.
    for (int64_t i = 0; i < n; ++i) {
        if (markers[i] <= 0 || (mask && !mask[i])) continue;
        const int32_t r = static_cast<int32_t>(i / W), c = static_cast<int32_t>(i % W);
        bool useful = false;
        for (int k = 0; k < nn; ++k) {
            const int32_t rr = r + dr8[k], cc = c + dc8[k];
            if (rr < 0 || rr >= H || cc < 0 || cc >= W) continue;
            const int64_t j = static_cast<int64_t>(rr) * W + cc;
            if (!queued[j] && (!mask || mask[j])) { useful = true; break; }
        }
        if (useful) heap.push({pack_key(image[i], age), static_cast<int32_t>(i)});
        ++age;  // keep age assignment identical to the all-markers scan
    }

    while (!heap.empty()) {
        QEntry e = heap.top();
        heap.pop();
        const int32_t r = e.second / W, c = e.second % W;
        const int32_t label = out[e.second];
        for (int k = 0; k < nn; ++k) {
            const int32_t rr = r + dr8[k], cc = c + dc8[k];
            if (rr < 0 || rr >= H || cc < 0 || cc >= W) continue;
            const int64_t j = static_cast<int64_t>(rr) * W + cc;
            if (queued[j]) continue;
            if (mask && !mask[j]) continue;
            out[j] = label;
            queued[j] = 1;
            heap.push({pack_key(image[j], age++), static_cast<int32_t>(j)});
        }
    }
}

// Exact euclidean distance transform (Felzenszwalb-Huttenlocher separable
// lower-envelope pass over exact integer squared distances). Matches
// scipy.ndimage.distance_transform_edt bit-for-bit: both compute the exact
// integer d^2 to the nearest zero pixel and take one correctly-rounded
// double sqrt. `mask`: uint8, distances are computed for nonzero pixels to
// the nearest zero pixel (zero pixels get 0).
void sdsm_edt(const uint8_t* mask, int32_t H, int32_t W, double* out) {
    const int64_t n = static_cast<int64_t>(H) * W;
    const int32_t INFD = H + W + 1;   // larger than any in-image distance
    std::vector<int32_t> g(n);
    // vertical pass: per column, integer distance to nearest zero in-column
    for (int32_t c = 0; c < W; ++c) {
        int32_t d = INFD;
        for (int32_t r = 0; r < H; ++r) {
            d = mask[static_cast<int64_t>(r) * W + c] ? std::min(d + 1, INFD) : 0;
            g[static_cast<int64_t>(r) * W + c] = d;
        }
        d = INFD;
        for (int32_t r = H - 1; r >= 0; --r) {
            const int64_t i = static_cast<int64_t>(r) * W + c;
            d = mask[i] ? std::min(d + 1, INFD) : 0;
            g[i] = std::min(g[i], d);
        }
    }
    // horizontal pass: per row, lower envelope of parabolas q -> (q-c)^2 + g^2
    std::vector<int64_t> f(W);
    std::vector<int32_t> v(W);
    std::vector<double> z(W + 1);
    for (int32_t r = 0; r < H; ++r) {
        const int64_t base = static_cast<int64_t>(r) * W;
        for (int32_t c = 0; c < W; ++c) {
            const int64_t gv = g[base + c];
            f[c] = gv * gv;
        }
        int32_t k = 0;
        v[0] = 0;
        z[0] = -std::numeric_limits<double>::infinity();
        z[1] = std::numeric_limits<double>::infinity();
        for (int32_t q = 1; q < W; ++q) {
            double s;
            while (true) {
                const int32_t p = v[k];
                s = (static_cast<double>(f[q] - f[p]) +
                     static_cast<double>(q) * q - static_cast<double>(p) * p) /
                    (2.0 * (q - p));
                if (s <= z[k] && k > 0) { --k; } else break;
            }
            ++k;
            v[k] = q;
            z[k] = s;
            z[k + 1] = std::numeric_limits<double>::infinity();
        }
        k = 0;
        for (int32_t q = 0; q < W; ++q) {
            while (z[k + 1] < q) ++k;
            const int64_t dq = q - v[k];
            out[base + q] = std::sqrt(static_cast<double>(dq * dq + f[v[k]]));
        }
    }
}

// 3x3 maximum filter on doubles: conn=4 uses the cross footprint (disk(1)),
// conn=8 the full 3x3 (separable row-then-column max). Border handling
// matches scipy's default 'reflect' mode, which for a radius-1 window is
// equivalent to skipping out-of-bounds neighbors.
void sdsm_maxfilt3(const double* img, int32_t H, int32_t W, int32_t conn,
                   double* out) {
    if (conn == 8) {
        std::vector<double> tmp(static_cast<int64_t>(H) * W);
        for (int32_t r = 0; r < H; ++r) {
            const double* row = img + static_cast<int64_t>(r) * W;
            double* trow = tmp.data() + static_cast<int64_t>(r) * W;
            for (int32_t c = 0; c < W; ++c) {
                double m = row[c];
                if (c > 0 && row[c - 1] > m) m = row[c - 1];
                if (c + 1 < W && row[c + 1] > m) m = row[c + 1];
                trow[c] = m;
            }
        }
        for (int32_t r = 0; r < H; ++r) {
            double* orow = out + static_cast<int64_t>(r) * W;
            const double* t0 = tmp.data() + static_cast<int64_t>(r) * W;
            const double* tu = (r > 0) ? t0 - W : t0;
            const double* td = (r + 1 < H) ? t0 + W : t0;
            for (int32_t c = 0; c < W; ++c) {
                double m = t0[c];
                if (tu[c] > m) m = tu[c];
                if (td[c] > m) m = td[c];
                orow[c] = m;
            }
        }
    } else {
        for (int32_t r = 0; r < H; ++r) {
            const double* row = img + static_cast<int64_t>(r) * W;
            const double* up = (r > 0) ? row - W : row;
            const double* dn = (r + 1 < H) ? row + W : row;
            double* orow = out + static_cast<int64_t>(r) * W;
            for (int32_t c = 0; c < W; ++c) {
                double m = row[c];
                if (c > 0 && row[c - 1] > m) m = row[c - 1];
                if (c + 1 < W && row[c + 1] > m) m = row[c + 1];
                if (up[c] > m) m = up[c];
                if (dn[c] > m) m = dn[c];
                orow[c] = m;
            }
        }
    }
}

// Chessboard (Chebyshev) distance to the nearest true pixel of `sources`.
// Two-pass chamfer; exact for the chessboard metric.
void sdsm_chessboard_edt(const uint8_t* sources, int32_t H, int32_t W,
                         int32_t* out) {
    const int32_t INF = std::numeric_limits<int32_t>::max() / 4;
    for (int64_t i = 0; i < static_cast<int64_t>(H) * W; ++i)
        out[i] = sources[i] ? 0 : INF;
    // forward pass
    for (int32_t r = 0; r < H; ++r) {
        for (int32_t c = 0; c < W; ++c) {
            int64_t i = static_cast<int64_t>(r) * W + c;
            int32_t v = out[i];
            if (r > 0) {
                v = std::min(v, out[i - W] + 1);
                if (c > 0) v = std::min(v, out[i - W - 1] + 1);
                if (c + 1 < W) v = std::min(v, out[i - W + 1] + 1);
            }
            if (c > 0) v = std::min(v, out[i - 1] + 1);
            out[i] = v;
        }
    }
    // backward pass
    for (int32_t r = H - 1; r >= 0; --r) {
        for (int32_t c = W - 1; c >= 0; --c) {
            int64_t i = static_cast<int64_t>(r) * W + c;
            int32_t v = out[i];
            if (r + 1 < H) {
                v = std::min(v, out[i + W] + 1);
                if (c > 0) v = std::min(v, out[i + W - 1] + 1);
                if (c + 1 < W) v = std::min(v, out[i + W + 1] + 1);
            }
            if (c + 1 < W) v = std::min(v, out[i + 1] + 1);
            out[i] = v;
        }
    }
}

// Greedy chessboard-coverage subsample grid (counterpart of the reference
// SuperDSM's superdsm/dsm.py:164-181): starting from a regular stride
// grid intersected with the mask, repeatedly add the masked pixel with the
// smallest distance >= stride until the mask is covered.
// Returns the number of grid points written to grid_out (H*W uint8).
int32_t sdsm_subsample_grid(const uint8_t* mask, int32_t H, int32_t W,
                            int32_t stride, int32_t off_r, int32_t off_c,
                            uint8_t* grid_out) {
    const int64_t n = static_cast<int64_t>(H) * W;
    std::memset(grid_out, 0, n);
    std::vector<uint8_t> seed(n, 0);
    int32_t count = 0;
    for (int32_t r = off_r; r < H; r += stride)
        for (int32_t c = off_c; c < W; c += stride) {
            int64_t i = static_cast<int64_t>(r) * W + c;
            if (mask[i]) { grid_out[i] = 1; seed[i] = 1; count++; }
        }
    std::vector<int32_t> dist(n);
    sdsm_chessboard_edt(seed.data(), H, W, dist.data());
    // mask out distances outside the mask (reference multiplies by mask)
    for (int64_t i = 0; i < n; ++i) if (!mask[i]) dist[i] = 0;
    // Greedy loop over a shrinking worklist. Only pixels with
    // dist >= stride can ever be picked, dist never increases, and the
    // output is just the picked points — so pixels whose dist falls below
    // stride are dropped for good, and each iteration touches O(|work|)
    // instead of O(H*W). The worklist stays row-major sorted (built
    // ascending, compacted stably) and the argmin uses strict <, so the
    // tie-break matches the original full row-major scan exactly.
    std::vector<int64_t> work;
    for (int64_t i = 0; i < n; ++i)
        if (dist[i] >= stride) work.push_back(i);
    while (!work.empty()) {
        int32_t best = std::numeric_limits<int32_t>::max();
        int64_t best_i = -1;
        size_t m = 0;
        for (size_t j = 0; j < work.size(); ++j) {
            const int64_t i = work[j];
            const int32_t v = dist[i];
            if (v < stride) continue;
            work[m++] = i;
            if (v < best) { best = v; best_i = i; }
        }
        work.resize(m);
        if (best_i < 0) break;
        grid_out[best_i] = 1;
        count++;
        const int32_t r0 = static_cast<int32_t>(best_i / W);
        const int32_t c0 = static_cast<int32_t>(best_i % W);
        // dist[i] can only drop to cheb(i, new point); pixels outside the
        // worklist are already below stride and never read again.
        for (size_t j = 0; j < work.size(); ++j) {
            const int64_t i = work[j];
            const int32_t r = static_cast<int32_t>(i / W);
            const int32_t c = static_cast<int32_t>(i % W);
            const int32_t dr = (r >= r0) ? (r - r0) : (r0 - r);
            const int32_t dc = (c >= c0) ? (c - c0) : (c0 - c);
            const int32_t d = (dr > dc) ? dr : dc;
            if (d < dist[i]) dist[i] = d;
        }
    }
    return count;
}

}  // extern "C"
