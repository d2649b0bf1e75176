// Native host-side graph construction for spiking_neural_networks_jax.
//
// Host-side counterpart of the reference's graph-building layer
// (`reference/backend/src/graph/mod.rs` AdjacencyMatrix/AdjacencyList
// construction and `Lattice::connect`, neuron/mod.rs:1134-1157): where the
// reference evaluates an O(N^2) closure in Rust, this library generates the
// standard connectivity patterns (radius-limited lattices, Erdos-Renyi,
// Hopfield outer products) directly into COO edge arrays that feed the
// device-resident SparseGraph/StencilGraph — the host-side hot path for
// >10^5-neuron lattices where a Python loop is impossible.
//
// Plain C ABI for ctypes binding (no pybind11 in the image).

#include <cstdint>
#include <cmath>
#include <cstddef>

namespace {

// xorshift128+ PRNG: fast, seedable, reproducible across platforms.
struct Rng {
    uint64_t s0, s1;
    explicit Rng(uint64_t seed) {
        // splitmix64 seeding
        uint64_t z = seed + 0x9E3779B97F4A7C15ULL;
        auto next = [&z]() {
            z += 0x9E3779B97F4A7C15ULL;
            uint64_t x = z;
            x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
            x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
            return x ^ (x >> 31);
        };
        s0 = next();
        s1 = next();
    }
    uint64_t next() {
        uint64_t x = s0, y = s1;
        s0 = y;
        x ^= x << 23;
        s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
        return s1 + y;
    }
    double uniform() {  // [0, 1)
        return (next() >> 11) * (1.0 / 9007199254740992.0);
    }
};

enum WeightMode : int32_t {
    CONSTANT = 0,
    DISTANCE = 1,          // Euclidean distance between positions
    INV_DISTANCE = 2,      // 1 / distance
    GAUSSIAN = 3,          // exp(-d^2 / (2 sigma^2)) * scale
    UNIFORM_RANDOM = 4,    // U[param0, param1)
};

inline float edge_weight(int32_t mode, double dist, double p0, double p1,
                         Rng& rng) {
    switch (mode) {
        case DISTANCE: return (float)(dist * p0);
        case INV_DISTANCE: return (float)(dist > 0 ? p0 / dist : p0);
        case GAUSSIAN: return (float)(p1 * std::exp(-dist * dist / (2.0 * p0 * p0)));
        case UNIFORM_RANDOM: return (float)(p0 + rng.uniform() * (p1 - p0));
        default: return (float)p0;
    }
}

}  // namespace

extern "C" {

// Count + emit edges for radius-limited connectivity on a (rows, cols) grid:
// src (r+dr, c+dc) -> dst (r, c) for all offsets with Euclidean distance
// <= radius, kept with probability keep_prob, excluding self loops.
// Returns the number of edges written.  Buffers must be sized for the upper
// bound rows*cols*n_offsets (n_offsets = count of (dr, dc) within radius).
int64_t build_radius_edges(
    int64_t rows, int64_t cols, double radius, double keep_prob,
    uint64_t seed, int32_t weight_mode, double wparam0, double wparam1,
    int32_t* src, int32_t* dst, float* w) {
    Rng rng(seed);
    const int64_t r_max = (int64_t)std::ceil(radius);
    int64_t count = 0;
    for (int64_t r = 0; r < rows; ++r) {
        for (int64_t c = 0; c < cols; ++c) {
            const int64_t dst_idx = r * cols + c;
            for (int64_t dr = -r_max; dr <= r_max; ++dr) {
                for (int64_t dc = -r_max; dc <= r_max; ++dc) {
                    if (dr == 0 && dc == 0) continue;
                    const double dist = std::sqrt((double)(dr * dr + dc * dc));
                    if (dist > radius) continue;
                    const int64_t sr = r + dr, sc = c + dc;
                    if (sr < 0 || sr >= rows || sc < 0 || sc >= cols) continue;
                    if (keep_prob < 1.0 && rng.uniform() > keep_prob) continue;
                    src[count] = (int32_t)(sr * cols + sc);
                    dst[count] = (int32_t)dst_idx;
                    w[count] = edge_weight(weight_mode, dist, wparam0, wparam1,
                                           rng);
                    ++count;
                }
            }
        }
    }
    return count;
}

// Erdos-Renyi connectivity between two flat populations (n_pre -> n_post)
// with probability p; self loops excluded when exclude_self != 0 (square
// case).  Returns edges written (buffers sized n_pre * n_post worst case,
// or use expected + slack for large graphs via two passes).
int64_t build_random_edges(
    int64_t n_pre, int64_t n_post, double p, int32_t exclude_self,
    uint64_t seed, int32_t weight_mode, double wparam0, double wparam1,
    int32_t* src, int32_t* dst, float* w, int64_t capacity) {
    Rng rng(seed);
    int64_t count = 0;
    for (int64_t i = 0; i < n_pre; ++i) {
        for (int64_t j = 0; j < n_post; ++j) {
            if (exclude_self && i == j) continue;
            if (rng.uniform() > p) continue;
            if (count >= capacity) return -1;
            src[count] = (int32_t)i;
            dst[count] = (int32_t)j;
            w[count] = edge_weight(weight_mode, 0.0, wparam0, wparam1, rng);
            ++count;
        }
    }
    return count;
}

// Hopfield outer-product accumulation (attractors/mod.rs:486-557 semantics):
// w[i*n + j] += (p_k[i] - b) * (p_k[j] - a) for all patterns, zero diagonal,
// then scaled.  patterns: (num_patterns, n) as uint8 (0/1).
void hopfield_accumulate(
    const uint8_t* patterns, int64_t num_patterns, int64_t n,
    double a, double b, double scalar, float* w) {
    for (int64_t k = 0; k < num_patterns; ++k) {
        const uint8_t* p = patterns + k * n;
        for (int64_t i = 0; i < n; ++i) {
            const double pi = (double)p[i] - b;
            float* row = w + i * n;
            for (int64_t j = 0; j < n; ++j) {
                row[j] += (float)(pi * ((double)p[j] - a));
            }
        }
    }
    for (int64_t d = 0; d < n; ++d) w[d * n + d] = 0.0f;
    if (scalar != 1.0) {
        for (int64_t i = 0; i < n * n; ++i) w[i] = (float)(w[i] * scalar);
    }
}

// In-degree histogram for a COO edge list (the averaging denominator,
// neuron/mod.rs:722-729).
void in_degree(const int32_t* dst, int64_t n_edges, float* deg,
               int64_t n_post) {
    for (int64_t i = 0; i < n_post; ++i) deg[i] = 0.0f;
    for (int64_t e = 0; e < n_edges; ++e) deg[dst[e]] += 1.0f;
}

}  // extern "C"
