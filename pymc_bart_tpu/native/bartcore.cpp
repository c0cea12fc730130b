// bartcore: host-side (CPU) sum-of-trees predictor over the same
// structure-of-arrays tree tensors the JAX sampler uses.
//
// Role: the reference implements its entire tree runtime natively (the
// external bartrs crate's TreeArrays.predict; SURVEY 2.3).  In the
// accelerator-native redesign the hot path is XLA, and this small C++ core is the
// host-side counterpart: a dependency-free predictor used (a) as an
// independent cross-check oracle for the JAX kernels, (b) as a fast
// fallback for CPU-only deployments of fitted models.  Semantics match
// ops/predict.py exactly: NaN routes right, the subset rule is a
// hash-salted random subset (ops/trees.py subset_member; any category
// count), excluded covariates are integrated out by
// row-count-weighted mass propagation, and leaves respond linearly
// through the parent's split covariate when slope != 0.
//
// Build: see build.py (g++ -O3 -shared -fPIC).  ABI: plain C, loaded via
// ctypes.

#include <cmath>
#include <cstdint>

namespace {

struct Tree {
    const int32_t* split_var;
    const float* split_val;
    const uint32_t* split_set;
    const float* leaf;   // [n_nodes, k]
    const float* count;  // [n_nodes]
    const float* slope;  // [n_nodes, k]
};

inline bool decide_left(float x, float val, uint32_t sset, int32_t rule) {
    if (std::isnan(x)) return false;  // NaN routes right
    switch (rule) {
        case 0: return x <= val;           // continuous
        case 1: return x == val;           // one-hot
        default: {                         // hash-salted random subset
            // identical mixing to ops/trees.py subset_member: the
            // stored word is a SALT; the split value's own category is
            // always a member (uint32 wraparound == int32 bit patterns)
            int32_t c = static_cast<int32_t>(x);
            if (!std::isnan(val) && c == static_cast<int32_t>(val))
                return true;
            uint32_t h = sset ^ (static_cast<uint32_t>(c) * 1103515245u);
            h = (h ^ (h >> 15)) * 73244475u;
            h = h ^ (h >> 13);
            return (h & 1u) != 0u;
        }
    }
}

// Accumulate w * leaf_response(node) into out[k].
inline void add_leaf(const Tree& t, int node, int k, const float* xrow,
                     int p, double w, double* out) {
    float xp = 0.0f;
    if (node > 0) {
        int parent = (node - 1) / 2;
        int pvar = t.split_var[parent];
        if (pvar >= 0 && pvar < p) {
            float v = xrow[pvar];
            xp = std::isnan(v) ? 0.0f : v;
        }
    }
    for (int j = 0; j < k; ++j) {
        out[j] += w * (t.leaf[node * k + j] + t.slope[node * k + j] * xp);
    }
}

void traverse(const Tree& t, int node, int k, const float* xrow, int p,
              const int32_t* rules, const uint8_t* excluded, double w,
              double* out) {
    int32_t var = t.split_var[node];
    if (var < 0) {
        add_leaf(t, node, k, xrow, p, w, out);
        return;
    }
    if (excluded != nullptr && excluded[var]) {
        double cl = t.count[2 * node + 1];
        double cr = t.count[2 * node + 2];
        double tot = cl + cr;
        if (tot < 1e-12) tot = 1e-12;
        traverse(t, 2 * node + 1, k, xrow, p, rules, excluded, w * cl / tot, out);
        traverse(t, 2 * node + 2, k, xrow, p, rules, excluded, w * cr / tot, out);
        return;
    }
    bool left = decide_left(xrow[var], t.split_val[node], t.split_set[node],
                            rules[var]);
    traverse(t, 2 * node + 1 + (left ? 0 : 1), k, xrow, p, rules, excluded, w,
             out);
}

}  // namespace

extern "C" {

// Sum-of-trees prediction for a stack of draws.
//   split_var  : int32 [draws, m, S]
//   split_val  : float [draws, m, S]
//   split_set  : uint32[draws, m, S]
//   leaf,slope : float [draws, m, S, k]
//   count      : float [draws, m, S]
//   X          : float [n, p]
//   rules      : int32 [p]
//   excluded   : uint8 [p] or NULL
//   out        : float [draws, n, k] (zeroed by caller or not; overwritten)
void bart_forest_predict(const int32_t* split_var, const float* split_val,
                         const uint32_t* split_set, const float* leaf,
                         const float* count, const float* slope,
                         int64_t draws, int64_t m, int64_t S, int64_t k,
                         const float* X, int64_t n, int64_t p,
                         const int32_t* rules, const uint8_t* excluded,
                         float* out) {
    for (int64_t d = 0; d < draws; ++d) {
        for (int64_t i = 0; i < n; ++i) {
            double acc[64] = {0.0};  // k <= 64 supported
            const float* xrow = X + i * p;
            for (int64_t j = 0; j < m; ++j) {
                int64_t base = (d * m + j);
                Tree t{split_var + base * S, split_val + base * S,
                       split_set + base * S, leaf + base * S * k,
                       count + base * S, slope + base * S * k};
                traverse(t, 0, static_cast<int>(k), xrow,
                         static_cast<int>(p), rules, excluded, 1.0, acc);
            }
            float* o = out + (d * n + i) * k;
            for (int64_t j = 0; j < k; ++j) o[j] = static_cast<float>(acc[j]);
        }
    }
}

int bart_core_abi_version() { return 1; }

}  // extern "C"
