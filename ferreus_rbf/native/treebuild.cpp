// Native octree interaction-list builder.
//
// The adaptive u/v/w/x interaction lists (definitions as documented in
// ferreus_rbf/ops/fmm/tree.py, matching the reference's adaptive FMM
// lists) are pure integer combinatorics over the cell table — the one
// setup-time piece that doesn't vectorise cleanly. This native
// implementation walks the same neighbour/frontier logic with open-address
// hash lookups; the Python layer falls back to the numpy implementation
// when the shared library is unavailable.
//
// Build: g++ -O3 -march=native -shared -fPIC treebuild.cpp -o _treebuild.so
//
// ABI: plain C functions over int64 arrays (ctypes-friendly).

#include <cstdint>
#include <cstring>
#include <vector>
#include <unordered_map>

namespace {

struct CellTable {
    int64_t ncells;
    int dim;
    int depth;
    const int64_t* anchors;   // (ncells, dim)
    const int64_t* levels;    // (ncells,)
    const int64_t* parent;    // (ncells,)
    const int64_t* children;  // (ncells, 2^dim)
    const uint8_t* is_leaf;   // (ncells,)
    const uint8_t* has_points;// (ncells,)
    std::unordered_map<uint64_t, int64_t> lookup;  // packed key -> cell idx
};

inline uint64_t pack(int level, const int64_t* a, int dim) {
    uint64_t key = 0;
    for (int j = dim - 1; j >= 0; --j) {
        key = (key << 16) | static_cast<uint64_t>(a[j] & 0xFFFF);
    }
    return (key << 5) | static_cast<uint64_t>(level);
}

struct Result {
    std::vector<int64_t> v_pairs;  // (t, s, vid) triples
    std::vector<int64_t> u_pairs;  // (t, s)
    std::vector<int64_t> w_pairs;  // (t, s)
};

int64_t find(const CellTable& t, int level, const int64_t* anchor) {
    auto it = t.lookup.find(pack(level, anchor, t.dim));
    return it == t.lookup.end() ? -1 : it->second;
}

// neighbour offsets in {-1,0,1}^dim \ {0}
void neighbour_offsets(int dim, std::vector<std::vector<int64_t>>& out) {
    int total = 1;
    for (int i = 0; i < dim; ++i) total *= 3;
    for (int i = 0; i < total; ++i) {
        std::vector<int64_t> off(dim);
        int v = i;
        bool zero = true;
        for (int j = dim - 1; j >= 0; --j) {
            off[j] = (v % 3) - 1;
            v /= 3;
            if (off[j] != 0) zero = false;
        }
        if (!zero) out.push_back(off);
    }
}

void build_lists(const CellTable& t, Result& r) {
    const int dim = t.dim;
    const int nch = 1 << dim;
    std::vector<std::vector<int64_t>> offs;
    neighbour_offsets(dim, offs);
    std::vector<int64_t> cand(dim);

    // ---- v list: children of parent's colleagues, same level, |d|inf >= 2
    for (int64_t c = 0; c < t.ncells; ++c) {
        const int lvl = static_cast<int>(t.levels[c]);
        if (lvl < 2) continue;
        const int64_t par = t.parent[c];
        const int64_t* ca = t.anchors + c * dim;
        const int64_t* pa = t.anchors + par * dim;
        const int64_t max_box_parent = 1LL << (lvl - 1);
        for (const auto& off : offs) {
            bool valid = true;
            for (int j = 0; j < dim; ++j) {
                cand[j] = pa[j] + off[j];
                if (cand[j] < 0 || cand[j] >= max_box_parent) { valid = false; break; }
            }
            if (!valid) continue;
            const int64_t pc = find(t, lvl - 1, cand.data());
            if (pc < 0) continue;
            const int64_t* ch = t.children + pc * nch;
            for (int k = 0; k < nch; ++k) {
                const int64_t s = ch[k];
                if (s < 0 || !t.has_points[s]) continue;
                const int64_t* sa = t.anchors + s * dim;
                int64_t vid = 0;
                int64_t dinf = 0;
                for (int j = 0; j < dim; ++j) {
                    const int64_t d = ca[j] - sa[j];
                    const int64_t ad = d < 0 ? -d : d;
                    if (ad > dinf) dinf = ad;
                    vid = vid * 7 + (d + 3);
                }
                if (dinf >= 2) {
                    r.v_pairs.push_back(c);
                    r.v_pairs.push_back(s);
                    r.v_pairs.push_back(vid);
                }
            }
        }
    }

    // ---- u/w lists per leaf ------------------------------------------------
    std::vector<int64_t> stack_t;  // frontier (cell idx)
    for (int64_t b = 0; b < t.ncells; ++b) {
        if (!t.is_leaf[b]) continue;
        r.u_pairs.push_back(b);
        r.u_pairs.push_back(b);  // self

        const int lvl = static_cast<int>(t.levels[b]);
        const int64_t* ba = t.anchors + b * dim;
        const int64_t max_box = 1LL << lvl;

        for (const auto& off : offs) {
            bool valid = true;
            for (int j = 0; j < dim; ++j) {
                cand[j] = ba[j] + off[j];
                if (cand[j] < 0 || cand[j] >= max_box) { valid = false; break; }
            }
            if (!valid) continue;

            // walk up: deepest existing cell containing this neighbour anchor
            int64_t res = -1;
            for (int l = lvl; l >= 0; --l) {
                std::vector<int64_t> shifted(dim);
                for (int j = 0; j < dim; ++j) shifted[j] = cand[j] >> (lvl - l);
                res = find(t, l, shifted.data());
                if (res >= 0) break;
            }
            if (res < 0) continue;

            if (t.is_leaf[res]) {
                r.u_pairs.push_back(b);
                r.u_pairs.push_back(res);
                continue;
            }
            if (t.levels[res] != lvl) continue;  // coarser internal: no leaf on path

            // descend: adjacent children recurse (leaves -> u), non-adjacent -> w
            stack_t.clear();
            stack_t.push_back(res);
            while (!stack_t.empty()) {
                const int64_t cell = stack_t.back();
                stack_t.pop_back();
                const int64_t* ch = t.children + cell * nch;
                for (int k = 0; k < nch; ++k) {
                    const int64_t s = ch[k];
                    if (s < 0) continue;
                    const int slvl = static_cast<int>(t.levels[s]);
                    const int dl = slvl - lvl;
                    const int64_t* sa = t.anchors + s * dim;
                    bool adjacent = true;
                    for (int j = 0; j < dim; ++j) {
                        const int64_t lo = (ba[j] << dl) - 1;
                        const int64_t hi = ((ba[j] + 1) << dl);  // inclusive hi+1-1
                        if (sa[j] < lo || sa[j] > hi) { adjacent = false; break; }
                    }
                    if (!adjacent) {
                        r.w_pairs.push_back(b);
                        r.w_pairs.push_back(s);
                    } else if (t.is_leaf[s]) {
                        r.u_pairs.push_back(b);
                        r.u_pairs.push_back(s);
                    } else {
                        stack_t.push_back(s);
                    }
                }
            }
        }
    }
}

}  // namespace

extern "C" {

struct Handle {
    Result result;
};

void* ferreus_build_lists(
    int64_t ncells, int dim, int depth,
    const int64_t* anchors, const int64_t* levels, const int64_t* parent,
    const int64_t* children, const uint8_t* is_leaf, const uint8_t* has_points
) {
    CellTable t;
    t.ncells = ncells;
    t.dim = dim;
    t.depth = depth;
    t.anchors = anchors;
    t.levels = levels;
    t.parent = parent;
    t.children = children;
    t.is_leaf = is_leaf;
    t.has_points = has_points;
    t.lookup.reserve(static_cast<size_t>(ncells) * 2);
    for (int64_t c = 0; c < ncells; ++c) {
        t.lookup.emplace(pack(static_cast<int>(levels[c]), anchors + c * dim, dim), c);
    }
    auto* h = new Handle();
    build_lists(t, h->result);
    return h;
}

int64_t ferreus_num_v(void* handle) { return static_cast<Handle*>(handle)->result.v_pairs.size() / 3; }
int64_t ferreus_num_u(void* handle) { return static_cast<Handle*>(handle)->result.u_pairs.size() / 2; }
int64_t ferreus_num_w(void* handle) { return static_cast<Handle*>(handle)->result.w_pairs.size() / 2; }

void ferreus_copy_lists(void* handle, int64_t* v_out, int64_t* u_out, int64_t* w_out) {
    auto* h = static_cast<Handle*>(handle);
    std::memcpy(v_out, h->result.v_pairs.data(), h->result.v_pairs.size() * sizeof(int64_t));
    std::memcpy(u_out, h->result.u_pairs.data(), h->result.u_pairs.size() * sizeof(int64_t));
    std::memcpy(w_out, h->result.w_pairs.data(), h->result.w_pairs.size() * sizeof(int64_t));
}

void ferreus_free(void* handle) { delete static_cast<Handle*>(handle); }

}  // extern "C"
