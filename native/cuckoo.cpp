// Cuckoo slot assignment for the direct probe table (C API via ctypes).
//
// The device probe (hashreadmapper_tpu/index/minhash_index.py) replaces its
// bucketed binary search with a 2-choice cuckoo lookup: each key lives at
// h1(key) or h2(key), so a query costs two key gathers + one payload gather
// instead of log2(bucket) search passes.  This is the static-shape analog of
// the reference's warpcore open-addressing tables
// (reference: include/gpu/gpuhashtable.cuh:726-833) — the reference probes
// with cooperative groups at query time; here the table is built once on
// the host (insertion kicking is inherently sequential) and queried with
// fixed-shape vector gathers.
//
// Hash functions (MUST match minhash_index._cuckoo_slots):
//   h1(k) = uint32((k ^ seed1) * 0x9E3779B1) >> (32 - bits)
//   h2(k) = uint32((k ^ seed2) * 0x85EBCA77) >> (32 - bits)

#include <cstdint>
#include <vector>

namespace {

static inline uint32_t h1(uint32_t k, uint32_t seed, int bits) {
    return (uint32_t)((k ^ seed) * 0x9E3779B1u) >> (32 - bits);
}
static inline uint32_t h2(uint32_t k, uint32_t seed, int bits) {
    return (uint32_t)((k ^ seed) * 0x85EBCA77u) >> (32 - bits);
}

}  // namespace

extern "C" {

// Assign each of the n distinct keys a slot in a 2^bits table such that
// slot(key) is h1(key) or h2(key).  slot_out[i] receives key i's slot.
// Returns 0 on success, 1 if insertion cycles exceeded the kick limit
// (caller retries with different seeds or more bits).
int hrm_cuckoo_build(const uint32_t* keys, long long n, int bits,
                     uint32_t seed1, uint32_t seed2, int32_t* slot_out) {
    const long long slots = 1LL << bits;
    if (n > slots) return 1;
    std::vector<int64_t> occupant(slots, -1);   // key index per slot
    const int max_kicks = 64 + 8 * bits;
    for (long long i = 0; i < n; i++) {
        int64_t cur = i;
        uint32_t pos = h1(keys[cur], seed1, bits);
        for (int kick = 0; kick < max_kicks; kick++) {
            int64_t prev = occupant[pos];
            occupant[pos] = cur;
            if (prev < 0) { cur = -1; break; }
            cur = prev;
            // evictee moves to its alternate position
            uint32_t p1 = h1(keys[cur], seed1, bits);
            pos = (pos == p1) ? h2(keys[cur], seed2, bits) : p1;
        }
        if (cur >= 0) return 1;   // cycle: rebuild with new seeds/bits
    }
    for (long long s = 0; s < slots; s++)
        if (occupant[s] >= 0) slot_out[occupant[s]] = (int32_t)s;
    return 0;
}

}  // extern "C"
