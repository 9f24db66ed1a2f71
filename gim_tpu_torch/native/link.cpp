// Pixel-hash chain intersection for pseudo-label propagation.
//
// Native core of gim_tpu_torch.data.walk.link, the port's own copy of
// gim_tpu/native/link.cpp (behavioral parity with ref
// datasets/walk/walk.py:29,217-247): hash middle-frame endpoints of two
// consecutive label sets on round(x) + round(y)*w, intersect, emit unique
// (left, right) chains. The Python dict version is O(N) with heavy
// interpreter overhead on millions of points per video; this is the
// host-runtime hot loop of the data factory.
//
// Built by gim_tpu_torch/native/__init__.py at first use:
// g++ -O3 -shared -fPIC -o build/gim_tpu_torch/libgimlink_<hash>.so link.cpp

#include <cstdint>
#include <cmath>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {

// label0: (n0, 4) [x0 y0 xm ym], label1: (n1, 4) [xm ym x1 y1]
// out: preallocated (max_out, 4). Returns number of chained rows, or -1 if
// max_out was too small.
long long gim_link(const float* label0, long long n0,
                   const float* label1, long long n1,
                   long long width, float* out, long long max_out) {
    std::unordered_map<long long, long long> mid0;
    mid0.reserve(static_cast<size_t>(n0) * 2);
    for (long long i = 0; i < n0; ++i) {
        const long long key =
            static_cast<long long>(std::llround(label0[i * 4 + 2])) +
            static_cast<long long>(std::llround(label0[i * 4 + 3])) * width;
        mid0[key] = i;  // last writer wins, same as dict(zip(...))
    }
    std::unordered_map<long long, long long> mid1;
    mid1.reserve(static_cast<size_t>(n1) * 2);
    for (long long j = 0; j < n1; ++j) {
        const long long key =
            static_cast<long long>(std::llround(label1[j * 4 + 0])) +
            static_cast<long long>(std::llround(label1[j * 4 + 1])) * width;
        mid1[key] = j;
    }

    // intersect + dedup (i, j) pairs
    std::unordered_set<long long> seen;
    long long count = 0;
    for (const auto& kv : mid0) {
        auto it = mid1.find(kv.first);
        if (it == mid1.end()) continue;
        const long long i = kv.second, j = it->second;
        const long long pair_key = i * (n1 + 1) + j;
        if (!seen.insert(pair_key).second) continue;
        if (count >= max_out) return -1;
        out[count * 4 + 0] = label0[i * 4 + 0];
        out[count * 4 + 1] = label0[i * 4 + 1];
        out[count * 4 + 2] = label1[j * 4 + 2];
        out[count * 4 + 3] = label1[j * 4 + 3];
        ++count;
    }
    return count;
}

}  // extern "C"
