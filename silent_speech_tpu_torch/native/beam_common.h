// Shared machinery for the CTC prefix beam-search decoders
// (ctc_beam.cc: no-LM fast path; arpa_lm.cc: ARPA-LM-fused path).
//
// Prefix interning: beams are keyed by int trie-node ids, so extending a
// prefix is an O(1) child lookup instead of an O(len) vector copy + hash
// (which made the first decoder version O(T^2 * beam * K) — ~1.5 s/utt
// at the reference's validation sizes).

#ifndef SSP_BEAM_COMMON_H_
#define SSP_BEAM_COMMON_H_

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace ssp {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline double LogSumExp2(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = a > b ? a : b;
  double d = (a > b ? b : a) - m;
  return m + std::log1p(std::exp(d));  // one exp, log1p: ~2x cheaper
}

// Insert-only open-addressing map (uint64 key -> int32), ~4x faster than
// std::unordered_map in this access pattern (linear probe, pow2 size).
struct FlatMap {
  std::vector<uint64_t> keys;  // 0 = empty (stored keys are key+1)
  std::vector<int32_t> vals;
  size_t mask = 0, count = 0;
  FlatMap() { Rehash(1 << 13); }
  void Rehash(size_t cap) {
    std::vector<uint64_t> ok = std::move(keys);
    std::vector<int32_t> ov = std::move(vals);
    keys.assign(cap, 0);
    vals.assign(cap, -1);
    mask = cap - 1;
    count = 0;
    for (size_t i = 0; i < ok.size(); i++) {
      if (ok[i]) InsertRaw(ok[i], ov[i]);
    }
  }
  void InsertRaw(uint64_t k1, int32_t v) {
    size_t h = (k1 * 0x9e3779b97f4a7c15ull) & mask;
    while (keys[h]) h = (h + 1) & mask;
    keys[h] = k1;
    vals[h] = v;
    count++;
  }
  // returns the value slot, fresh slots hold -1; claims on first touch
  int32_t* Probe(uint64_t key) {
    if (count * 10 >= (mask + 1) * 7) Rehash((mask + 1) * 2);
    uint64_t k1 = key + 1;
    size_t h = (k1 * 0x9e3779b97f4a7c15ull) & mask;
    while (keys[h] && keys[h] != k1) h = (h + 1) & mask;
    if (!keys[h]) {
      keys[h] = k1;
      count++;
      vals[h] = -1;
    }
    return &vals[h];
  }
};

struct PrefixTrie {
  struct Node { int32_t parent; int32_t sym; };
  std::vector<Node> nodes{{-1, -1}};  // node 0 = empty prefix
  FlatMap child;
  int32_t K;
  explicit PrefixTrie(int32_t k) : K(k) {}
  int32_t Extend(int32_t node, int32_t sym) {
    uint64_t key = static_cast<uint64_t>(node) * K + sym;
    int32_t* v = child.Probe(key);
    if (*v >= 0) return *v;
    int32_t id = static_cast<int32_t>(nodes.size());
    nodes.push_back({node, sym});
    *v = id;
    return id;
  }
  int32_t Sym(int32_t n) const { return nodes[n].sym; }  // root -> -1
  std::vector<int32_t> Materialize(int32_t n) const {
    std::vector<int32_t> out;
    while (n > 0) {
      out.push_back(nodes[n].sym);
      n = nodes[n].parent;
    }
    std::reverse(out.begin(), out.end());
    return out;
  }
};

// Per-step scatter table: next-beam index per trie node, valid only when
// stamped with the current step's epoch — O(1) access, no hashing, no
// per-step clearing.
struct SlotTable {
  std::vector<uint32_t> epoch_;
  std::vector<int32_t> idx_;
  uint32_t epoch = 0;
  void NextEpoch() { epoch++; }
  int32_t Get(size_t node) {
    if (node >= epoch_.size()) {
      epoch_.resize(node + 1024, 0);
      idx_.resize(node + 1024, -1);
    }
    return epoch_[node] == epoch ? idx_[node] : -1;
  }
  void Put(size_t node, int32_t idx) {
    epoch_[node] = epoch;  // Get() above already sized the arrays
    idx_[node] = idx;
  }
};

}  // namespace ssp

#endif  // SSP_BEAM_COMMON_H_
