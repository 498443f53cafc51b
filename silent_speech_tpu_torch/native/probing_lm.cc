// KenLM probing-binary language model backend for the native LM-fused
// CTC beam decoder — the reference's canonical eval configuration
// (recognition_model.py:34-35 decodes with `lm.binary`).
//
// The validated layout solve (section offsets/bucket counts against the
// exact file size) lives in Python (eval/kenlm_binary.py); this backend
// receives the resolved offsets and mmaps the same file read-only, so
// there is exactly one parser of the format and the native side adds no
// second interpretation of KenLM's historical layout quirks. Lookup is
// KenLM's own scheme: MurmurHash64A(word, seed=0) into a linear-probing
// vocab table (0 = empty), n-gram keys chained newest-word-first through
// CombineWordHash, probing tables per order, Katz back-off accumulated in
// log10 and converted to natural log at the end — bit-for-bit the
// arithmetic of eval/kenlm_binary.py::KenLMBinary.score_word.
//
// C ABI:
//   ssp_lm_load_probing(path, order, uni_entries,
//                       vocab_off, vocab_buckets, uni_off,
//                       mid_offs[order-2], mid_buckets[order-2],
//                       longest_off, longest_buckets) -> handle (0 fail)
//   (freed/scored/decoded through the shared ssp_lm_* entry points)

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "lm_iface.h"

namespace {

constexpr double kLog10 = 2.302585092994046;

// util/murmur_hash.cc MurmurHash64A (64-bit hosts), seed 0 for vocab.
uint64_t MurmurHash64A(const void* data, size_t len, uint64_t seed = 0) {
  const uint64_t m = 0xc6a4a7935bd1e995ull;
  const int r = 47;
  uint64_t h = seed ^ (len * m);
  const uint8_t* p = static_cast<const uint8_t*>(data);
  const uint8_t* end = p + (len / 8) * 8;
  while (p != end) {
    uint64_t k;
    std::memcpy(&k, p, 8);
    p += 8;
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
  }
  size_t tail = len & 7;
  if (tail) {
    uint64_t k = 0;
    std::memcpy(&k, p, tail);  // little-endian host
    h ^= k;
    h *= m;
  }
  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

// lm/search_hashed.hh detail::CombineWordHash
inline uint64_t CombineWordHash(uint64_t current, uint32_t word_id) {
  return (current * 8978948897894561157ull) ^
         ((1ull + word_id) * 17894857484156487943ull);
}

// Read-only view of a KenLM linear-probing table with `stride`-byte
// entries whose first 8 bytes are the u64 key (0 = empty).
struct ProbingView {
  const uint8_t* base = nullptr;
  uint64_t buckets = 0;
  uint32_t stride = 0;

  // byte pointer to the matching entry, or nullptr
  const uint8_t* Find(uint64_t key) const {
    if (buckets == 0) return nullptr;
    uint64_t i = key % buckets;
    for (uint64_t n = 0; n < buckets; n++) {
      const uint8_t* e = base + i * stride;
      uint64_t k;
      std::memcpy(&k, e, 8);
      if (k == key) return e;
      if (k == 0) return nullptr;
      if (++i == buckets) i = 0;
    }
    return nullptr;
  }
};

inline float ReadF32(const uint8_t* p) {
  float f;
  std::memcpy(&f, p, 4);
  return f;
}

struct ProbingLM : public ssp::WordLM {
  const uint8_t* map = nullptr;
  size_t map_len = 0;
  int fd = -1;

  int order = 0;
  ProbingView vocab;                 // {u64 hash, u32 id} stride 12
  const uint8_t* unigram = nullptr;  // {f32 prob, f32 bo} by word id
  uint64_t uni_entries = 0;
  std::vector<ProbingView> middle;   // {u64, f32 prob, f32 bo} stride 16
  ProbingView longest;               // {u64, f32 prob} stride 12

  ~ProbingLM() override {
    if (map) munmap(const_cast<uint8_t*>(map), map_len);
    if (fd >= 0) close(fd);
  }

  bool Load(const char* path, int32_t order_, int64_t uni_entries_,
            int64_t vocab_off, int64_t vocab_buckets, int64_t uni_off,
            const int64_t* mid_offs, const int64_t* mid_buckets,
            int64_t longest_off, int64_t longest_buckets) {
    fd = open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    map_len = static_cast<size_t>(st.st_size);
    void* m = mmap(nullptr, map_len, PROT_READ, MAP_SHARED, fd, 0);
    if (m == MAP_FAILED) return false;
    map = static_cast<const uint8_t*>(m);

    order = order_;
    uni_entries = static_cast<uint64_t>(uni_entries_);
    // bounds checks: every section must lie inside the mapping
    auto ok = [&](int64_t off, int64_t n, uint32_t stride) {
      return off >= 0 && n >= 0 &&
             static_cast<uint64_t>(off) + static_cast<uint64_t>(n) * stride
                 <= map_len;
    };
    if (!ok(vocab_off, vocab_buckets, 12) || !ok(uni_off, uni_entries_, 8))
      return false;
    vocab = {map + vocab_off, static_cast<uint64_t>(vocab_buckets), 12};
    unigram = map + uni_off;
    for (int n = 2; n < order; n++) {
      int64_t off = mid_offs[n - 2], b = mid_buckets[n - 2];
      if (!ok(off, b, 16)) return false;
      middle.push_back({map + off, static_cast<uint64_t>(b), 16});
    }
    if (order >= 2) {
      if (!ok(longest_off, longest_buckets, 12)) return false;
      longest = {map + longest_off,
                 static_cast<uint64_t>(longest_buckets), 12};
    }
    return true;
  }

  int Order() const override { return order; }

  uint32_t WordId(const std::string& w) const {
    const uint8_t* e =
        vocab.Find(MurmurHash64A(w.data(), w.size()));
    if (e == nullptr) return 0;  // <unk>
    uint32_t id;
    std::memcpy(&id, e + 8, 4);
    return id;
  }

  // (log10 prob, log10 backoff); hit=false on probing-table miss
  bool Lookup(const uint32_t* ids, int n, float* prob,
              float* backoff) const {
    if (n == 1) {
      uint64_t id = ids[0];
      if (id >= uni_entries) return false;
      const uint8_t* row = unigram + id * 8;
      *prob = ReadF32(row);
      *backoff = ReadF32(row + 4);
      return true;
    }
    uint64_t h = ids[n - 1];
    for (int i = n - 2; i >= 0; i--) h = CombineWordHash(h, ids[i]);
    if (n == order) {
      const uint8_t* e = longest.Find(h);
      if (e == nullptr) return false;
      *prob = ReadF32(e + 8);
      *backoff = 0.0f;
      return true;
    }
    const uint8_t* e = middle[n - 2].Find(h);
    if (e == nullptr) return false;
    *prob = ReadF32(e + 8);
    *backoff = ReadF32(e + 12);
    return true;
  }

  double ScoreWord(std::vector<std::string> context,
                   const std::string& word) const override {
    std::vector<uint32_t> ctx;
    if (order > 1) {
      size_t lo = context.size() > static_cast<size_t>(order - 1)
                      ? context.size() - (order - 1)
                      : 0;
      for (size_t i = lo; i < context.size(); i++)
        ctx.push_back(WordId(context[i]));
    }
    uint32_t wid = WordId(word);
    double backoff_acc = 0.0;  // log10, matching KenLMBinary.score_word
    std::vector<uint32_t> ids;
    while (true) {
      ids.assign(ctx.begin(), ctx.end());
      ids.push_back(wid);
      float prob, bo;
      if (Lookup(ids.data(), static_cast<int>(ids.size()), &prob, &bo))
        return (backoff_acc + prob) * kLog10;
      if (ctx.empty()) {
        // unreachable in well-formed models: unigram lookups always hit.
        // Clamp to the <unk> row (id 0) rather than reading past the
        // unigram section of the mapping on a corrupt/mismatched binary.
        uint64_t safe = wid < uni_entries ? wid : 0;
        const uint8_t* row = unigram + safe * 8;
        return (backoff_acc + ReadF32(row)) * kLog10;
      }
      if (Lookup(ctx.data(), static_cast<int>(ctx.size()), &prob, &bo))
        backoff_acc += bo;
      ctx.erase(ctx.begin());
    }
  }
};

}  // namespace

extern "C" {

int64_t ssp_lm_load_probing(const char* path, int32_t order,
                            int64_t uni_entries, int64_t vocab_off,
                            int64_t vocab_buckets, int64_t uni_off,
                            const int64_t* mid_offs,
                            const int64_t* mid_buckets,
                            int64_t longest_off,
                            int64_t longest_buckets) {
  if (order < 1 || order > 10) return 0;
  auto lm = std::make_unique<ProbingLM>();
  if (!lm->Load(path, order, uni_entries, vocab_off, vocab_buckets,
                uni_off, mid_offs, mid_buckets, longest_off,
                longest_buckets))
    return 0;
  return reinterpret_cast<int64_t>(
      static_cast<ssp::WordLM*>(lm.release()));
}

}  // extern "C"
