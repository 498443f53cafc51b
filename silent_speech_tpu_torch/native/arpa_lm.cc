// ARPA word n-gram language model with Katz back-off, plus the LM-fused
// CTC prefix beam search (native replacement for the reference's
// ctcdecode + KenLM stack, recognition_model.py:6,34-35: alpha/beta
// word-insertion fusion at word boundaries).
//
// C ABI:
//   ssp_lm_load(path) -> handle (0 on failure)
//   ssp_lm_free(handle)
//   ssp_lm_score_word(handle, context_utf8, word_utf8) -> natural-log prob
//   ssp_ctc_beam_decode_lm(handle, log_probs, T, K, blank, beam_width,
//                          prune_logp, alpha, beta, charset_utf8,
//                          out_ids, out_cap) -> decoded length

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <memory>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

#include "beam_common.h"
#include "lm_iface.h"

namespace {

using ssp::FlatMap;
using ssp::LogSumExp2;
using ssp::kNegInf;

constexpr double kLog10 = 2.302585092994046;

struct ArpaLM : public ssp::WordLM {
  // per order: "w1 w2 ... wn" -> (logp_e, backoff_e)  (natural log)
  std::vector<std::unordered_map<std::string, std::pair<float, float>>>
      ngrams;
  int order = 0;
  double unk_floor = -10.0 * kLog10;

  bool Load(const std::string& path) {
    std::ifstream f(path);
    if (!f.is_open()) return false;
    std::string line;
    int section = 0;
    while (std::getline(f, line)) {
      // trim
      while (!line.empty() && (line.back() == '\r' || line.back() == '\n'
                               || line.back() == ' '))
        line.pop_back();
      if (line.empty()) continue;
      if (line[0] == '\\') {
        if (line == "\\end\\") break;
        size_t dash = line.find("-grams:");
        if (dash != std::string::npos) {
          section = std::stoi(line.substr(1, dash - 1));
          order = std::max(order, section);
          if ((int)ngrams.size() < section + 1) ngrams.resize(section + 1);
        }
        continue;
      }
      if (section == 0) continue;
      std::istringstream ss(line);
      double logp;
      if (!(ss >> logp)) continue;
      std::string words, w;
      for (int i = 0; i < section; i++) {
        if (!(ss >> w)) { words.clear(); break; }
        if (i) words += ' ';
        words += w;
      }
      if (words.empty()) continue;
      double backoff = 0.0;
      ss >> backoff;  // optional
      ngrams[section][words] = {float(logp * kLog10),
                                float(backoff * kLog10)};
    }
    return order > 0;
  }

  static std::string Join(const std::vector<std::string>& ws, size_t lo) {
    std::string out;
    for (size_t i = lo; i < ws.size(); i++) {
      if (i > lo) out += ' ';
      out += ws[i];
    }
    return out;
  }

  int Order() const override { return order; }

  double ScoreWord(std::vector<std::string> context,
                   const std::string& word) const override {
    // truncate to the model order's context window
    if (order > 1 && (int)context.size() > order - 1) {
      context.erase(context.begin(), context.end() - (order - 1));
    } else if (order <= 1) {
      context.clear();
    }
    // Katz back-off: direct hit, else backoff(context) + shorter context
    double backoff_acc = 0.0;
    while (true) {
      std::string key = Join(context, 0);
      if (!key.empty()) key += ' ';
      key += word;
      int n = (int)context.size() + 1;
      if (n < (int)ngrams.size()) {
        auto it = ngrams[n].find(key);
        if (it != ngrams[n].end()) return backoff_acc + it->second.first;
      }
      if (context.empty()) {
        if (1 < (int)ngrams.size()) {
          auto unk = ngrams[1].find("<unk>");
          if (unk != ngrams[1].end()) return backoff_acc
              + unk->second.first;
        }
        return backoff_acc + unk_floor;
      }
      int cn = (int)context.size();
      if (cn < (int)ngrams.size()) {
        auto it = ngrams[cn].find(Join(context, 0));
        if (it != ngrams[cn].end()) backoff_acc += it->second.second;
      }
      context.erase(context.begin());
    }
  }
};

// Word-context ring: ScoreWord truncates to (order-1) context words, so
// keeping only the last kMaxCtx completed words (interned ids) is exact
// for any LM of order <= kMaxCtx+1; total_words tells us whether "<s>"
// is still inside the window.
constexpr int kMaxCtx = 9;

struct LMBeam {
  double p_blank = kNegInf;
  double p_nonblank = kNegInf;
  uint32_t ctx[kMaxCtx];  // last completed word ids, oldest first
  int32_t n_ctx = 0;      // valid entries in ctx
  int32_t total_words = 0;
  int32_t ctx_id = 0;     // interned (ring, <s>-in-window) id — the LM
                          // state key for the word-bonus cache
  // the word in progress is NOT stored: it is derivable from the prefix
  // trie (chars since the last space), so beams stay POD — no string
  // allocation on the ~beam*K extension path
  double Total() const { return LogSumExp2(p_blank, p_nonblank); }
  void CopyCtx(const LMBeam& src) {
    std::memcpy(ctx, src.ctx, sizeof(ctx));
    n_ctx = src.n_ctx;
    total_words = src.total_words;
    ctx_id = src.ctx_id;
  }
  void PushWord(uint32_t id) {
    if (n_ctx == kMaxCtx) {
      std::memmove(ctx, ctx + 1, (kMaxCtx - 1) * sizeof(uint32_t));
      ctx[kMaxCtx - 1] = id;
    } else {
      ctx[n_ctx++] = id;
    }
    total_words++;
  }
};

using PrefixTrieLM = ssp::PrefixTrie;
using SlotTableLM = ssp::SlotTable;

}  // namespace

extern "C" {

int64_t ssp_lm_load(const char* path) {
  auto lm = std::make_unique<ArpaLM>();
  if (!lm->Load(path)) return 0;
  return reinterpret_cast<int64_t>(
      static_cast<ssp::WordLM*>(lm.release()));
}

void ssp_lm_free(int64_t handle) {
  delete reinterpret_cast<ssp::WordLM*>(handle);
}

double ssp_lm_score_word(int64_t handle, const char* context,
                         const char* word) {
  const ssp::WordLM* lm = reinterpret_cast<const ssp::WordLM*>(handle);
  std::vector<std::string> ctx;
  std::istringstream ss(context);
  std::string w;
  while (ss >> w) ctx.push_back(w);
  return lm->ScoreWord(ctx, word);
}

int32_t ssp_ctc_beam_decode_lm(int64_t handle, const double* log_probs,
                               int32_t T, int32_t K, int32_t blank,
                               int32_t beam_width, double prune_logp,
                               double alpha, double beta,
                               const char* charset, int32_t* out_ids,
                               int32_t out_cap) {
  const ssp::WordLM* lm = reinterpret_cast<const ssp::WordLM*>(handle);
  // the context ring keeps kMaxCtx completed words — exact only for
  // LM order <= kMaxCtx+1; refuse higher orders (caller falls back to
  // the full-history Python decoder)
  if (lm != nullptr && lm->Order() > kMaxCtx + 1) return -1;
  const std::string chars(charset);
  int32_t space_id = -1;
  for (size_t i = 0; i < chars.size(); i++) {
    if (chars[i] == ' ') space_id = (int32_t)i;
  }

  PrefixTrieLM trie(K);

  // the word in progress at a node: chars back to the last space
  auto cur_word = [&](int32_t node) -> std::string {
    std::string w;
    while (node > 0 && trie.Sym(node) != space_id) {
      w += chars[trie.Sym(node)];
      node = trie.nodes[node].parent;
    }
    std::reverse(w.begin(), w.end());
    return w;
  };

  // completed-word interning (ids in LMBeam's context ring)
  std::vector<std::string> word_tab;
  std::unordered_map<std::string, uint32_t> word_ids;
  auto intern = [&](const std::string& w) -> uint32_t {
    auto it = word_ids.find(w);
    if (it != word_ids.end()) return it->second;
    uint32_t id = (uint32_t)word_tab.size();
    word_tab.push_back(w);
    word_ids.emplace(w, id);
    return id;
  };

  // node → interned word-id of the word in progress (-2 = empty);
  // trie nodes are immutable prefixes, so this memo is exact and turns
  // the per-call string walk into an O(1) lookup after first touch
  std::vector<int32_t> node_wid;
  auto word_id_at = [&](int32_t node) -> int32_t {
    if ((size_t)node < node_wid.size() && node_wid[node] != -1)
      return node_wid[node];
    std::string w = cur_word(node);
    int32_t id = w.empty() ? -2 : (int32_t)intern(w);
    if ((size_t)node >= node_wid.size()) node_wid.resize(node + 1024, -1);
    node_wid[node] = id;
    return id;
  };

  // LM-state interning: a beam's LM state is its context ring plus
  // whether "<s>" is still inside the window. Interning it to an id
  // keys the word-bonus cache, so each distinct (LM state, word) pair
  // hits ScoreWord at most ONCE per utterance — the LM-fused decode
  // used to re-score identical contexts every frame (the dominant cost
  // at beam=100: ~3 s/utt with the probing binary, bench_decode.log r4).
  // id 0 = the initial state (empty ring, "<s>" in window): key "\x01"
  std::unordered_map<std::string, int32_t> ctx_ids{
      {std::string(1, '\x01'), 0}};
  auto intern_ctx = [&](const LMBeam& b) -> int32_t {
    std::string key((const char*)b.ctx, b.n_ctx * sizeof(uint32_t));
    key.push_back(b.total_words == b.n_ctx ? 1 : 0);
    auto it = ctx_ids.find(key);
    if (it != ctx_ids.end()) return it->second;
    int32_t id = (int32_t)ctx_ids.size();
    ctx_ids.emplace(std::move(key), id);
    return id;
  };

  std::unordered_map<uint64_t, double> bonus_cache;
  auto word_bonus = [&](const LMBeam& beam, int32_t node) -> double {
    int32_t wid = word_id_at(node);
    if (wid == -2) return 0.0;
    if (lm == nullptr) return beta;
    uint64_t key = ((uint64_t)(uint32_t)beam.ctx_id << 32) | (uint32_t)wid;
    auto it = bonus_cache.find(key);
    if (it != bonus_cache.end()) return it->second;
    std::vector<std::string> ctx;
    if (beam.total_words == beam.n_ctx) ctx.push_back("<s>");
    for (int32_t i = 0; i < beam.n_ctx; i++)
      ctx.push_back(word_tab[beam.ctx[i]]);
    double v = alpha * lm->ScoreWord(ctx, word_tab[wid]) + beta;
    bonus_cache.emplace(key, v);
    return v;
  };

  struct Entry { int32_t node; LMBeam beam; };
  std::vector<Entry> beams(1);
  beams[0].node = 0;
  beams[0].beam.p_blank = 0.0;
  std::vector<Entry> next;
  SlotTableLM slots;
  std::vector<std::pair<double, int32_t>> scored;

  // claim next-beam for `node`, seeding LM context from `src` on first
  // touch (merging beams share the prefix, hence identical context)
  auto claim = [&](int32_t node, const LMBeam& src) -> LMBeam& {
    int32_t idx = slots.Get(node);
    if (idx < 0) {
      idx = (int32_t)next.size();
      next.push_back({node, LMBeam{}});
      next[idx].beam.CopyCtx(src);
      slots.Put(node, idx);
    }
    return next[idx].beam;
  };

  // an extension's score is bounded by p_total + frame[s] + bonus_cap
  // (LM log-probs are <= 0, so only the flat +beta can raise a score)
  const double bonus_cap = beta > 0 ? beta : 0.0;

  std::vector<std::pair<double, int32_t>> cand;  // (logp, symbol) desc
  for (int32_t t = 0; t < T; t++) {
    const double* frame = log_probs + (int64_t)t * K;
    double fmax = kNegInf;
    for (int32_t s = 0; s < K; s++) fmax = std::max(fmax, frame[s]);
    cand.clear();
    for (int32_t s = 0; s < K; s++) {
      if (frame[s] >= fmax + prune_logp) cand.emplace_back(frame[s], s);
    }
    std::sort(cand.begin(), cand.end(),
              [](const auto& a, const auto& b) { return a.first > b.first; });

    // min-cutoff (the pruning rule the reference's own ctcdecode ships):
    // once the beam is full, the worst kept prefix is guaranteed a next
    // score of at least worst.Total() + frame[blank] via its blank
    // extension, so extensions bounded below that cannot enter the top
    // beam_width — skip them. beams are sorted descending, so both
    // loops break early.
    double min_cutoff = kNegInf;
    if (beams.size() >= (size_t)beam_width
        && frame[blank] >= fmax + prune_logp) {
      min_cutoff = beams.back().beam.Total() + frame[blank];
    }

    slots.NextEpoch();
    next.clear();
    for (const auto& entry : beams) {
      const int32_t node = entry.node;
      const LMBeam& beam = entry.beam;
      double p_total = beam.Total();
      if (p_total + fmax + bonus_cap < min_cutoff) break;
      int32_t last = trie.Sym(node);
      for (const auto& [p, s] : cand) {
        if (p_total + p + bonus_cap < min_cutoff) break;
        if (s == blank) {
          LMBeam& nb = claim(node, beam);
          nb.p_blank = LogSumExp2(nb.p_blank, p_total + p);
          continue;
        }
        if (s == last) {
          LMBeam& stay = claim(node, beam);
          stay.p_nonblank = LogSumExp2(stay.p_nonblank,
                                       beam.p_nonblank + p);
          LMBeam& nb = claim(trie.Extend(node, s), beam);
          nb.p_nonblank = LogSumExp2(nb.p_nonblank, beam.p_blank + p);
        } else {
          int32_t ext = trie.Extend(node, s);
          double add = p_total + p;
          if (s == space_id) {
            add += word_bonus(beam, node);
            int32_t idx = slots.Get(ext);
            if (idx < 0) {
              idx = (int32_t)next.size();
              next.push_back({ext, LMBeam{}});
              next[idx].beam.CopyCtx(beam);
              int32_t wid = word_id_at(node);
              if (wid != -2) {
                next[idx].beam.PushWord((uint32_t)wid);
                next[idx].beam.ctx_id = intern_ctx(next[idx].beam);
              }
              slots.Put(ext, idx);
            }
            LMBeam& nb = next[idx].beam;
            nb.p_nonblank = LogSumExp2(nb.p_nonblank, add);
          } else {
            LMBeam& nb = claim(ext, beam);
            nb.p_nonblank = LogSumExp2(nb.p_nonblank, add);
          }
        }
      }
    }

    scored.clear();
    scored.reserve(next.size());
    for (size_t i = 0; i < next.size(); i++) {
      scored.emplace_back(next[i].beam.Total(), (int32_t)i);
    }
    size_t keep = std::min<size_t>(beam_width, scored.size());
    std::partial_sort(scored.begin(), scored.begin() + keep, scored.end(),
                      [](const auto& a, const auto& b) {
                        return a.first > b.first;
                      });
    beams.clear();
    beams.reserve(keep);
    for (size_t i = 0; i < keep; i++) {
      beams.push_back(next[scored[i].second]);
    }
  }

  int32_t best = -1;
  double best_score = kNegInf;
  for (const auto& entry : beams) {
    double sc = entry.beam.Total() + word_bonus(entry.beam, entry.node);
    if (sc > best_score) {
      best_score = sc;
      best = entry.node;
    }
  }
  if (best < 0) return 0;
  std::vector<int32_t> ids = trie.Materialize(best);
  int32_t n = std::min<int32_t>((int32_t)ids.size(), out_cap);
  std::memcpy(out_ids, ids.data(), n * sizeof(int32_t));
  return n;
}

}  // extern "C"
