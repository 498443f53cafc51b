// CTC prefix beam-search decoder (native replacement for the reference's
// third-party `ctcdecode` C++ dependency, recognition_model.py:6,34-35).
//
// Standard prefix beam search over (T, K) log-probs: blank/non-blank
// probability split per prefix, log-sum-exp path merging, per-frame symbol
// pruning, optional word-insertion bonus at space boundaries (the no-LM
// path; arpa_lm.cc fuses a word LM).
//
// C ABI: ssp_ctc_beam_decode(log_probs(T*K f64), T, K, blank, beam_width,
//                            prune_logp, beta, space_id,
//                            out_ids, out_cap) -> decoded length

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>

#include "beam_common.h"

namespace {

using ssp::FlatMap;
using ssp::LogSumExp2;
using ssp::PrefixTrie;
using ssp::SlotTable;
using ssp::kNegInf;

struct Beam {
  double p_blank = kNegInf;
  double p_nonblank = kNegInf;
  double Total() const { return LogSumExp2(p_blank, p_nonblank); }
};

}  // namespace

extern "C" {

int32_t ssp_ctc_beam_decode(const double* log_probs, int32_t T, int32_t K,
                            int32_t blank, int32_t beam_width,
                            double prune_logp, double beta,
                            int32_t space_id, int32_t* out_ids,
                            int32_t out_cap) {
  PrefixTrie trie(K);
  struct Entry { int32_t node; Beam beam; };
  std::vector<Entry> beams{{0, Beam{0.0, kNegInf}}};
  std::vector<Entry> next;
  SlotTable slots;

  std::vector<std::pair<double, int32_t>> cand;  // (logp, symbol) desc
  cand.reserve(K);
  std::vector<std::pair<double, int32_t>> scored;

  auto claim = [&](int32_t node) -> Beam& {
    int32_t idx = slots.Get(node);
    if (idx < 0) {
      idx = static_cast<int32_t>(next.size());
      next.push_back({node, Beam{}});
      slots.Put(node, idx);
    }
    return next[idx].beam;
  };

  // extension scores are bounded by p_total + frame[s] + bonus_cap
  const double bonus_cap = beta > 0 ? beta : 0.0;

  for (int32_t t = 0; t < T; t++) {
    const double* frame = log_probs + static_cast<int64_t>(t) * K;
    double fmax = kNegInf;
    for (int32_t s = 0; s < K; s++) fmax = std::max(fmax, frame[s]);
    cand.clear();
    for (int32_t s = 0; s < K; s++) {
      if (frame[s] >= fmax + prune_logp) cand.emplace_back(frame[s], s);
    }
    std::sort(cand.begin(), cand.end(),
              [](const auto& a, const auto& b) { return a.first > b.first; });

    // min-cutoff pruning (see arpa_lm.cc): the worst kept prefix is
    // guaranteed worst.Total() + frame[blank] via its blank extension,
    // so anything bounded below that cannot enter the top beam_width
    double min_cutoff = kNegInf;
    if (beams.size() >= static_cast<size_t>(beam_width)
        && frame[blank] >= fmax + prune_logp) {
      min_cutoff = beams.back().beam.Total() + frame[blank];
    }

    slots.NextEpoch();
    next.clear();
    for (const auto& entry : beams) {
      const int32_t node = entry.node;
      const Beam& beam = entry.beam;
      double p_total = beam.Total();
      if (p_total + fmax + bonus_cap < min_cutoff) break;
      int32_t last = trie.Sym(node);
      for (const auto& [p, s] : cand) {
        if (p_total + p + bonus_cap < min_cutoff) break;
        if (s == blank) {
          Beam& nb = claim(node);
          nb.p_blank = LogSumExp2(nb.p_blank, p_total + p);
          continue;
        }
        if (s == last) {
          // repeat: stay on the prefix only via the non-blank path
          Beam& stay = claim(node);
          stay.p_nonblank = LogSumExp2(stay.p_nonblank,
                                       beam.p_nonblank + p);
          // extend only via the blank path
          Beam& nb = claim(trie.Extend(node, s));
          nb.p_nonblank = LogSumExp2(nb.p_nonblank, beam.p_blank + p);
        } else {
          Beam& nb = claim(trie.Extend(node, s));
          // word-insertion bonus when a space closes a non-empty word
          // (same convention as eval/decode.py's plain beam search)
          double bonus = (s == space_id && last != -1 && last != space_id)
                             ? beta : 0.0;
          nb.p_nonblank = LogSumExp2(nb.p_nonblank, p_total + p + bonus);
        }
      }
    }

    // keep top beam_width prefixes
    scored.clear();
    scored.reserve(next.size());
    for (size_t i = 0; i < next.size(); i++) {
      scored.emplace_back(next[i].beam.Total(), static_cast<int32_t>(i));
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
    double s = entry.beam.Total();
    if (entry.node != 0 && trie.Sym(entry.node) != space_id) {
      s += beta;  // close the trailing word
    }
    if (s > best_score) {
      best_score = s;
      best = entry.node;
    }
  }
  if (best < 0) return 0;
  std::vector<int32_t> ids = trie.Materialize(best);
  int32_t n = std::min<int32_t>(ids.size(), out_cap);
  std::memcpy(out_ids, ids.data(), n * sizeof(int32_t));
  return n;
}

}  // extern "C"
