// Word-LM interface shared by the LM-fused CTC beam decoder
// (arpa_lm.cc) and its two model backends: the ARPA text reader
// (arpa_lm.cc) and the KenLM probing-binary reader (probing_lm.cc).
//
// All ssp_lm_* C-ABI handles point at a WordLM; scores are natural-log
// P(word | context) with Katz back-off, matching the Python
// eval.decode.ArpaLM / eval.kenlm_binary.KenLMBinary semantics.

#ifndef SSP_LM_IFACE_H_
#define SSP_LM_IFACE_H_

#include <string>
#include <vector>

namespace ssp {

struct WordLM {
  virtual ~WordLM() = default;
  virtual double ScoreWord(std::vector<std::string> context,
                           const std::string& word) const = 0;
  virtual int Order() const = 0;
};

}  // namespace ssp

#endif  // SSP_LM_IFACE_H_
