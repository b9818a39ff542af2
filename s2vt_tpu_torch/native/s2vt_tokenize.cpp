// Native PTB tokenizer for the metric scorer's "native" backend
// (s2vt_tpu_torch/metrics/tokenizer.py): the Penn Treebank tokenization
// rule chain (Robert MacIntyre's tokenizer.sed), in the order
// TreebankWordTokenizer applies it, with brackets converted to
// -LRB-/-RRB-/... as the Stanford PTBTokenizer emits them. The same source
// as native/s2vt_tokenize.cpp of the JAX package; the port keeps its own
// copy. tests/test_torch_metrics.py holds it token for token to the
// tokenizer's Python rule chain.
//
// Input contract: one caption per call, already lowercased by the Python
// wrapper; bytes are UTF-8, and the rules touch only ASCII punctuation, so
// multibyte sequences pass through untouched.
//
// Built by s2vt_tpu_torch/utils/native_build.py (g++ -O3 -shared) into
// build/native/, loaded through ctypes.

#include <cstring>
#include <regex>
#include <string>
#include <vector>

namespace {

struct Rule {
  std::regex re;
  std::string rep;
};

// ECMAScript std::regex notes vs the Python originals:
//  - replacement backrefs are $1/$2, whole match is $&,
//  - (?i) inline flags become std::regex::icase,
//  - (?#X) comments are dropped,
//  - everything else (classes, \b, (?=\s), anchors) maps 1:1.
const std::vector<Rule>& rules_starting_quotes() {
  static const std::vector<Rule> r = {
      {std::regex(R"rgx(^")rgx"), "``"},
      {std::regex(R"rgx((``))rgx"), " $1 "},
      {std::regex(R"rgx(([ \(\[\{<])("|'{2}))rgx"), "$1 `` "},
  };
  return r;
}

const std::vector<Rule>& rules_punctuation() {
  static const std::vector<Rule> r = {
      {std::regex(R"rgx(([:,])([^\d]))rgx"), " $1 $2"},
      {std::regex(R"rgx(([:,])$)rgx"), " $1 "},
      {std::regex(R"rgx(\.\.\.)rgx"), " ... "},
      {std::regex(R"rgx([;@#$%&])rgx"), " $& "},
      // the final-period rule
      {std::regex(R"rgx(([^\.])(\.)([\]\)\}>"']*)\s*$)rgx"), "$1 $2$3 "},
      {std::regex(R"rgx([?!])rgx"), " $& "},
      {std::regex(R"rgx(([^'])' )rgx"), "$1 ' "},
  };
  return r;
}

const Rule& rule_parens_brackets() {
  static const Rule r = {std::regex(R"rgx([\]\[\(\)\{\}<>])rgx"), " $& "};
  return r;
}

const std::vector<Rule>& rules_convert_parentheses() {
  static const std::vector<Rule> r = {
      {std::regex(R"rgx(\()rgx"), "-LRB-"},
      {std::regex(R"rgx(\))rgx"), "-RRB-"},
      {std::regex(R"rgx(\[)rgx"), "-LSB-"},
      {std::regex(R"rgx(\])rgx"), "-RSB-"},
      {std::regex(R"rgx(\{)rgx"), "-LCB-"},
      {std::regex(R"rgx(\})rgx"), "-RCB-"},
  };
  return r;
}

const Rule& rule_double_dashes() {
  static const Rule r = {std::regex(R"rgx(--)rgx"), " -- "};
  return r;
}

const std::vector<Rule>& rules_ending_quotes() {
  static const std::vector<Rule> r = {
      {std::regex(R"rgx('')rgx"), " '' "},
      {std::regex(R"rgx(")rgx"), " '' "},
      {std::regex(R"rgx(([^' ])('[sS]|'[mM]|'[dD]|') )rgx"), "$1 $2 "},
      {std::regex(R"rgx(([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) )rgx"),
       "$1 $2 "},
  };
  return r;
}

// MacIntyre CONTRACTIONS2/3 (nltk destructive.py), (?i) -> icase.
const std::vector<Rule>& rules_contractions() {
  static const std::vector<Rule> r = {
      {std::regex(R"rgx(\b(can)(not)\b)rgx", std::regex::icase), " $1 $2 "},
      {std::regex(R"rgx(\b(d)('ye)\b)rgx", std::regex::icase), " $1 $2 "},
      {std::regex(R"rgx(\b(gim)(me)\b)rgx", std::regex::icase), " $1 $2 "},
      {std::regex(R"rgx(\b(gon)(na)\b)rgx", std::regex::icase), " $1 $2 "},
      {std::regex(R"rgx(\b(got)(ta)\b)rgx", std::regex::icase), " $1 $2 "},
      {std::regex(R"rgx(\b(lem)(me)\b)rgx", std::regex::icase), " $1 $2 "},
      {std::regex(R"rgx(\b(more)('n)\b)rgx", std::regex::icase), " $1 $2 "},
      {std::regex(R"rgx(\b(wan)(na)(?=\s))rgx", std::regex::icase),
       " $1 $2 "},
      // CONTRACTIONS3: leading literal space is part of the match.
      {std::regex(R"rgx( ('t)(is)\b)rgx", std::regex::icase), " $1 $2 "},
      {std::regex(R"rgx( ('t)(was)\b)rgx", std::regex::icase), " $1 $2 "},
  };
  return r;
}

std::string apply_rule(const std::string& text, const Rule& rule) {
  return std::regex_replace(text, rule.re, rule.rep);
}

std::string tokenize_to_line(const std::string& input) {
  std::string text = input;
  for (const auto& r : rules_starting_quotes()) text = apply_rule(text, r);
  for (const auto& r : rules_punctuation()) text = apply_rule(text, r);
  text = apply_rule(text, rule_parens_brackets());
  for (const auto& r : rules_convert_parentheses()) text = apply_rule(text, r);
  text = apply_rule(text, rule_double_dashes());
  text = " " + text + " ";
  for (const auto& r : rules_ending_quotes()) text = apply_rule(text, r);
  for (const auto& r : rules_contractions()) text = apply_rule(text, r);

  // text.split(): collapse any whitespace runs to single spaces.
  std::string out;
  out.reserve(text.size());
  bool in_token = false;
  for (char c : text) {
    const bool ws = (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                     c == '\f' || c == '\v');
    if (ws) {
      in_token = false;
    } else {
      if (!in_token && !out.empty()) out.push_back(' ');
      in_token = true;
      out.push_back(c);
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Tokenize one (lowercased) caption; writes space-joined tokens to `out`
// if they fit in `cap` bytes (including the trailing NUL). Returns the
// number of bytes needed EXCLUDING the NUL; the caller retries with a
// bigger buffer when the return value >= cap.
long s2vt_ptb_tokenize(const char* in, char* out, long cap) {
  const std::string joined = tokenize_to_line(std::string(in));
  const long needed = static_cast<long>(joined.size());
  if (needed + 1 <= cap) {
    std::memcpy(out, joined.data(), joined.size());
    out[joined.size()] = '\0';
  }
  return needed;
}

}  // extern "C"
