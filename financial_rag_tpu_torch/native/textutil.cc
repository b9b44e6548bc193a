// Host-side text utilities for the ingest chunker.
//
// The chunker's packing decisions are driven by word counts under Python's
// regex \w+ (reference parent_child_chunker.py:117-119 heuristic: words x
// 1.3). For pure-ASCII text, \w is exactly [A-Za-z0-9_], so a byte scan
// reproduces re.findall(r"\w+", text) counts bit-for-bit at ~100x the
// regex engine's speed. Non-ASCII text stays on the Python path (the
// binding layer routes by isascii()).

#include <cstdint>

namespace {

inline bool is_word_byte(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_';
}

}  // namespace

extern "C" {

// Number of \w+ runs in ASCII text.
int64_t ft_word_count(const char* text, int64_t len) {
  int64_t count = 0;
  bool in_word = false;
  for (int64_t i = 0; i < len; ++i) {
    bool w = is_word_byte(static_cast<unsigned char>(text[i]));
    if (w && !in_word) ++count;
    in_word = w;
  }
  return count;
}

// Byte offsets where each \w+ run begins (== m.start() of re.finditer).
// Returns the number written (clipped to max_out).
int64_t ft_word_starts(const char* text, int64_t len, int64_t* out,
                       int64_t max_out) {
  int64_t count = 0;
  bool in_word = false;
  for (int64_t i = 0; i < len; ++i) {
    bool w = is_word_byte(static_cast<unsigned char>(text[i]));
    if (w && !in_word) {
      if (count < max_out) out[count] = i;
      ++count;
    }
    in_word = w;
  }
  return count < max_out ? count : max_out;
}

}  // extern "C"
