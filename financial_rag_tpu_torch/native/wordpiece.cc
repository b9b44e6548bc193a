// Native batch WordPiece tokenizer (host-side hot path).
//
// The reference delegates tokenization to Python loops (local_embedder.py)
// or HF's Rust tokenizers; this framework tokenizes every child chunk and
// query on the host before device encode, so a C++ fast path matters for
// ingest throughput. Semantics: HF BertTokenizer BasicTokenizer+WordPiece
// for ASCII input (lowercase, punctuation split, greedy longest match,
// 100-char word cap). The Python wrapper routes non-ASCII texts to the
// pure-Python implementation so results are always exact.

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> table;
  int32_t unk_id = 100;
};

inline bool is_ws(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}
// Unicode Cc in ASCII range: C0 block plus DEL (0x7f) — HF's BasicTokenizer
// strips both, and _native_safe routes '\x7f' here (str.isascii() is true).
inline bool is_ctrl(unsigned char c) { return (c < 0x20 || c == 0x7f) && !is_ws(c); }
inline bool is_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) || (c >= 91 && c <= 96) ||
         (c >= 123 && c <= 126);
}

constexpr int kMaxWordChars = 100;

// Greedy longest-match WordPiece of one lowercase word into ids.
void wordpiece(const Vocab& v, std::string_view word, std::vector<int32_t>& out) {
  if (word.size() > kMaxWordChars) {
    out.push_back(v.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  std::string buf;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      buf.assign(start > 0 ? "##" : "");
      buf.append(word.substr(start, end - start));
      auto it = v.table.find(buf);
      if (it != v.table.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out.push_back(v.unk_id);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  out.insert(out.end(), pieces.begin(), pieces.end());
}

// BasicTokenizer (ASCII) + WordPiece: text -> ids (no CLS/SEP).
void tokenize(const Vocab& v, const char* text, size_t len,
              std::vector<int32_t>& out) {
  std::string word;
  word.reserve(32);
  auto flush = [&]() {
    if (!word.empty()) {
      wordpiece(v, word, out);
      word.clear();
    }
  };
  for (size_t i = 0; i < len; ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (c == 0 || is_ctrl(c)) continue;
    if (is_ws(c)) {
      flush();
      continue;
    }
    if (is_punct(c)) {
      flush();
      word.push_back(static_cast<char>(c));
      flush();
      continue;
    }
    if (c >= 'A' && c <= 'Z') c = static_cast<unsigned char>(c - 'A' + 'a');
    word.push_back(static_cast<char>(c));
  }
  flush();
}

}  // namespace

extern "C" {

// vocab_data: '\n'-separated tokens in id order.
void* wp_new(const char* vocab_data, int64_t len) {
  auto* v = new Vocab();
  int32_t id = 0;
  const char* p = vocab_data;
  const char* endp = vocab_data + len;
  while (p < endp) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', endp - p));
    size_t tok_len = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(endp - p);
    if (tok_len > 0) {
      std::string tok(p, tok_len);
      v->table.emplace(std::move(tok), id);
    }
    ++id;
    if (!nl) break;
    p = nl + 1;
  }
  auto it = v->table.find("[UNK]");
  if (it != v->table.end()) v->unk_id = it->second;
  return v;
}

void wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

// Tokenize one text. Returns token count (clipped to max_out).
int32_t wp_tokenize(void* handle, const char* text, int64_t text_len,
                    int32_t* out_ids, int32_t max_out) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  std::vector<int32_t> ids;
  ids.reserve(256);
  tokenize(v, text, static_cast<size_t>(text_len), ids);
  int32_t n = static_cast<int32_t>(ids.size());
  if (n > max_out) n = max_out;
  memcpy(out_ids, ids.data(), sizeof(int32_t) * static_cast<size_t>(n));
  return n;
}

// Batch tokenize: texts concatenated in `data` with offsets[n+1].
// out shape [n, max_out] (row-major), lens[n] receives counts.
void wp_tokenize_batch(void* handle, const char* data, const int64_t* offsets,
                       int32_t n, int32_t* out, int32_t max_out, int32_t* lens) {
  for (int32_t i = 0; i < n; ++i) {
    lens[i] = wp_tokenize(handle, data + offsets[i], offsets[i + 1] - offsets[i],
                          out + static_cast<int64_t>(i) * max_out, max_out);
  }
}

}  // extern "C"
