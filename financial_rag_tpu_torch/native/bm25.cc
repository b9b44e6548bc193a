// Native BM25 (Okapi) scorer with an inverted index.
//
// Replaces the capability of the pure-Python rank_bm25 dependency the
// reference uses (rag_backend.py:776-788) with a C++ inverted index:
// build once over candidate texts (whitespace tokenization, matching the
// reference's .split()), score many queries. Parameters k1=1.5, b=0.75,
// negative-idf floor = eps * average idf (rank_bm25 BM25Okapi semantics).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Posting {
  int32_t doc;
  float tf;
};

struct BM25 {
  float k1 = 1.5f;
  float b = 0.75f;
  float eps = 0.25f;
  bool finalized = false;
  std::vector<float> doc_lens;
  float avgdl = 0.0f;
  std::unordered_map<std::string, std::vector<Posting>> postings;
  std::unordered_map<std::string, float> idf;
};

void split_ws(const char* text, size_t len,
              std::vector<std::string_view>& out) {
  size_t i = 0;
  while (i < len) {
    while (i < len && static_cast<unsigned char>(text[i]) <= ' ') ++i;
    size_t start = i;
    while (i < len && static_cast<unsigned char>(text[i]) > ' ') ++i;
    if (i > start) out.emplace_back(text + start, i - start);
  }
}

}  // namespace

extern "C" {

void* bm25_new(float k1, float b, float eps) {
  auto* m = new BM25();
  m->k1 = k1;
  m->b = b;
  m->eps = eps;
  return m;
}

void bm25_free(void* handle) { delete static_cast<BM25*>(handle); }

int32_t bm25_add_doc(void* handle, const char* text, int64_t len) {
  BM25& m = *static_cast<BM25*>(handle);
  int32_t doc = static_cast<int32_t>(m.doc_lens.size());
  std::vector<std::string_view> toks;
  split_ws(text, static_cast<size_t>(len), toks);
  m.doc_lens.push_back(static_cast<float>(toks.size()));
  std::unordered_map<std::string, float> tf;
  for (auto t : toks) tf[std::string(t)] += 1.0f;
  for (auto& [term, count] : tf) m.postings[term].push_back({doc, count});
  return doc;
}

void bm25_finalize(void* handle) {
  BM25& m = *static_cast<BM25*>(handle);
  const float n = static_cast<float>(m.doc_lens.size());
  float sum = 0.0f;
  for (float dl : m.doc_lens) sum += dl;
  m.avgdl = n > 0 ? sum / n : 0.0f;

  double idf_sum = 0.0;
  std::vector<std::string> negative;
  for (auto& [term, plist] : m.postings) {
    float df = static_cast<float>(plist.size());
    float v = std::log((n - df + 0.5f) / (df + 0.5f));
    m.idf[term] = v;
    idf_sum += v;
    if (v < 0) negative.push_back(term);
  }
  float avg = m.idf.empty() ? 0.0f : static_cast<float>(idf_sum / m.idf.size());
  float floor_v = m.eps * avg;
  for (auto& term : negative) m.idf[term] = floor_v;
  m.finalized = true;
}

int32_t bm25_num_docs(void* handle) {
  return static_cast<int32_t>(static_cast<BM25*>(handle)->doc_lens.size());
}

// Score one whitespace-tokenized query against all docs. out[n_docs].
void bm25_score(void* handle, const char* query, int64_t len, float* out) {
  BM25& m = *static_cast<BM25*>(handle);
  const size_t n = m.doc_lens.size();
  memset(out, 0, sizeof(float) * n);
  if (!m.finalized || n == 0) return;
  std::vector<std::string_view> toks;
  split_ws(query, static_cast<size_t>(len), toks);
  for (auto t : toks) {
    auto it = m.postings.find(std::string(t));
    if (it == m.postings.end()) continue;
    const float idf = m.idf[std::string(t)];
    for (const Posting& p : it->second) {
      const float dl = m.doc_lens[static_cast<size_t>(p.doc)];
      const float norm = m.k1 * (1.0f - m.b + m.b * dl / (m.avgdl > 0 ? m.avgdl : 1.0f));
      out[p.doc] += idf * p.tf * (m.k1 + 1.0f) / (p.tf + norm);
    }
  }
}

}  // extern "C"
