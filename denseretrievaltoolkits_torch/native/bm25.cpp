// Native BM25 engine for hard-negative mining at corpus scale.
//
// The reference's BM25 (DRT/evaluator/index.py:57-140) is pure-Python dict
// work — O(total tokens) with per-token dict lookups — which is the host-side
// bottleneck of run_BM25_negative at MS MARCO scale (8.8M passages).  This
// engine keeps the same model (k1/b/eps·avg-idf floor on negative idfs,
// standard tf + k1*(1-b+b*len/avg) denominator) with:
//   - postings as flat (doc_id, tf) arrays grouped per token id,
//   - score accumulation into a dense per-doc array with an epoch-stamp trick
//     (no hashing, no clearing between queries),
//   - top-k via nth_element partial selection over touched docs only.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Posting {
  int32_t doc;
  int32_t tf;
};

struct BM25Index {
  // build-time staging: token -> postings
  std::unordered_map<int32_t, std::vector<Posting>> postings;
  std::unordered_map<int32_t, float> idf;
  std::vector<int32_t> doc_len;
  double k1 = 1.2;
  double b = 0.75;
  double eps = 0.25;
  double avg_doc_len = 0.0;
  bool finalized = false;

  // per-query scratch (epoch-stamped dense accumulators)
  std::vector<float> scores;
  std::vector<int32_t> stamp;
  std::vector<int32_t> touched;
  int32_t epoch = 0;
};

}  // namespace

extern "C" {

void* bm25_create(double k1, double b, double eps) {
  auto* idx = new BM25Index();
  idx->k1 = k1;
  idx->b = b;
  idx->eps = eps;
  return idx;
}

void bm25_destroy(void* h) { delete static_cast<BM25Index*>(h); }

int64_t bm25_num_docs(void* h) {
  return static_cast<BM25Index*>(h)->doc_len.size();
}

// Add one document (token ids). Returns its doc id.
int32_t bm25_add_doc(void* h, const int32_t* tokens, int32_t len) {
  auto* idx = static_cast<BM25Index*>(h);
  const int32_t doc = static_cast<int32_t>(idx->doc_len.size());
  idx->doc_len.push_back(len);
  // local tf counting
  std::unordered_map<int32_t, int32_t> tf;
  tf.reserve(len * 2);
  for (int32_t i = 0; i < len; ++i) tf[tokens[i]]++;
  for (const auto& kv : tf) {
    idx->postings[kv.first].push_back({doc, kv.second});
  }
  return doc;
}

// Compute idfs (with the reference's eps*avg_idf floor for negative idfs,
// index.py:100-115) and per-query scratch. Must be called before search.
void bm25_finalize(void* h) {
  auto* idx = static_cast<BM25Index*>(h);
  const double n = static_cast<double>(idx->doc_len.size());
  double idf_sum = 0.0;
  std::vector<int32_t> negative;
  idx->idf.reserve(idx->postings.size() * 2);
  for (const auto& kv : idx->postings) {
    const double df = static_cast<double>(kv.second.size());
    const double idf = std::log(n - df + 0.5) - std::log(df + 0.5);
    idx->idf[kv.first] = static_cast<float>(idf);
    idf_sum += idf;
    if (idf < 0) negative.push_back(kv.first);
  }
  if (!idx->idf.empty()) {
    const float floor_val =
        static_cast<float>(idx->eps * idf_sum / static_cast<double>(idx->idf.size()));
    for (int32_t w : negative) idx->idf[w] = floor_val;
  }
  int64_t total = 0;
  for (int32_t l : idx->doc_len) total += l;
  idx->avg_doc_len = n > 0 ? static_cast<double>(total) / n : 0.0;
  idx->scores.assign(idx->doc_len.size(), 0.f);
  idx->stamp.assign(idx->doc_len.size(), -1);
  idx->touched.reserve(1 << 16);
  idx->finalized = true;
}

// Top-k BM25 for one token-id query. Docs in [exclude_begin, exclude_end) are
// skipped (the miner's own-positive-span exclusion). Returns #results written.
int32_t bm25_search(void* h, const int32_t* query, int32_t qlen, int32_t k,
                    int32_t exclude_begin, int32_t exclude_end,
                    int32_t* out_ids, float* out_scores) {
  auto* idx = static_cast<BM25Index*>(h);
  if (!idx->finalized || k <= 0) return 0;
  const int32_t ep = ++idx->epoch;
  idx->touched.clear();
  const double k1 = idx->k1, b = idx->b, avg = idx->avg_doc_len;

  for (int32_t i = 0; i < qlen; ++i) {
    auto it = idx->postings.find(query[i]);
    if (it == idx->postings.end()) continue;
    const float idf = idx->idf[query[i]];
    for (const Posting& p : it->second) {
      if (p.doc >= exclude_begin && p.doc < exclude_end) continue;
      const double dl = idx->doc_len[p.doc];
      const double denom = p.tf + k1 * (1.0 - b + b * dl / avg);
      const float contrib = static_cast<float>(idf * p.tf * (k1 + 1.0) / denom);
      if (idx->stamp[p.doc] != ep) {
        idx->stamp[p.doc] = ep;
        idx->scores[p.doc] = contrib;
        idx->touched.push_back(p.doc);
      } else {
        idx->scores[p.doc] += contrib;
      }
    }
  }

  const int32_t n_out =
      std::min<int32_t>(k, static_cast<int32_t>(idx->touched.size()));
  auto cmp = [&](int32_t a, int32_t c) { return idx->scores[a] > idx->scores[c]; };
  std::partial_sort(idx->touched.begin(), idx->touched.begin() + n_out,
                    idx->touched.end(), cmp);
  for (int32_t i = 0; i < n_out; ++i) {
    out_ids[i] = idx->touched[i];
    out_scores[i] = idx->scores[idx->touched[i]];
  }
  return n_out;
}

// Batch variant: queries flattened with offsets; results padded with -1.
void bm25_search_batch(void* h, const int32_t* queries, const int64_t* offsets,
                       int32_t n_queries, int32_t k,
                       const int32_t* excl_begin, const int32_t* excl_end,
                       int32_t* out_ids, float* out_scores) {
  for (int32_t q = 0; q < n_queries; ++q) {
    const int32_t* qtok = queries + offsets[q];
    const int32_t qlen = static_cast<int32_t>(offsets[q + 1] - offsets[q]);
    int32_t* ids = out_ids + static_cast<int64_t>(q) * k;
    float* sc = out_scores + static_cast<int64_t>(q) * k;
    const int32_t eb = excl_begin ? excl_begin[q] : 0;
    const int32_t ee = excl_end ? excl_end[q] : 0;
    const int32_t n = bm25_search(h, qtok, qlen, k, eb, ee, ids, sc);
    for (int32_t i = n; i < k; ++i) {
      ids[i] = -1;
      sc[i] = 0.f;
    }
  }
}

}  // extern "C"
