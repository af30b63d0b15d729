// fasthash — native tokenizer + feature-hashing embedder kernels.
//
// The host-side ingestion hot loop (tokenize -> hash -> bucket accumulate ->
// idf weight -> L2 normalize) is the framework's equivalent of the
// reference's per-row SentenceTransformer calls (embedding_generator.py:124)
// — pure CPU work that gates index-build throughput.  This implementation is
// byte-for-byte compatible with the Python fallback in models/embedder.py:
// same lowercase [a-z0-9]+ tokenization, same 64-bit FNV-1a hash, same
// sign-bit / bucket / idf scheme.
//
// Build: g++ -O3 -march=native -shared -fPIC fasthash.cpp -o libfasthash.so
// Interface: C ABI consumed via ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;

inline uint64_t fnv1a(const char* data, size_t len) {
  uint64_t h = kFnvOffset;
  for (size_t i = 0; i < len; ++i) {
    h ^= static_cast<uint8_t>(data[i]);
    h *= kFnvPrime;
  }
  return h;
}

inline uint64_t fnv1a_pair(const char* a, size_t la, const char* b, size_t lb) {
  // hash of "a_b" without materializing the joined string
  uint64_t h = fnv1a(a, la);
  h ^= static_cast<uint8_t>('_');
  h *= kFnvPrime;
  for (size_t i = 0; i < lb; ++i) {
    h ^= static_cast<uint8_t>(b[i]);
    h *= kFnvPrime;
  }
  return h;
}

struct Token {
  const char* ptr;
  size_t len;
};

// Lowercase [a-z0-9]+ tokenization into a scratch buffer.
void tokenize(const char* text, size_t len, std::vector<char>& lower,
              std::vector<Token>& tokens) {
  lower.resize(len);
  for (size_t i = 0; i < len; ++i) {
    char c = text[i];
    lower[i] = (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : c;
  }
  tokens.clear();
  size_t i = 0;
  while (i < len) {
    char c = lower[i];
    bool alnum = (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
    if (!alnum) {
      ++i;
      continue;
    }
    size_t start = i;
    while (i < len) {
      char d = lower[i];
      if (!((d >= 'a' && d <= 'z') || (d >= '0' && d <= '9'))) break;
      ++i;
    }
    tokens.push_back({lower.data() + start, i - start});
  }
}

inline void accumulate(uint64_t h, int dim, const double* idf, float* vec) {
  uint32_t bucket = static_cast<uint32_t>(h % static_cast<uint64_t>(dim));
  float sign = ((h >> 32) & 1ULL) ? 1.0f : -1.0f;
  float w = idf ? static_cast<float>(idf[bucket]) : 1.0f;
  vec[bucket] += sign * w;
}

}  // namespace

extern "C" {

// Embed a batch of texts.
//   texts:    concatenated UTF-8 bytes
//   offsets:  [n+1] byte offsets into `texts`
//   n:        number of texts
//   dim:      embedding dimension
//   use_bigrams: adjacent-token bigram features
//   idf:      optional [dim] per-bucket idf weights (nullptr = unweighted)
//   out:      [n * dim] float32 output (L2-normalized rows)
void embed_batch(const char* texts, const int64_t* offsets, int64_t n,
                 int32_t dim, int32_t use_bigrams, const double* idf,
                 float* out) {
  std::vector<char> lower;
  std::vector<Token> tokens;
  for (int64_t row = 0; row < n; ++row) {
    const char* text = texts + offsets[row];
    size_t len = static_cast<size_t>(offsets[row + 1] - offsets[row]);
    float* vec = out + row * dim;
    std::memset(vec, 0, sizeof(float) * dim);
    tokenize(text, len, lower, tokens);
    for (size_t t = 0; t < tokens.size(); ++t) {
      accumulate(fnv1a(tokens[t].ptr, tokens[t].len), dim, idf, vec);
      if (use_bigrams && t + 1 < tokens.size()) {
        accumulate(fnv1a_pair(tokens[t].ptr, tokens[t].len,
                              tokens[t + 1].ptr, tokens[t + 1].len),
                   dim, idf, vec);
      }
    }
    double norm = 0.0;
    for (int32_t j = 0; j < dim; ++j) norm += double(vec[j]) * vec[j];
    if (norm > 0.0) {
      float inv = static_cast<float>(1.0 / std::sqrt(norm));
      for (int32_t j = 0; j < dim; ++j) vec[j] *= inv;
    }
  }
}

// Per-bucket document frequencies over a corpus (for idf fitting).
//   df: [dim] int64 output (zero-initialized by caller)
void bucket_df(const char* texts, const int64_t* offsets, int64_t n,
               int32_t dim, int32_t use_bigrams, int64_t* df) {
  std::vector<char> lower;
  std::vector<Token> tokens;
  std::vector<uint8_t> seen(static_cast<size_t>(dim));
  for (int64_t row = 0; row < n; ++row) {
    const char* text = texts + offsets[row];
    size_t len = static_cast<size_t>(offsets[row + 1] - offsets[row]);
    std::memset(seen.data(), 0, seen.size());
    tokenize(text, len, lower, tokens);
    auto mark = [&](uint64_t h) {
      seen[static_cast<size_t>(h % static_cast<uint64_t>(dim))] = 1;
    };
    for (size_t t = 0; t < tokens.size(); ++t) {
      mark(fnv1a(tokens[t].ptr, tokens[t].len));
      if (use_bigrams && t + 1 < tokens.size()) {
        mark(fnv1a_pair(tokens[t].ptr, tokens[t].len, tokens[t + 1].ptr,
                        tokens[t + 1].len));
      }
    }
    for (int32_t j = 0; j < dim; ++j) df[j] += seen[j];
  }
}

}  // extern "C"
