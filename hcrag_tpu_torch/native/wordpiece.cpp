// Native WordPiece batch tokenizer (host-side, ctypes ABI).
//
// Byte-exact reimplementation of hcrag_tpu.models.minilm.WordPieceTokenizer:
//   * lowercase (ASCII; non-ASCII codepoints pass through unchanged, which
//     matches the corpus-built vocab where every entry is ASCII),
//   * word split = the Python regex  [a-z0-9]+ | [^\s a-z0-9]  over
//     codepoints (UTF-8 aware: one multi-byte codepoint == one "char"
//     token; the common Unicode space codepoints count as \s),
//   * greedy longest-match-first WordPiece with "##" continuations and
//     whole-word [UNK] fallback,
//   * [CLS] ... [SEP] framing, truncation at max_len-1, zero padding.
//
// The Python tokenizer remains the reference implementation and fallback;
// tests/unit/test_native.py pins byte-equality of (ids, mask) on corpus
// texts and adversarial strings.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> map;
};

inline bool is_uspace(uint32_t cp) {
  // ASCII whitespace + the Unicode spaces Python's \s matches.
  if (cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' || cp == '\f' ||
      cp == '\v' || (cp >= 0x1C && cp <= 0x1F))  // incl. FS/GS/RS/US like \s
    return true;
  switch (cp) {
    case 0x85: case 0xA0: case 0x1680: case 0x2028: case 0x2029:
    case 0x202F: case 0x205F: case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200A;
  }
}

inline bool is_word_char(uint32_t cp) {
  return (cp >= 'a' && cp <= 'z') || (cp >= '0' && cp <= '9');
}

// Decode one UTF-8 codepoint starting at s[i]; returns byte length.
inline int decode(const char* s, int64_t i, int64_t end, uint32_t* cp) {
  unsigned char c = (unsigned char)s[i];
  if (c < 0x80) { *cp = c; return 1; }
  int len = (c >= 0xF0) ? 4 : (c >= 0xE0) ? 3 : 2;
  if (i + len > end) len = 1;
  uint32_t v = c & (0xFF >> (len + 1));
  for (int k = 1; k < len; ++k)
    v = (v << 6) | ((unsigned char)s[i + k] & 0x3F);
  *cp = v;
  return len;
}

void wordpiece(const Vocab& vb, const std::string& word, int32_t unk_id,
               std::vector<int32_t>* out) {
  auto it = vb.map.find(word);
  if (it != vb.map.end()) {
    out->push_back(it->second);
    return;
  }
  std::vector<int32_t> pieces;
  size_t start = 0;
  std::string sub;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t piece_id = -1;
    while (end > start) {
      sub.assign(start > 0 ? "##" : "");
      sub.append(word, start, end - start);
      auto pit = vb.map.find(sub);
      if (pit != vb.map.end()) {
        piece_id = pit->second;
        break;
      }
      --end;
    }
    if (piece_id < 0) {
      out->push_back(unk_id);
      return;  // whole-word [UNK], matching the Python fallback
    }
    pieces.push_back(piece_id);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_blob, const int64_t* offsets,
                int64_t n_vocab) {
  auto* vb = new Vocab();
  vb->map.reserve((size_t)n_vocab * 2);
  for (int64_t i = 0; i < n_vocab; ++i) {
    vb->map.emplace(
        std::string(vocab_blob + offsets[i], vocab_blob + offsets[i + 1]),
        (int32_t)i);
  }
  return vb;
}

void wp_destroy(void* h) { delete (Vocab*)h; }

void wp_encode_batch(void* h, const char* blob, const int64_t* offsets,
                     int64_t n_texts, int32_t max_len, int32_t lowercase,
                     int32_t cls_id, int32_t sep_id, int32_t unk_id,
                     int32_t* out_ids, int32_t* out_mask) {
  const Vocab& vb = *(const Vocab*)h;
  std::vector<int32_t> row;
  std::string word;
  for (int64_t t = 0; t < n_texts; ++t) {
    const char* s = blob + offsets[t];
    const int64_t len = offsets[t + 1] - offsets[t];
    row.clear();
    row.push_back(cls_id);
    int64_t i = 0;
    bool full = false;
    while (i < len && !full) {
      uint32_t cp;
      int cl = decode(s, i, len, &cp);
      uint32_t lc = (lowercase && cp >= 'A' && cp <= 'Z') ? cp + 32 : cp;
      if (is_word_char(lc)) {
        word.clear();
        while (i < len) {
          int cl2 = decode(s, i, len, &cp);
          uint32_t lc2 = (lowercase && cp >= 'A' && cp <= 'Z') ? cp + 32 : cp;
          if (!is_word_char(lc2)) break;
          word.push_back((char)lc2);
          i += cl2;
        }
        wordpiece(vb, word, unk_id, &row);
        if ((int32_t)row.size() >= max_len - 1) full = true;
      } else if (is_uspace(lc)) {
        i += cl;
      } else {
        // single non-space, non-alnum codepoint token (original bytes,
        // ASCII lowercased)
        word.clear();
        if (lc < 0x80) {
          word.push_back((char)lc);
        } else {
          word.assign(s + i, s + i + cl);
        }
        i += cl;
        wordpiece(vb, word, unk_id, &row);
        if ((int32_t)row.size() >= max_len - 1) full = true;
      }
    }
    if ((int64_t)row.size() > max_len - 1) row.resize(max_len - 1);
    row.push_back(sep_id);
    int32_t* ids = out_ids + t * max_len;
    int32_t* mask = out_mask + t * max_len;
    std::memset(ids, 0, sizeof(int32_t) * max_len);
    std::memset(mask, 0, sizeof(int32_t) * max_len);
    for (size_t j = 0; j < row.size(); ++j) {
      ids[j] = row[j];
      mask[j] = 1;
    }
  }
}

}  // extern "C"
