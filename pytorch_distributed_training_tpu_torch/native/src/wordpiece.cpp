// Native WordPiece encoder: multithreaded batch tokenization, no GIL.
//
// The port's bulk encoder for real GLUE text (data/native_tokenizer.py): the
// same greedy longest-match-first WordPiece + pair assembly as the port's
// data/tokenizer.py (the Python source of truth, whose semantics are
// parity-tested against this file), encoding a whole split across a thread
// pool with no Python work per row.
//
// Scope contract (enforced by the Python wrapper, data/native_tokenizer.py):
// byte-level word chars are [A-Za-z0-9_]; rows containing non-ASCII bytes
// are routed to the Python encoder instead (Python's \w is unicode-aware,
// and silently diverging on unicode would be worse than a slow path).
//
// ABI (ctypes, a plain C interface):
//   wp_create(vocab_blob, blob_len, lower) -> handle
//       vocab_blob: '\n'-separated tokens, id = line index (BERT vocab.txt)
//   wp_encode_pairs(handle, a_blob, a_off, b_blob, b_off, n, max_length,
//                   n_threads, out_ids, out_types, out_mask)
//       *_blob: concatenated utf-8 rows; *_off: n+1 byte offsets
//       outputs: [n, max_length] int32; C++ writes only each row's used
//       prefix, so the caller must pre-fill out_ids with pad_id (NOT
//       necessarily 0) and out_types/out_mask with 0 — padding comes from
//       that pre-fill
//   wp_destroy(handle)

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> ids;
  int32_t pad_id = 0, unk_id = 100, cls_id = 101, sep_id = 102;
  bool lower = false;

  int32_t lookup_special(const char* tok, int32_t fallback) const {
    auto it = ids.find(tok);
    return it == ids.end() ? fallback : it->second;
  }
};

inline bool word_char(unsigned char c) {
  return std::isalnum(c) || c == '_';
}

// Python's re \s on str, restricted to ASCII: C isspace plus the
// file/group/record/unit separators 0x1c-0x1f (std::isspace misses those,
// which made "\x1c" tokenize as [UNK] instead of vanishing like the
// Python twin's \w+|[^\w\s] does).
inline bool space_char(unsigned char c) {
  return std::isspace(c) || (c >= 0x1c && c <= 0x1f);
}

// data/tokenizer.py basic_tokenize: \w+ runs | single non-word non-space
void basic_tokenize(std::string_view text, bool lower,
                    std::vector<std::string>& out) {
  size_t i = 0;
  std::string buf;
  while (i < text.size()) {
    unsigned char c = text[i];
    if (space_char(c)) {
      ++i;
      continue;
    }
    buf.clear();
    if (word_char(c)) {
      while (i < text.size() && word_char((unsigned char)text[i])) {
        buf.push_back(lower ? (char)std::tolower((unsigned char)text[i])
                            : text[i]);
        ++i;
      }
    } else {
      buf.push_back(lower ? (char)std::tolower(c) : (char)c);
      ++i;
    }
    out.push_back(buf);
  }
}

// data/tokenizer.py WordPieceTokenizer.word_ids: greedy longest-match with
// "##" continuation prefix; unmatched position -> whole word = [unk]
void word_ids(const Vocab& v, const std::string& word,
              std::vector<int32_t>& out) {
  size_t start = 0;
  size_t base = out.size();
  std::string piece;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t piece_id = -1;
    while (end > start) {
      piece.assign(start > 0 ? "##" : "");
      piece.append(word, start, end - start);
      auto it = v.ids.find(piece);
      if (it != v.ids.end()) {
        piece_id = it->second;
        break;
      }
      --end;
    }
    if (piece_id < 0) {
      out.resize(base);
      out.push_back(v.unk_id);
      return;
    }
    out.push_back(piece_id);
    start = end;
  }
}

void text_ids(const Vocab& v, std::string_view text,
              std::vector<int32_t>& out) {
  std::vector<std::string> words;
  basic_tokenize(text, v.lower, words);
  for (const auto& w : words) word_ids(v, w, out);
}

// data/tokenizer.py assemble_pair_row: [CLS] a [SEP] (b [SEP]), truncated
// longest-first to max_length
void assemble_row(const Vocab& v, std::vector<int32_t>& a,
                  std::vector<int32_t>& b, int64_t max_length,
                  int32_t* ids, int32_t* types, int32_t* mask) {
  const int64_t specials = 2 + (b.empty() ? 0 : 1);
  // Caller must guarantee max_length >= specials (the ctypes wrapper
  // validates per-row); the empty-check and the bounds-checked writes
  // below keep a bad direct-ABI caller at wrong-output instead of
  // pop_back-on-empty UB / out-of-row heap writes.
  while ((int64_t)(a.size() + b.size()) > max_length - specials) {
    if (a.empty() && b.empty()) break;
    if (a.size() >= b.size())
      a.pop_back();
    else
      b.pop_back();
  }
  int64_t p = 0;
  auto put = [&](int32_t id, int32_t type) {
    if (p < max_length) { ids[p] = id; types[p] = type; ++p; }
  };
  put(v.cls_id, 0);
  for (int32_t t : a) put(t, 0);
  put(v.sep_id, 0);
  if (!b.empty()) {
    for (int32_t t : b) put(t, 1);
    put(v.sep_id, 1);
  }
  for (int64_t i = 0; i < p; ++i) mask[i] = 1;
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_blob, int64_t blob_len, int32_t lower) {
  auto* v = new Vocab();
  v->lower = lower != 0;
  int32_t id = 0;
  const char* p = vocab_blob;
  const char* endp = vocab_blob + blob_len;
  while (p < endp) {
    const char* nl = (const char*)memchr(p, '\n', endp - p);
    size_t len = nl ? (size_t)(nl - p) : (size_t)(endp - p);
    v->ids.emplace(std::string(p, len), id++);
    if (!nl) break;
    p = nl + 1;
  }
  v->pad_id = v->lookup_special("[PAD]", 0);
  v->unk_id = v->lookup_special("[UNK]", 100);
  v->cls_id = v->lookup_special("[CLS]", 101);
  v->sep_id = v->lookup_special("[SEP]", 102);
  return v;
}

void wp_destroy(void* h) { delete (Vocab*)h; }

void wp_encode_pairs(void* h, const char* a_blob, const int64_t* a_off,
                     const char* b_blob, const int64_t* b_off, int64_t n,
                     int64_t max_length, int32_t n_threads, int32_t* out_ids,
                     int32_t* out_types, int32_t* out_mask) {
  const Vocab& v = *(const Vocab*)h;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<int32_t> a, b;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      a.clear();
      b.clear();
      text_ids(v, std::string_view(a_blob + a_off[i],
                                   (size_t)(a_off[i + 1] - a_off[i])), a);
      if (b_blob != nullptr)
        text_ids(v, std::string_view(b_blob + b_off[i],
                                     (size_t)(b_off[i + 1] - b_off[i])), b);
      assemble_row(v, a, b, max_length, out_ids + i * max_length,
                   out_types + i * max_length, out_mask + i * max_length);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt == 1 || n < 2) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

int32_t wp_special_id(void* h, int32_t which) {
  const Vocab& v = *(const Vocab*)h;
  switch (which) {
    case 0: return v.pad_id;
    case 1: return v.unk_id;
    case 2: return v.cls_id;
    case 3: return v.sep_id;
  }
  return -1;
}

}  // extern "C"
