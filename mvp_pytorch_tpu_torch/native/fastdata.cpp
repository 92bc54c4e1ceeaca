// Native host code for the input pipeline (not a device kernel): this
// package's copy of the JAX package's native/fastdata.cpp, without its
// retired `b64_decode`.
//
// Per example, the loader's workers tokenize a caption and decode a base64
// row of region features (the reference spends its DataLoader workers' time
// there, `oscar/oscar_datasets_ml/oscar_tsv4.py` __getitem__). Two entry
// points with a plain C ABI, loaded with ctypes by native/__init__.py:
//
//   - greedy WordPiece tokenization over a hash-map vocab (ASCII fast path:
//     lowercase + punctuation split + greedy longest-match with "##"
//     continuations, the algorithm of data/tokenization.py, which stays the
//     reference and the non-ASCII path),
//   - b64_decode_at: a base64 span decoded into the caller's buffer.
//
// Build (native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC -o libfastdata.so fastdata.cpp
//
// Thread safety: vocab handles are immutable after load; all entry points
// are reentrant.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

struct Vocab {
  std::unordered_map<std::string, int32_t> map;
  int32_t unk_id;
  int32_t max_chars_per_word;
};

// --------------------------------------------------------------------------
// vocab
// --------------------------------------------------------------------------

void* vocab_create() { return new Vocab{{}, 1, 100}; }

void vocab_add(void* handle, const char* token, int32_t id) {
  static_cast<Vocab*>(handle)->map.emplace(token, id);
}

void vocab_finalize(void* handle, int32_t unk_id) {
  static_cast<Vocab*>(handle)->unk_id = unk_id;
}

void vocab_free(void* handle) { delete static_cast<Vocab*>(handle); }

int32_t vocab_size(void* handle) {
  return static_cast<int32_t>(static_cast<Vocab*>(handle)->map.size());
}

// --------------------------------------------------------------------------
// tokenization (ASCII fast path)
// --------------------------------------------------------------------------

static inline bool is_ascii_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

static void wordpiece(const Vocab& v, const std::string& word,
                      std::vector<int32_t>& out) {
  if ((int32_t)word.size() > v.max_chars_per_word) {
    out.push_back(v.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> subs;
  std::string buf;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      buf.clear();
      if (start > 0) buf = "##";
      buf.append(word, start, end - start);
      auto it = v.map.find(buf);
      if (it != v.map.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out.push_back(v.unk_id);
      return;
    }
    subs.push_back(cur);
    start = end;
  }
  out.insert(out.end(), subs.begin(), subs.end());
}

// returns n tokens written, or -1 if text is not pure printable ASCII
// (caller falls back to the Python tokenizer for unicode).
int32_t tokenize_ascii(void* handle, const char* text, int32_t text_len,
                       int32_t* out, int32_t max_out) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  std::vector<int32_t> ids;
  ids.reserve(64);
  std::string word;
  auto flush = [&]() {
    if (!word.empty()) {
      wordpiece(v, word, ids);
      word.clear();
    }
  };
  for (int32_t i = 0; i < text_len; ++i) {
    unsigned char c = text[i];
    if (c >= 128) return -1;  // non-ASCII: python fallback
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      flush();
    } else if (is_ascii_punct(c)) {
      flush();
      word.assign(1, (char)c);
      flush();
    } else {
      if (c < 32) continue;  // control chars dropped
      word.push_back((char)((c >= 'A' && c <= 'Z') ? c + 32 : c));
    }
  }
  flush();
  int32_t n = (int32_t)ids.size();
  if (n > max_out) n = max_out;
  std::memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

// --------------------------------------------------------------------------
// fast base64 span decode (4x256 uint32 LUT; one OR + one 4-byte store per
// input quartet). binascii.a2b_base64 runs ~200 MB/s on the ~0.55 MB feature
// rows (2.7 ms/example — 46% of corpus-scale ingest, profiled r5); this
// kernel decodes the same span at multi-GB/s directly into the caller's
// output buffer, so the Python side never materializes the base64 slice or
// the decoded bytes object.
// --------------------------------------------------------------------------

struct B64Tables {
  // per-position contributions to the little-endian output word; invalid
  // chars carry 0xFF000000 so one AND after the OR detects them.
  uint32_t d0[256], d1[256], d2[256], d3[256];
  B64Tables() {
    const char* alpha =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    for (int i = 0; i < 256; ++i)
      d0[i] = d1[i] = d2[i] = d3[i] = 0xFF000000u;
    for (uint32_t v = 0; v < 64; ++v) {
      unsigned char c = (unsigned char)alpha[v];
      // b0 = v0<<2 | v1>>4;  b1 = (v1&15)<<4 | v2>>2;  b2 = (v2&3)<<6 | v3
      d0[c] = v << 2;
      d1[c] = (v >> 4) | ((v & 0x0Fu) << 12);
      d2[c] = ((v >> 2) << 8) | ((v & 0x03u) << 22);
      d3[c] = v << 16;
    }
  }
};

// Decode the base64 span buf[start : start+len] into out. Returns bytes
// written, or -1 when the span is not clean contiguous base64 (invalid
// char, mid-span padding/whitespace, dangling quartet) or out_cap is too
// small — the caller falls back to the stdlib decoder, which owns the
// permissive/error semantics.
int64_t b64_decode_at(const char* buf, int64_t start, int64_t len,
                      uint8_t* out, int64_t out_cap) {
  static const B64Tables T;  // C++11 static-local init is thread-safe
  const unsigned char* in = (const unsigned char*)buf + start;
  int64_t n = len;
  while (n > 0 && (in[n - 1] == '=' || in[n - 1] == '\n' ||
                   in[n - 1] == '\r')) {
    --n;
  }
  const int64_t groups = n / 4;
  const int64_t tail = n % 4;
  if (tail == 1) return -1;  // 6 dangling bits: never valid base64
  // each group stores 4 bytes (3 valid + 1 spare the next store or the
  // tail overwrites); the buffer must hold every byte actually touched
  const int64_t touched = groups * 3 + (tail ? tail - 1 : (groups ? 1 : 0));
  if (touched > out_cap) return -1;
  const unsigned char* p = in;
  uint8_t* o = out;
  for (int64_t g = 0; g < groups; ++g, p += 4, o += 3) {
    uint32_t w = T.d0[p[0]] | T.d1[p[1]] | T.d2[p[2]] | T.d3[p[3]];
    if (w & 0xFF000000u) return -1;
    std::memcpy(o, &w, 4);
  }
  if (tail) {  // 2 or 3 chars -> 1 or 2 bytes
    uint32_t w = T.d0[p[0]] | T.d1[p[1]] | (tail == 3 ? T.d2[p[2]] : 0u);
    if (w & 0xFF000000u) return -1;
    std::memcpy(o, &w, tail == 3 ? 2 : 1);  // within cap (`touched`)
    o += tail - 1;
  }
  return o - out;
}

}  // extern "C"
