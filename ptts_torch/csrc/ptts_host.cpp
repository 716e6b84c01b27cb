// Native host-side components of ptts_torch (the port's own copy of the JAX
// package's csrc/ptts_host.cpp; the two are kept identical below this note).
//
// The accelerator path is PyTorch plus hand-written CUDA; these are the host
// pieces that the reference implements in C (SURVEY.md §2 native-component ledger):
//   * SentencePiece tokenizer: ModelProto parse, precompiled-charsmap XCDA
//     normalization, unigram Viterbi over UTF-8 boundaries
//     (algorithms per reference/ptts_spm.c, reimplemented in C++ with a
//     byte-trie for O(len * max_piece) matching instead of the reference's
//     O(len * vocab) scan)
//   * WAV write with the exact 16-bit quantization (clamp, *32767, trunc)
//   * F16/BF16 -> F32 conversions (bit-exact with ptts_safetensors.c)
//
// Exposed as a C ABI for ctypes (ptts_torch/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// protobuf primitives
// ---------------------------------------------------------------------------

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t val = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      val |= (uint64_t)(b & 0x7f) << shift;
      if (!(b & 0x80)) return val;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  bool skip(int wire) {
    switch (wire) {
      case 0: varint(); return ok;
      case 1: if (end - p < 8) return ok = false; p += 8; return true;
      case 2: {
        uint64_t n = varint();
        if (!ok || (uint64_t)(end - p) < n) return ok = false;
        p += n;
        return true;
      }
      case 5: if (end - p < 4) return ok = false; p += 4; return true;
      default: return ok = false;
    }
  }
};

// ---------------------------------------------------------------------------
// tokenizer model
// ---------------------------------------------------------------------------

struct Piece {
  std::string bytes;
  float score = 0.f;
  int type = 0;
};

struct TrieNode {
  std::unordered_map<uint8_t, int> children;
  int piece_id = -1;
  float score = 0.f;
};

struct Spm {
  std::vector<Piece> pieces;
  int unk_id = -1;
  bool add_dummy_prefix = true;
  bool remove_extra_whitespaces = true;
  bool escape_whitespaces = true;
  bool treat_whitespace_as_suffix = false;
  std::string charsmap;
  const uint32_t* xcda = nullptr;
  size_t xcda_size = 0;
  const char* prefix_repl = nullptr;
  size_t prefix_repl_size = 0;
  std::vector<const std::string*> user_pieces;
  std::vector<TrieNode> trie;  // trie[0] = root

  uint32_t xbase(uint32_t i) const {
    uint32_t n = xcda[i];
    return (n >> 10) << ((n & (1u << 9)) >> 6);
  }
  uint32_t xlcheck(uint32_t i) const {
    return xcda[i] & ((1u << 31) | 0xff);
  }
  bool xleaf(uint32_t i) const { return (xcda[i] >> 8) & 1u; }
  uint32_t xvalue(uint32_t i) const { return xcda[i] & ((1u << 31) - 1); }
};

bool parse_piece(Reader r, Piece* out) {
  while (r.p < r.end && r.ok) {
    uint64_t key = r.varint();
    if (!r.ok) return false;
    int field = (int)(key >> 3), wire = (int)(key & 7);
    if (field == 1 && wire == 2) {
      uint64_t n = r.varint();
      if (!r.ok || (uint64_t)(r.end - r.p) < n) return false;
      out->bytes.assign((const char*)r.p, n);
      r.p += n;
    } else if (field == 2 && wire == 5) {
      if (r.end - r.p < 4) return false;
      memcpy(&out->score, r.p, 4);
      r.p += 4;
    } else if (field == 3 && wire == 0) {
      out->type = (int)r.varint();
    } else if (!r.skip(wire)) {
      return false;
    }
  }
  return r.ok;
}

void parse_normalizer(Reader r, Spm* spm) {
  while (r.p < r.end && r.ok) {
    uint64_t key = r.varint();
    if (!r.ok) return;
    int field = (int)(key >> 3), wire = (int)(key & 7);
    if (field == 2 && wire == 2) {
      uint64_t n = r.varint();
      if (!r.ok || (uint64_t)(r.end - r.p) < n) return;
      spm->charsmap.assign((const char*)r.p, n);
      r.p += n;
    } else if (field == 3 && wire == 0) {
      spm->add_dummy_prefix = r.varint() != 0;
    } else if (field == 4 && wire == 0) {
      spm->remove_extra_whitespaces = r.varint() != 0;
    } else if (field == 5 && wire == 0) {
      spm->escape_whitespaces = r.varint() != 0;
    } else if (!r.skip(wire)) {
      return;
    }
  }
}

void parse_trainer(Reader r, Spm* spm) {
  while (r.p < r.end && r.ok) {
    uint64_t key = r.varint();
    if (!r.ok) return;
    int field = (int)(key >> 3), wire = (int)(key & 7);
    if (field == 24 && wire == 0) {
      spm->treat_whitespace_as_suffix = r.varint() != 0;
    } else if (!r.skip(wire)) {
      return;
    }
  }
}

void build_trie(Spm* spm) {
  spm->trie.clear();
  spm->trie.emplace_back();
  for (size_t pid = 0; pid < spm->pieces.size(); pid++) {
    const Piece& pc = spm->pieces[pid];
    if (pc.bytes.empty()) continue;
    int node = 0;
    for (unsigned char c : pc.bytes) {
      auto it = spm->trie[node].children.find(c);
      if (it == spm->trie[node].children.end()) {
        spm->trie[node].children.emplace(c, (int)spm->trie.size());
        node = (int)spm->trie.size();
        spm->trie.emplace_back();
      } else {
        node = it->second;
      }
    }
    TrieNode& tn = spm->trie[node];
    // duplicate byte strings: keep higher score, then lower id (matches the
    // reference's in-order strict-greater update)
    if (tn.piece_id < 0 || pc.score > tn.score) {
      tn.piece_id = (int)pid;
      tn.score = pc.score;
    }
  }
}

// strict UTF-8 char length; 0 = invalid (mirrors ptts_spm.c:281-318)
int utf8_len(const uint8_t* s, size_t avail) {
  if (avail == 0) return 0;
  uint8_t c0 = s[0];
  if (c0 < 0x80) return 1;
  if (c0 < 0xC2) return 0;
  if (c0 < 0xE0) {
    if (avail < 2 || (s[1] & 0xC0) != 0x80) return 0;
    return 2;
  }
  if (c0 < 0xF0) {
    if (avail < 3 || (s[1] & 0xC0) != 0x80 || (s[2] & 0xC0) != 0x80) return 0;
    if (c0 == 0xE0 && s[1] < 0xA0) return 0;
    if (c0 == 0xED && s[1] >= 0xA0) return 0;
    return 3;
  }
  if (c0 < 0xF5) {
    if (avail < 4 || (s[1] & 0xC0) != 0x80 || (s[2] & 0xC0) != 0x80 ||
        (s[3] & 0xC0) != 0x80)
      return 0;
    if (c0 == 0xF0 && s[1] < 0x90) return 0;
    if (c0 == 0xF4 && s[1] > 0x8F) return 0;
    return 4;
  }
  return 0;
}

struct NormPrefix {
  const char* data;
  size_t len;
  size_t consumed;
};

NormPrefix normalize_prefix(const Spm& spm, const uint8_t* in, size_t in_len,
                            size_t off) {
  static const char kReplacement[] = "\xEF\xBF\xBD";
  if (off >= in_len) return {(const char*)in + off, 0, 0};

  size_t user_best = 0;
  for (const std::string* up : spm.user_pieces) {
    if (up->size() > user_best && up->size() <= in_len - off &&
        memcmp(in + off, up->data(), up->size()) == 0)
      user_best = up->size();
  }
  if (user_best > 0) return {(const char*)in + off, user_best, user_best};

  size_t best_len = 0;
  uint32_t best_value = 0;
  if (spm.xcda_size > 0) {
    uint32_t node = spm.xbase(0);
    for (size_t i = off; i < in_len; i++) {
      uint8_t c = in[i];
      if (c == 0) break;
      node ^= c;
      if (node >= spm.xcda_size || spm.xlcheck(node) != c) break;
      bool leaf = spm.xleaf(node);
      node ^= spm.xbase(node);
      if (node >= spm.xcda_size) break;
      if (leaf) {
        best_len = i - off + 1;
        best_value = spm.xvalue(node);
      }
    }
  }
  if (best_len > 0) {
    if (best_value >= spm.prefix_repl_size)
      return {(const char*)in + off, 1, 1};
    const char* rep = spm.prefix_repl + best_value;
    return {rep, strnlen(rep, spm.prefix_repl_size - best_value), best_len};
  }
  int n = utf8_len(in + off, in_len - off);
  if (n > 0) return {(const char*)in + off, (size_t)n, (size_t)n};
  return {kReplacement, 3, 1};
}

std::string normalize(const Spm& spm, const char* text, size_t len) {
  static const char kEscaped[] = "\xE2\x96\x81";
  const char* space = spm.escape_whitespaces ? kEscaped : " ";
  const size_t space_len = spm.escape_whitespaces ? 3 : 1;
  const bool prepend = !spm.treat_whitespace_as_suffix && spm.add_dummy_prefix;
  const bool append = spm.treat_whitespace_as_suffix && spm.add_dummy_prefix;
  const bool merge = spm.remove_extra_whitespaces;

  std::string out;
  out.reserve(len + 8);
  bool space_prepended = false;
  bool in_non_ws = false;
  const uint8_t* in = (const uint8_t*)text;

  for (size_t off = 0; off < len;) {
    NormPrefix np = normalize_prefix(spm, in, len, off);
    for (size_t i = 0; i < np.len; i++) {
      char c = np.data[i];
      if (c != ' ') {
        if (!in_non_ws) {
          in_non_ws = true;
          if ((prepend && !space_prepended) || merge) {
            out.append(space, space_len);
            space_prepended = true;
          }
        }
        out.push_back(c);
      } else {
        in_non_ws = false;
        if (!merge) out.append(space, space_len);
      }
    }
    off += np.consumed;
  }
  if (append) out.append(space, space_len);
  return out;
}

}  // namespace

extern "C" {

void* ptts_spm_load_buf(const uint8_t* data, size_t len) {
  auto spm = std::make_unique<Spm>();
  Reader r{data, data + len};
  while (r.p < r.end && r.ok) {
    uint64_t key = r.varint();
    if (!r.ok) break;
    int field = (int)(key >> 3), wire = (int)(key & 7);
    if (field == 1 && wire == 2) {
      uint64_t n = r.varint();
      if (!r.ok || (uint64_t)(r.end - r.p) < n) break;
      Piece pc;
      if (!parse_piece(Reader{r.p, r.p + n}, &pc)) break;
      if (pc.type == 2 || pc.bytes == "<unk>") spm->unk_id = (int)spm->pieces.size();
      spm->pieces.push_back(std::move(pc));
      r.p += n;
    } else if (field == 2 && wire == 2) {
      uint64_t n = r.varint();
      if (!r.ok || (uint64_t)(r.end - r.p) < n) break;
      parse_trainer(Reader{r.p, r.p + n}, spm.get());
      r.p += n;
    } else if (field == 3 && wire == 2) {
      uint64_t n = r.varint();
      if (!r.ok || (uint64_t)(r.end - r.p) < n) break;
      parse_normalizer(Reader{r.p, r.p + n}, spm.get());
      r.p += n;
    } else if (!r.skip(wire)) {
      break;
    }
  }
  if (spm->pieces.empty()) return nullptr;

  // charsmap split: u32 blob size, XCDA u32 array, replacement strings
  if (spm->charsmap.size() >= 4) {
    uint32_t blob = 0;
    memcpy(&blob, spm->charsmap.data(), 4);
    if (4 + (size_t)blob <= spm->charsmap.size() && blob % 4 == 0) {
      spm->xcda = (const uint32_t*)(spm->charsmap.data() + 4);
      spm->xcda_size = blob / 4;
      spm->prefix_repl = spm->charsmap.data() + 4 + blob;
      spm->prefix_repl_size = spm->charsmap.size() - 4 - blob;
    }
  }
  for (const Piece& pc : spm->pieces)
    if (pc.type == 4 && !pc.bytes.empty()) spm->user_pieces.push_back(&pc.bytes);
  build_trie(spm.get());
  return spm.release();
}

void ptts_spm_free(void* h) { delete (Spm*)h; }

int ptts_spm_vocab_size(void* h) { return (int)((Spm*)h)->pieces.size(); }

int ptts_spm_flags(void* h) {
  Spm* spm = (Spm*)h;
  return (spm->add_dummy_prefix ? 1 : 0) | (spm->remove_extra_whitespaces ? 2 : 0) |
         (spm->escape_whitespaces ? 4 : 0) |
         (spm->treat_whitespace_as_suffix ? 8 : 0);
}

int ptts_spm_piece(void* h, int id, char* out, int cap) {
  Spm* spm = (Spm*)h;
  if (id < 0 || id >= (int)spm->pieces.size()) return -1;
  const std::string& b = spm->pieces[id].bytes;
  int n = (int)b.size();
  if (out && cap > 0) memcpy(out, b.data(), (size_t)std::min(n, cap));
  return n;
}

// Unigram Viterbi over UTF-8 boundaries (ptts_spm.c:617-738 semantics).
// Returns token count, or -1 on failure; writes up to max_ids ids.
int ptts_spm_encode(void* h, const char* text, int text_len, int* out_ids,
                    int max_ids) {
  Spm* spm = (Spm*)h;
  std::string norm = normalize(*spm, text, (size_t)text_len);
  if (norm.empty()) return 0;
  const int n = (int)norm.size();

  std::vector<int> bounds;
  bounds.reserve(n + 1);
  for (int i = 0; i < n; i++)
    if (((uint8_t)norm[i] & 0xC0) != 0x80) bounds.push_back(i);
  bounds.push_back(n);
  const int n_pos = (int)bounds.size();

  std::vector<int> bound_index(n + 1, -1);
  for (int i = 0; i < n_pos; i++) bound_index[bounds[i]] = i;

  const float NEG = -1e30f;
  std::vector<float> dp(n_pos, NEG);
  std::vector<int> prev(n_pos, -1), best(n_pos, -1);
  dp[0] = 0.f;

  for (int i = 0; i < n_pos - 1; i++) {
    if (dp[i] <= NEG / 2) continue;
    int start = bounds[i];
    bool matched = false;
    int node = 0;
    for (int endb = start; endb < n; endb++) {
      const auto& ch = spm->trie[node].children;
      auto it = ch.find((uint8_t)norm[endb]);
      if (it == ch.end()) break;
      node = it->second;
      const TrieNode& tn = spm->trie[node];
      if (tn.piece_id >= 0) {
        int end_idx = bound_index[endb + 1];
        if (end_idx >= 0) {
          matched = true;
          float score = dp[i] + tn.score;
          if (score > dp[end_idx]) {
            dp[end_idx] = score;
            prev[end_idx] = i;
            best[end_idx] = tn.piece_id;
          }
        }
      }
    }
    if (!matched && spm->unk_id >= 0) {
      float score = dp[i] + spm->pieces[spm->unk_id].score;
      if (score > dp[i + 1]) {
        dp[i + 1] = score;
        prev[i + 1] = i;
        best[i + 1] = spm->unk_id;
      }
    }
  }

  if (prev[n_pos - 1] < 0) return -1;
  int count = 0;
  for (int i = n_pos - 1; i > 0; i = prev[i]) count++;
  if (count > max_ids) return -count;  // caller re-allocates
  int idx = n_pos - 1;
  for (int i = count - 1; i >= 0; i--) {
    out_ids[i] = best[idx];
    idx = prev[idx];
  }
  return count;
}

// ---------------------------------------------------------------------------
// WAV writer (ptts_audio.c semantics)
// ---------------------------------------------------------------------------

int ptts_wav_write(const char* path, const float* samples, int64_t n,
                   int sample_rate, int channels) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const uint32_t data_bytes = (uint32_t)(n * 2);
  const uint32_t byte_rate = (uint32_t)sample_rate * channels * 2;
  const uint16_t block_align = (uint16_t)(channels * 2);

  auto w16 = [&](uint16_t v) { fwrite(&v, 2, 1, f); };
  auto w32 = [&](uint32_t v) { fwrite(&v, 4, 1, f); };
  fwrite("RIFF", 1, 4, f);
  w32(36 + data_bytes);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  w32(16);
  w16(1);
  w16((uint16_t)channels);
  w32((uint32_t)sample_rate);
  w32(byte_rate);
  w16(block_align);
  w16(16);
  fwrite("data", 1, 4, f);
  w32(data_bytes);

  std::vector<int16_t> buf;
  const int64_t CHUNK = 1 << 16;
  buf.resize((size_t)std::min(n, CHUNK));
  for (int64_t i = 0; i < n; i += CHUNK) {
    int64_t m = std::min(CHUNK, n - i);
    for (int64_t j = 0; j < m; j++) {
      float s = samples[i + j];
      if (s > 1.f) s = 1.f;
      if (s < -1.f) s = -1.f;
      buf[(size_t)j] = (int16_t)(s * 32767.f);
    }
    fwrite(buf.data(), 2, (size_t)m, f);
  }
  fclose(f);
  return 0;
}

void ptts_quantize_i16(const float* in, int16_t* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    float s = in[i];
    if (s > 1.f) s = 1.f;
    if (s < -1.f) s = -1.f;
    out[i] = (int16_t)(s * 32767.f);
  }
}

// ---------------------------------------------------------------------------
// dtype conversions (ptts_safetensors.c:294-334 semantics)
// ---------------------------------------------------------------------------

void ptts_f16_to_f32(const uint16_t* in, float* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    uint16_t h = in[i];
    uint16_t sign = (h >> 15) & 1;
    uint16_t exp = (h >> 10) & 0x1f;
    uint16_t mant = h & 0x3ff;
    uint32_t f;
    if (exp == 0) {
      if (mant == 0) {
        f = (uint32_t)sign << 31;
      } else {
        exp = 1;
        while (!(mant & 0x400)) {
          mant = (uint16_t)(mant << 1);
          exp--;
        }
        mant &= 0x3ff;
        exp = (uint16_t)(exp + 127 - 15);
        f = ((uint32_t)sign << 31) | ((uint32_t)exp << 23) | ((uint32_t)mant << 13);
      }
    } else if (exp == 31) {
      f = ((uint32_t)sign << 31) | 0x7f800000u | ((uint32_t)mant << 13);
    } else {
      exp = (uint16_t)(exp + 127 - 15);
      f = ((uint32_t)sign << 31) | ((uint32_t)exp << 23) | ((uint32_t)mant << 13);
    }
    memcpy(&out[i], &f, 4);
  }
}

void ptts_bf16_to_f32(const uint16_t* in, float* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    uint32_t f = (uint32_t)in[i] << 16;
    memcpy(&out[i], &f, 4);
  }
}

// ---------------------------------------------------------------------------
// Frame noise: xorshift64* + Box-Muller, bit-compatible with the reference
// sampler (ptts_flowlm.c:1013-1025, 1211-1231). Hot on the serving host path
// (one [frames, latent] draw per admitted request); the Python fallback in
// rng.py is a few hundred times slower.
// ---------------------------------------------------------------------------

static uint32_t noise_next_u32(uint64_t* state) {
  uint64_t x = *state;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  *state = x;
  return (uint32_t)((x * 2685821657736338717ULL) >> 32);
}

static float noise_next_f01(uint64_t* state) {
  uint32_t u = noise_next_u32(state);
  return ((float)u + 1.0f) / 4294967296.0f;
}

void ptts_frame_noise(int64_t seed, int frames, int latent_dim, float temp,
                      float noise_clamp, float* out) {
  const int64_t total = (int64_t)frames * latent_dim;
  for (int64_t i = 0; i < total; i++) out[i] = 0.f;
  if (temp <= 0.f) return;  // RNG never advances (reference semantics)
  const float std_ = sqrtf(temp);
  uint64_t rng;
  memcpy(&rng, &seed, 8);  // reinterpret int64 bits as uint64
  for (int f = 0; f < frames; f++) {
    float* row = out + (int64_t)f * latent_dim;
    for (int d = 0; d < latent_dim; d += 2) {
      float u1 = noise_next_f01(&rng);
      float u2 = noise_next_f01(&rng);
      float r = sqrtf(-2.0f * logf(u1));
      // (float)M_PI -- spelled out; -std=c++17 hides M_PI
      float theta = 2.0f * (float)3.14159265358979323846 * u2;
      float z0 = r * cosf(theta) * std_;
      float z1 = r * sinf(theta) * std_;
      if (noise_clamp > 0.f) {
        if (z0 < -noise_clamp) z0 = -noise_clamp;
        if (z0 > noise_clamp) z0 = noise_clamp;
        if (z1 < -noise_clamp) z1 = -noise_clamp;
        if (z1 > noise_clamp) z1 = noise_clamp;
      }
      row[d] = z0;
      if (d + 1 < latent_dim) row[d + 1] = z1;
    }
  }
}

}  // extern "C"
