// Native host runtime of vallex_tpu_torch: the host-side work in front of
// the card, with the C ABI of vallex_tpu/native/vallex_native.cpp.
//
//   vn_set_vocab   install the codepoint -> id table
//   vn_tokenize    UTF-8 phoneme string -> char-level token ids (the vocab
//                  has no merges, so encoding is an exact lookup)
//   vn_load_wav    RIFF/WAVE decode -> mono f32 at the file's rate:
//                  8/16/24/32-bit int PCM scaled and averaged in f32, as
//                  the stdlib path of utils/audio.py does (bitwise);
//                  32-bit IEEE float averaged in double;
//                  WAVE_FORMAT_EXTENSIBLE by its sub-format
//   vn_resample    windowed-sinc resampler (16 zero crossings, Hann window,
//                  weights normalised by their sum), the JAX package's
//                  arithmetic in double, so its output is that library's
//                  bit for bit
//
// Called through ctypes (native.py), which builds it at first use:
//   g++ -O3 -std=c++17 -shared -fPIC -o libvallex_native_<hash>.so vallex_native.cpp

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Tokenizer: codepoint -> id
// ---------------------------------------------------------------------------

static std::unordered_map<uint32_t, int32_t> g_vocab;
static std::mutex g_vocab_mu;
static int32_t g_unk_id = 0;

// vocab: parallel arrays of unicode codepoints and ids
void vn_set_vocab(const uint32_t* codepoints, const int32_t* ids, int n,
                  int32_t unk_id) {
  std::lock_guard<std::mutex> lock(g_vocab_mu);
  g_vocab.clear();
  for (int i = 0; i < n; i++) g_vocab[codepoints[i]] = ids[i];
  g_unk_id = unk_id;
}

// UTF-8 decode one codepoint; returns bytes consumed (0 on error)
static int utf8_decode(const unsigned char* s, int len, uint32_t* cp) {
  if (len <= 0) return 0;
  unsigned char c = s[0];
  if (c < 0x80) { *cp = c; return 1; }
  if ((c >> 5) == 0x6 && len >= 2) {
    *cp = ((c & 0x1F) << 6) | (s[1] & 0x3F);
    return 2;
  }
  if ((c >> 4) == 0xE && len >= 3) {
    *cp = ((c & 0x0F) << 12) | ((s[1] & 0x3F) << 6) | (s[2] & 0x3F);
    return 3;
  }
  if ((c >> 3) == 0x1E && len >= 4) {
    *cp = ((c & 0x07) << 18) | ((s[1] & 0x3F) << 12) | ((s[2] & 0x3F) << 6) |
          (s[3] & 0x3F);
    return 4;
  }
  return 0;
}

// -> number of ids written (<= max_out); unknown codepoints map to unk_id
int vn_tokenize(const char* utf8, int32_t* out_ids, int max_out) {
  const unsigned char* s = (const unsigned char*)utf8;
  int len = (int)strlen(utf8);
  int pos = 0, n = 0;
  while (pos < len && n < max_out) {
    uint32_t cp;
    int used = utf8_decode(s + pos, len - pos, &cp);
    if (used == 0) { pos++; continue; }  // skip a malformed byte
    pos += used;
    auto it = g_vocab.find(cp);
    out_ids[n++] = (it == g_vocab.end()) ? g_unk_id : it->second;
  }
  return n;
}

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

// Error codes of vn_load_wav (native.py names them in its exceptions).
enum {
  VN_WAV_OPEN = -1,         // the file cannot be opened
  VN_WAV_NOT_WAVE = -2,     // not RIFF/WAVE, or no fmt or data chunk
  VN_WAV_TRUNCATED = -3,    // the data chunk runs past the end of the file
  VN_WAV_UNSUPPORTED = -4,  // a sample format other than those above
};

static const uint16_t FMT_PCM = 1, FMT_FLOAT = 3, FMT_EXTENSIBLE = 0xFFFE;

// a chunk's size in the file: its data, padded to an even count
static long padded(uint32_t sz) { return ((long)sz + 1) & ~1L; }

static float pcm_sample(const uint8_t* p, int bits) {
  switch (bits) {
    case 8:
      return ((float)p[0] - 128.0f) / 128.0f;
    case 16: {
      int16_t v;
      memcpy(&v, p, 2);
      return (float)v / 32768.0f;
    }
    case 24: {
      // little-endian 3 bytes, bit 23 sign-extended
      int32_t v = (int32_t)((uint32_t)p[0] << 8 | (uint32_t)p[1] << 16 |
                            (uint32_t)p[2] << 24) >> 8;
      return (float)v / 8388608.0f;
    }
    default: {
      int32_t v;
      memcpy(&v, p, 4);
      return (float)v / 2147483648.0f;
    }
  }
}

// The f32 sum of n samples in numpy's order (its pairwise_sum, which a
// reduction over the channels of one frame runs): under 8 a running sum,
// up to 128 eight running sums added as a tree, above that two halves.
static float pairwise_sum(const float* a, long n) {
  if (n < 8) {
    float res = 0.0f;
    for (long i = 0; i < n; i++) res += a[i];
    return res;
  }
  if (n <= 128) {
    float r[8];
    for (int j = 0; j < 8; j++) r[j] = a[j];
    long i = 8;
    for (; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; j++) r[j] += a[i + j];
    float res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; i++) res += a[i];
    return res;
  }
  long n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// Returns the number of mono samples written to out (or the number the file
// holds if out is null), or one of the error codes above. sample_rate_out
// receives the file's rate.
long vn_load_wav(const char* path, float* out, long max_out,
                 int32_t* sample_rate_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return VN_WAV_OPEN;
  char riff[4], wave[4];
  uint32_t riff_size;
  if (fread(riff, 1, 4, f) != 4 || memcmp(riff, "RIFF", 4) ||
      fread(&riff_size, 4, 1, f) != 1 || fread(wave, 1, 4, f) != 4 ||
      memcmp(wave, "WAVE", 4)) {
    fclose(f);
    return VN_WAV_NOT_WAVE;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  long data_pos = -1;
  uint32_t data_len = 0;
  while (true) {
    char id[4];
    uint32_t sz;
    if (fread(id, 1, 4, f) != 4 || fread(&sz, 4, 1, f) != 1) break;
    if (!memcmp(id, "fmt ", 4)) {
      uint8_t buf[40] = {0};
      uint32_t take = sz < sizeof(buf) ? sz : (uint32_t)sizeof(buf);
      if (sz < 16 || fread(buf, 1, take, f) != take) break;
      fmt = buf[0] | (buf[1] << 8);
      channels = buf[2] | (buf[3] << 8);
      memcpy(&rate, buf + 4, 4);
      bits = buf[14] | (buf[15] << 8);
      // WAVE_FORMAT_EXTENSIBLE: the format is the sub-format GUID's first two bytes
      if (fmt == FMT_EXTENSIBLE && take >= 26) fmt = buf[24] | (buf[25] << 8);
      fseek(f, padded(sz) - (long)take, SEEK_CUR);
    } else if (!memcmp(id, "data", 4)) {
      data_pos = ftell(f);
      data_len = sz;
      fseek(f, padded(sz), SEEK_CUR);
    } else {
      fseek(f, padded(sz), SEEK_CUR);
    }
  }
  if (data_pos < 0 || channels == 0 || bits == 0) {
    fclose(f);
    return VN_WAV_NOT_WAVE;
  }
  bool is_int = fmt == FMT_PCM && (bits == 8 || bits == 16 || bits == 24 || bits == 32);
  bool is_float = fmt == FMT_FLOAT && bits == 32;
  if (!is_int && !is_float) {
    fclose(f);
    return VN_WAV_UNSUPPORTED;
  }
  int bytes_per = bits / 8;
  long frames = (long)(data_len / ((uint32_t)bytes_per * channels));
  fseek(f, 0, SEEK_END);
  long file_end = ftell(f);
  if (data_pos + frames * bytes_per * channels > file_end) {
    fclose(f);
    return VN_WAV_TRUNCATED;
  }
  *sample_rate_out = (int32_t)rate;
  if (!out) {
    fclose(f);
    return frames;
  }
  if (frames > max_out) frames = max_out;

  fseek(f, data_pos, SEEK_SET);
  std::vector<uint8_t> raw((size_t)frames * bytes_per * channels);
  if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    return VN_WAV_TRUNCATED;
  }
  fclose(f);

  std::vector<float> frame(channels);
  for (long i = 0; i < frames; i++) {
    const uint8_t* p = raw.data() + (size_t)i * channels * bytes_per;
    if (is_int) {
      // the Python path's arithmetic: each sample scaled in f32, then
      // numpy's f32 mean over the channels
      for (int c = 0; c < channels; c++) frame[c] = pcm_sample(p + c * bytes_per, bits);
      out[i] = channels == 1 ? frame[0] : pairwise_sum(frame.data(), channels) / (float)channels;
    } else {
      double acc = 0;
      for (int c = 0; c < channels; c++) {
        float v;
        memcpy(&v, p + c * 4, 4);
        acc += v;
      }
      out[i] = (float)(acc / channels);
    }
  }
  return frames;
}

// ---------------------------------------------------------------------------
// Windowed-sinc resampler
// ---------------------------------------------------------------------------

static long gcd_long(long a, long b) { return b ? gcd_long(b, a % b) : a; }

// -> number of output samples written (or required if out is null)
long vn_resample(const float* in, long n_in, int32_t sr_in, int32_t sr_out,
                 float* out, long max_out) {
  if (sr_in == sr_out) {
    if (!out) return n_in;
    long n = n_in < max_out ? n_in : max_out;
    memcpy(out, in, n * sizeof(float));
    return n;
  }
  long g = gcd_long(sr_in, sr_out);
  long up = sr_out / g, down = sr_in / g;
  long n_out = (n_in * up) / down;
  if (!out) return n_out;
  if (n_out > max_out) n_out = max_out;

  // low-pass at min(sr_in, sr_out) / 2, 16 zero crossings
  const int ZC = 16, TAPS = 2 * ZC + 1;
  double cutoff = 0.5 * (up < down ? (double)up / down : 1.0);
  // the taps depend only on the output's phase m * down % up: each phase's
  // are computed once, at its first use, with the same arithmetic
  std::vector<double> taps((size_t)up * TAPS);
  std::vector<char> done((size_t)up, 0);

  for (long m = 0; m < n_out; m++) {
    // output sample m lies at input time m * down / up
    long num = m * down;
    long i0 = num / up, phase = num % up;
    double* h = taps.data() + (size_t)phase * TAPS;
    if (!done[phase]) {
      double frac = (double)phase / up;
      for (long k = -ZC; k <= ZC; k++) {
        double x = (double)k - frac;
        double s = (x == 0) ? 1.0
                            : sin(2 * M_PI * cutoff * x) / (2 * M_PI * cutoff * x);
        double w = 0.5 * (1 + cos(M_PI * x / (ZC + 1)));  // Hann window
        h[k + ZC] = 2 * cutoff * s * w;
      }
      done[phase] = 1;
    }
    double acc = 0, wsum = 0;
    for (long k = -ZC; k <= ZC; k++) {
      long idx = i0 + k;
      if (idx < 0 || idx >= n_in) continue;
      acc += in[idx] * h[k + ZC];
      wsum += h[k + ZC];
    }
    out[m] = (float)(wsum > 1e-9 ? acc / wsum : acc);
  }
  return n_out;
}

}  // extern "C"
