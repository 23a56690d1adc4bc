// tacodata: native data-IO runtime of the PyTorch port (a copy of the
// JAX package's native/tacodata.cc).
//
// The reference delegated its input-pipeline runtime to TensorFlow's C++
// (threaded feeder -> tf.FIFOQueue, reference code/tacotron/feeder.py:141-234)
// and to librosa/scipy C for audio IO. This library is the framework's native
// equivalent: GIL-free parallel .npy loading for the feeder hot path, a
// vectorized mu-law codec (reference code/wavenet_vocoder/util.py:10-80), and
// PCM16 WAV read/write (reference code/datasets/audio.py:9-15).
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (tacotron2_tpu_torch/native/io.py, which builds it with the host C++
// compiler at first use: tacotron2_tpu_torch/native/build.py
// `build_host`).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ------------------------------------------------------------------ npy

// Minimal NumPy .npy v1/v2 parser for C-contiguous numeric arrays.
struct NpyInfo {
  std::string descr;
  bool fortran = false;
  std::vector<int64_t> shape;
  size_t data_offset = 0;
};

bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    info->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  auto find_val = [&](const char* key) -> std::string {
    size_t p = header.find(key);
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    return header.substr(p + 1);
  };
  std::string d = find_val("'descr'");
  size_t q1 = d.find('\'');
  size_t q2 = d.find('\'', q1 + 1);
  info->descr = d.substr(q1 + 1, q2 - q1 - 1);
  info->fortran = find_val("'fortran_order'").find("True") != std::string::npos;

  std::string s = find_val("'shape'");
  size_t lp = s.find('(');
  size_t rp = s.find(')');
  std::string tup = s.substr(lp + 1, rp - lp - 1);
  int64_t v = 0;
  bool in_num = false;
  for (char c : tup) {
    if (c >= '0' && c <= '9') { v = v * 10 + (c - '0'); in_num = true; }
    else if (in_num) { info->shape.push_back(v); v = 0; in_num = false; }
  }
  if (in_num) info->shape.push_back(v);
  return true;
}

// f16 -> f32 (IEEE 754 half)
float half_to_float(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ffu;
  uint32_t out;
  if (exp == 0) {
    if (man == 0) { out = sign; }
    else {
      exp = 127 - 15 + 1;
      while ((man & 0x400u) == 0) { man <<= 1; exp--; }
      man &= 0x3ffu;
      out = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    out = sign | 0x7f800000u | (man << 13);
  } else {
    out = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float r;
  memcpy(&r, &out, 4);
  return r;
}

// Load one npy file as f32; returns element count or -1. If out==null, only
// shape probing is done.
int64_t load_npy_f32(const char* path, float* out, int64_t capacity,
                     int64_t* shape_out, int* ndim_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  if (!parse_npy_header(f, &info) || info.fortran) { fclose(f); return -1; }
  int64_t n = 1;
  for (int64_t s : info.shape) n *= s;
  if (ndim_out) *ndim_out = (int)info.shape.size();
  if (shape_out)
    for (size_t i = 0; i < info.shape.size() && i < 8; i++)
      shape_out[i] = info.shape[i];
  if (!out) { fclose(f); return n; }
  if (n > capacity) { fclose(f); return -1; }
  fseek(f, (long)info.data_offset, SEEK_SET);

  bool ok = true;
  if (info.descr == "<f4") {
    ok = fread(out, 4, n, f) == (size_t)n;
  } else if (info.descr == "<f8") {
    std::vector<double> tmp(n);
    ok = fread(tmp.data(), 8, n, f) == (size_t)n;
    for (int64_t i = 0; i < n; i++) out[i] = (float)tmp[i];
  } else if (info.descr == "<f2") {
    std::vector<uint16_t> tmp(n);
    ok = fread(tmp.data(), 2, n, f) == (size_t)n;
    for (int64_t i = 0; i < n; i++) out[i] = half_to_float(tmp[i]);
  } else if (info.descr == "<i2") {
    std::vector<int16_t> tmp(n);
    ok = fread(tmp.data(), 2, n, f) == (size_t)n;
    for (int64_t i = 0; i < n; i++) out[i] = (float)tmp[i];
  } else if (info.descr == "<i4") {
    std::vector<int32_t> tmp(n);
    ok = fread(tmp.data(), 4, n, f) == (size_t)n;
    for (int64_t i = 0; i < n; i++) out[i] = (float)tmp[i];
  } else {
    ok = false;
  }
  fclose(f);
  return ok ? n : -1;
}

}  // namespace

extern "C" {

// Probe: element count (and shape/ndim) without reading data.
int64_t taco_npy_size(const char* path, int64_t* shape_out, int* ndim_out) {
  return load_npy_f32(path, nullptr, 0, shape_out, ndim_out);
}

// Read one npy into caller-allocated f32 buffer.
int64_t taco_npy_read_f32(const char* path, float* out, int64_t capacity) {
  return load_npy_f32(path, out, capacity, nullptr, nullptr);
}

// Parallel batch read: n files into n caller-allocated buffers using a
// std::thread pool (no GIL). sizes[i] receives element count or -1.
void taco_npy_read_batch_f32(const char** paths, int n, float** outs,
                             const int64_t* capacities, int64_t* sizes,
                             int num_threads) {
  std::atomic<int> next(0);
  int nt = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int w = 0; w < nt; w++) {
    workers.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
        sizes[i] = load_npy_f32(paths[i], outs[i], capacities[i],
                                nullptr, nullptr);
      }
    });
  }
  for (auto& t : workers) t.join();
}

// mu-law companding (wavenet_vocoder/util.py:10-46): y = sign(x)·ln(1+mu|x|)/ln(1+mu)
void taco_mulaw(const float* x, float* y, int64_t n, float mu) {
  const float k = 1.0f / std::log1p(mu);
  for (int64_t i = 0; i < n; i++) {
    float v = x[i];
    float m = std::log1p(mu * std::fabs(v)) * k;
    y[i] = v < 0 ? -m : m;
  }
}

void taco_inv_mulaw(const float* y, float* x, int64_t n, float mu) {
  const float k = 1.0f / mu;
  for (int64_t i = 0; i < n; i++) {
    float v = y[i];
    float m = (std::pow(1.0f + mu, std::fabs(v)) - 1.0f) * k;
    x[i] = v < 0 ? -m : m;
  }
}

// mu-law quantize to [0, mu] ints (util.py:48-62). Truncation (not
// rounding) matches the reference _asint = .astype(int) semantics.
void taco_mulaw_quantize(const float* x, int32_t* y, int64_t n, float mu) {
  const float k = 1.0f / std::log1p(mu);
  for (int64_t i = 0; i < n; i++) {
    float v = x[i];
    float m = std::log1p(mu * std::fabs(v)) * k;
    m = v < 0 ? -m : m;
    y[i] = (int32_t)((m + 1.0f) / 2.0f * mu);
  }
}

// PCM16 WAV writer with the reference's peak normalization
// (audio.py:12-15: wav *= 32767 / max(0.01, max|wav|)).
int taco_wav_write_pcm16(const char* path, const float* wav, int64_t n,
                         int sample_rate, int normalize) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  float peak = 0.01f;
  if (normalize) {
    for (int64_t i = 0; i < n; i++) peak = std::max(peak, std::fabs(wav[i]));
  }
  float scale = normalize ? 32767.0f / peak : 32767.0f;

  uint32_t data_bytes = (uint32_t)(n * 2);
  uint32_t chunk = 36 + data_bytes;
  uint16_t fmt16 = 1, ch = 1, bits = 16;
  uint32_t byte_rate = sample_rate * 2;
  uint16_t block = 2;
  uint32_t sr = (uint32_t)sample_rate, fmt_size = 16;
  fwrite("RIFF", 1, 4, f); fwrite(&chunk, 4, 1, f); fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f); fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt16, 2, 1, f); fwrite(&ch, 2, 1, f); fwrite(&sr, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f); fwrite(&block, 2, 1, f); fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f); fwrite(&data_bytes, 4, 1, f);
  std::vector<int16_t> buf(n);
  for (int64_t i = 0; i < n; i++) {
    float v = wav[i] * scale;
    v = std::max(-32768.0f, std::min(32767.0f, v));
    buf[i] = (int16_t)lrintf(v);
  }
  fwrite(buf.data(), 2, n, f);
  fclose(f);
  return 0;
}

// PCM16 mono WAV reader -> float32 in [-1, 1]. Returns sample count or -1.
int64_t taco_wav_read_pcm16(const char* path, float* out, int64_t capacity,
                            int* sample_rate_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
      memcmp(hdr + 8, "WAVE", 4)) { fclose(f); return -1; }
  uint16_t channels = 1, bits = 16;
  uint32_t sr = 0;
  int64_t n = -1;
  for (;;) {
    unsigned char ch_hdr[8];
    if (fread(ch_hdr, 1, 8, f) != 8) break;
    uint32_t sz = ch_hdr[4] | (ch_hdr[5] << 8) | (ch_hdr[6] << 16) |
                  ((uint32_t)ch_hdr[7] << 24);
    if (!memcmp(ch_hdr, "fmt ", 4)) {
      unsigned char fmt[16];
      if (fread(fmt, 1, 16, f) != 16) break;
      channels = fmt[2] | (fmt[3] << 8);
      sr = fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) | ((uint32_t)fmt[7] << 24);
      bits = fmt[14] | (fmt[15] << 8);
      if (sz > 16) fseek(f, sz - 16, SEEK_CUR);
    } else if (!memcmp(ch_hdr, "data", 4)) {
      if (channels != 1 || bits != 16) { fclose(f); return -1; }
      n = sz / 2;
      if (!out) break;
      if (n > capacity) { fclose(f); return -1; }
      std::vector<int16_t> buf(n);
      if (fread(buf.data(), 2, n, f) != (size_t)n) { fclose(f); return -1; }
      for (int64_t i = 0; i < n; i++) out[i] = buf[i] / 32768.0f;
      break;
    } else {
      fseek(f, sz + (sz & 1), SEEK_CUR);
    }
  }
  fclose(f);
  if (sample_rate_out) *sample_rate_out = (int)sr;
  return n;
}

}  // extern "C"
