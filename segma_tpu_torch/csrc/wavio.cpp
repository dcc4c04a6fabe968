// WAV reader: RIFF parsing and ranged PCM decode, with a C interface for
// ctypes (segma_tpu_torch/utils/native.py); the port's copy of
// native/wavio.cpp. It provides:
//   - a header probe (wavio_probe)
//   - a ranged float32 decode of int16/24/32 and float32/64 samples
//     (wavio_read_range)
//   - the int16 fast path, no conversion (wavio_read_pcm16)
//   - a threaded batch decode of many files (wavio_read_batch_pcm16)
//
// Built at first use with the host C++ compiler into
// segma_tpu_torch/_build/libsegmawav.so (segma_tpu_torch/ops/_build.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavLayout {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float
  uint64_t data_offset = 0;
  uint64_t data_size = 0;
};

constexpr uint16_t kPcm = 1;
constexpr uint16_t kFloat = 3;
constexpr uint16_t kExtensible = 0xFFFE;

bool parse_header(FILE* f, WavLayout* out) {
  unsigned char riff[12];
  if (fread(riff, 1, 12, f) != 12) return false;
  if (memcmp(riff, "RIFF", 4) != 0 || memcmp(riff + 8, "WAVE", 4) != 0)
    return false;
  bool have_fmt = false;
  unsigned char hdr[8];
  while (fread(hdr, 1, 8, f) == 8) {
    uint32_t size;
    memcpy(&size, hdr + 4, 4);
    if (memcmp(hdr, "fmt ", 4) == 0) {
      // 16 bytes is the minimum valid PCM fmt chunk; a smaller size would
      // make the field reads below run past the buffer, and an absurd one
      // (e.g. a corrupt 0xFFFFFFFF) would try a 4 GB allocation
      if (size < 16 || size > (1u << 20)) return false;
      std::vector<unsigned char> body(size);
      if (fread(body.data(), 1, size, f) != size) return false;
      memcpy(&out->format, body.data() + 0, 2);
      memcpy(&out->channels, body.data() + 2, 2);
      memcpy(&out->sample_rate, body.data() + 4, 4);
      memcpy(&out->bits, body.data() + 14, 2);
      if (out->format == kExtensible && size >= 40)
        memcpy(&out->format, body.data() + 24, 2);
      // sub-byte encodings (e.g. 4-bit ADPCM) would give bytes-per-frame 0
      // and a SIGFPE at the data_size/bpf divisions below — reject here so
      // callers get the same -2 a corrupt header gets
      if (out->bits < 8 || out->bits % 8 != 0) return false;
      have_fmt = true;
    } else if (memcmp(hdr, "data", 4) == 0) {
      if (!have_fmt) return false;
      out->data_offset = static_cast<uint64_t>(ftell(f));
      // clamp the CLAIMED chunk size to the bytes actually present: a
      // tiny file claiming a 4 GB data chunk would otherwise make every
      // caller (and wavio_read_range's staging vector) size buffers off
      // the claim — gigabytes of allocation from a 100-byte upload
      fseek(f, 0, SEEK_END);
      const uint64_t fsz = static_cast<uint64_t>(ftell(f));
      const uint64_t avail =
          fsz > out->data_offset ? fsz - out->data_offset : 0;
      out->data_size = size < avail ? size : avail;
      return true;
    } else {
      fseek(f, static_cast<long>(size + (size & 1)), SEEK_CUR);
    }
  }
  return false;
}

inline int32_t sign_extend_24(uint32_t v) {
  return static_cast<int32_t>(v << 8) >> 8;
}

}  // namespace

extern "C" {

// Probe a WAV header. Returns 0 on success.
// out: [sample_rate, channels, bits, format, n_frames]
int wavio_probe(const char* path, int64_t out[5]) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavLayout lay;
  bool ok = parse_header(f, &lay);
  fclose(f);
  if (!ok || lay.channels == 0 || lay.bits == 0) return -2;
  const uint64_t bpf = static_cast<uint64_t>(lay.channels) * lay.bits / 8;
  out[0] = lay.sample_rate;
  out[1] = lay.channels;
  out[2] = lay.bits;
  out[3] = lay.format;
  out[4] = static_cast<int64_t>(lay.data_size / bpf);
  return 0;
}

// Decode frames [start, start+n) of all channels into interleaved float32.
// Returns number of frames decoded, negative on error.
int64_t wavio_read_range(const char* path, int64_t start, int64_t n,
                         float* dst) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavLayout lay;
  if (!parse_header(f, &lay)) {
    fclose(f);
    return -2;
  }
  const uint64_t bpf = static_cast<uint64_t>(lay.channels) * lay.bits / 8;
  const int64_t total = static_cast<int64_t>(lay.data_size / bpf);
  if (start < 0) start = 0;
  if (start > total) start = total;
  if (n < 0 || start + n > total) n = total - start;
  fseek(f, static_cast<long>(lay.data_offset + start * bpf), SEEK_SET);
  std::vector<unsigned char> raw(static_cast<size_t>(n) * bpf);
  const size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  const int64_t frames = static_cast<int64_t>(got / bpf);
  const int64_t samples = frames * lay.channels;
  const unsigned char* p = raw.data();
  if (lay.format == kPcm && lay.bits == 16) {
    const int16_t* s = reinterpret_cast<const int16_t*>(p);
    for (int64_t i = 0; i < samples; ++i) dst[i] = s[i] / 32768.0f;
  } else if (lay.format == kPcm && lay.bits == 32) {
    const int32_t* s = reinterpret_cast<const int32_t*>(p);
    for (int64_t i = 0; i < samples; ++i) dst[i] = s[i] / 2147483648.0f;
  } else if (lay.format == kPcm && lay.bits == 24) {
    for (int64_t i = 0; i < samples; ++i) {
      uint32_t v = p[3 * i] | (p[3 * i + 1] << 8) | (p[3 * i + 2] << 16);
      dst[i] = sign_extend_24(v) / 8388608.0f;
    }
  } else if (lay.format == kFloat && lay.bits == 32) {
    memcpy(dst, p, static_cast<size_t>(samples) * 4);
  } else if (lay.format == kFloat && lay.bits == 64) {
    const double* s = reinterpret_cast<const double*>(p);
    for (int64_t i = 0; i < samples; ++i) dst[i] = static_cast<float>(s[i]);
  } else {
    return -3;
  }
  return frames;
}

// Zero-copy fast path: raw int16 samples of a mono PCM16 file.
// Returns frames read, negative when the file is not mono PCM16.
int64_t wavio_read_pcm16(const char* path, int64_t start, int64_t n,
                         int16_t* dst) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavLayout lay;
  if (!parse_header(f, &lay)) {
    fclose(f);
    return -2;
  }
  if (lay.format != kPcm || lay.bits != 16 || lay.channels != 1) {
    fclose(f);
    return -3;
  }
  const int64_t total = static_cast<int64_t>(lay.data_size / 2);
  if (start < 0) start = 0;
  if (start > total) start = total;
  if (n < 0 || start + n > total) n = total - start;
  fseek(f, static_cast<long>(lay.data_offset + start * 2), SEEK_SET);
  const size_t got = fread(dst, 2, static_cast<size_t>(n), f);
  fclose(f);
  return static_cast<int64_t>(got);
}

// Threaded batch decode of mono PCM16 files into one int16 matrix
// (n_files x max_frames, zero-padded). lengths[i] receives per-file frames.
// Returns 0 on success, or the first file's error code.
int wavio_read_batch_pcm16(const char** paths, int64_t n_files,
                           int64_t max_frames, int16_t* dst,
                           int64_t* lengths, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int> errs(static_cast<size_t>(n_files), 0);
  auto work = [&](int64_t tid) {
    for (int64_t i = tid; i < n_files; i += n_threads) {
      int16_t* row = dst + i * max_frames;
      memset(row, 0, static_cast<size_t>(max_frames) * 2);
      const int64_t got = wavio_read_pcm16(paths[i], 0, max_frames, row);
      if (got < 0) {
        errs[static_cast<size_t>(i)] = static_cast<int>(got);
        lengths[i] = 0;
      } else {
        lengths[i] = got;
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
  for (auto& t : threads) t.join();
  for (int e : errs)
    if (e != 0) return e;
  return 0;
}

}  // extern "C"
