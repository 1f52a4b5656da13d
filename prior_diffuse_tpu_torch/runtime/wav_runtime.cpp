// Native data-plane runtime: WAV decode + crop + RMS-normalize batches.
//
// The reference's data hot loop is librosa.load + numpy per utterance in
// DataLoader worker processes (utils/dataset.py:121-130,
// utils/dataset.py:38-78).  This C++ runtime performs the same work —
// RIFF parse, PCM decode, channel fold, random crop, RMS normalization,
// zero-pad — in one call per batch with a worker thread pool, feeding
// the TPU input pipeline without Python-object overhead.
//
// Exposed C ABI (ctypes):
//   pdt_decode_wav(path, out, max_len) -> samples (or -errno)
//   pdt_wav_info(path, &sr, &samples)  -> 0 / -err
//   pdt_load_batch(paths, n, chunk, crop_starts, noisy_out, ...)
//
// Only the decode path lives here; resampling (rare: corpora are
// distributed at the target rate) falls back to the Python loader.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavData {
  std::vector<float> samples;  // mono float32
  int sample_rate = 0;
};

#pragma pack(push, 1)
struct RiffHeader {
  char riff[4];
  uint32_t size;
  char wave[4];
};
struct ChunkHeader {
  char id[4];
  uint32_t size;
};
struct FmtChunk {
  uint16_t format;
  uint16_t channels;
  uint32_t sample_rate;
  uint32_t byte_rate;
  uint16_t block_align;
  uint16_t bits;
};
#pragma pack(pop)

int decode_file(const char* path, WavData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  RiffHeader rh;
  if (std::fread(&rh, sizeof rh, 1, f) != 1 ||
      std::memcmp(rh.riff, "RIFF", 4) != 0 ||
      std::memcmp(rh.wave, "WAVE", 4) != 0) {
    std::fclose(f);
    return -2;
  }
  FmtChunk fmt{};
  bool have_fmt = false;
  std::vector<uint8_t> data;
  ChunkHeader ch;
  while (std::fread(&ch, sizeof ch, 1, f) == 1) {
    if (std::memcmp(ch.id, "fmt ", 4) == 0) {
      uint32_t n = ch.size < sizeof fmt ? ch.size : sizeof fmt;
      if (std::fread(&fmt, n, 1, f) != 1) break;
      if (ch.size > n) std::fseek(f, ch.size - n, SEEK_CUR);
      // WAVE_FORMAT_EXTENSIBLE: true format code sits at offset 24
      have_fmt = true;
    } else if (std::memcmp(ch.id, "data", 4) == 0) {
      data.resize(ch.size);
      if (ch.size && std::fread(data.data(), 1, ch.size, f) != ch.size) break;
      if (have_fmt) break;
    } else {
      std::fseek(f, ch.size + (ch.size & 1), SEEK_CUR);
      continue;
    }
    if (ch.size & 1) std::fseek(f, 1, SEEK_CUR);
  }
  std::fclose(f);
  if (!have_fmt || data.empty()) return -3;

  uint16_t format = fmt.format;
  if (format == 0xFFFE) format = 1;  // extensible: assume PCM subformat
  const uint16_t ch_n = fmt.channels ? fmt.channels : 1;
  size_t frames = 0;
  std::vector<float> mono;

  if (format == 1 && fmt.bits == 16) {
    const int16_t* p = reinterpret_cast<const int16_t*>(data.data());
    frames = data.size() / 2 / ch_n;
    mono.resize(frames);
    for (size_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (uint16_t c = 0; c < ch_n; ++c) acc += p[i * ch_n + c];
      mono[i] = acc / (ch_n * 32768.0f);
    }
  } else if (format == 1 && fmt.bits == 24) {
    frames = data.size() / 3 / ch_n;
    mono.resize(frames);
    const uint8_t* p = data.data();
    for (size_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (uint16_t c = 0; c < ch_n; ++c) {
        const uint8_t* s = p + (i * ch_n + c) * 3;
        int32_t v = s[0] | (s[1] << 8) | (s[2] << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        acc += static_cast<float>(v);
      }
      mono[i] = acc / (ch_n * 8388608.0f);
    }
  } else if (format == 1 && fmt.bits == 32) {
    const int32_t* p = reinterpret_cast<const int32_t*>(data.data());
    frames = data.size() / 4 / ch_n;
    mono.resize(frames);
    for (size_t i = 0; i < frames; ++i) {
      double acc = 0.0;
      for (uint16_t c = 0; c < ch_n; ++c) acc += p[i * ch_n + c];
      mono[i] = static_cast<float>(acc / (ch_n * 2147483648.0));
    }
  } else if (format == 3 && fmt.bits == 32) {
    const float* p = reinterpret_cast<const float*>(data.data());
    frames = data.size() / 4 / ch_n;
    mono.resize(frames);
    for (size_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (uint16_t c = 0; c < ch_n; ++c) acc += p[i * ch_n + c];
      mono[i] = acc / ch_n;
    }
  } else {
    return -4;  // unsupported encoding: Python fallback handles it
  }
  out->samples = std::move(mono);
  out->sample_rate = static_cast<int>(fmt.sample_rate);
  return 0;
}

}  // namespace

extern "C" {

// Decode one file into caller-provided buffer; returns sample count,
// negative on error. *sr_out receives the native sample rate.
long pdt_decode_wav(const char* path, float* out, long max_len, int* sr_out) {
  WavData w;
  int rc = decode_file(path, &w);
  if (rc != 0) return rc;
  *sr_out = w.sample_rate;
  long n = static_cast<long>(w.samples.size());
  if (n > max_len) n = max_len;
  std::memcpy(out, w.samples.data(), n * sizeof(float));
  return n;
}

long pdt_wav_info(const char* path, int* sr_out) {
  WavData w;
  int rc = decode_file(path, &w);
  if (rc != 0) return rc;
  *sr_out = w.sample_rate;
  return static_cast<long>(w.samples.size());
}

// Load a paired batch: decode noisy+clean, crop at crop_starts[i] (or
// from 0 when the file is shorter than chunk), RMS-normalize both by
// the noisy factor, zero-pad to chunk.  Returns 0 or the first error.
//
// Outputs: noisy/clean [n * chunk], frame_nums/wav_lens [n], scales [n].
int pdt_load_batch(const char** noisy_paths, const char** clean_paths,
                   int n, long chunk, const long* crop_starts,
                   int win_size, int fft_num, int win_shift,
                   int expect_sr, int num_threads,
                   float* noisy_out, float* clean_out,
                   int* frame_nums, int* wav_lens, float* scales) {
  std::atomic<int> next{0};
  std::atomic<int> err{0};

  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      WavData nz, cl;
      if (decode_file(noisy_paths[i], &nz) != 0 ||
          decode_file(clean_paths[i], &cl) != 0 ||
          nz.sample_rate != expect_sr || cl.sample_rate != expect_sr) {
        err.store(i + 1);
        continue;
      }
      long len = static_cast<long>(
          std::min(nz.samples.size(), cl.samples.size()));
      long start = 0;
      if (len > chunk) {
        start = crop_starts[i] % (len - chunk + 1);
        len = chunk;
      }
      const float* np_ = nz.samples.data() + start;
      const float* cp = cl.samples.data() + start;
      double energy = 0.0;
      for (long j = 0; j < len; ++j) energy += double(np_[j]) * np_[j];
      float c = energy > 0 ? static_cast<float>(std::sqrt(len / energy))
                           : 1.0f;
      float* no = noisy_out + static_cast<long>(i) * chunk;
      float* co = clean_out + static_cast<long>(i) * chunk;
      for (long j = 0; j < len; ++j) {
        no[j] = np_[j] * c;
        co[j] = cp[j] * c;
      }
      std::memset(no + len, 0, (chunk - len) * sizeof(float));
      std::memset(co + len, 0, (chunk - len) * sizeof(float));
      frame_nums[i] = static_cast<int>((len - win_size + fft_num) / win_shift + 1);
      wav_lens[i] = static_cast<int>(len);
      scales[i] = c;
    }
  };

  int workers = num_threads > 0 ? num_threads : 1;
  if (workers == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < workers; ++t) pool.emplace_back(work);
    for (auto& t : pool) t.join();
  }
  return err.load();
}

}  // extern "C"
