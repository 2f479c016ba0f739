// Native WAV decode for the data path (the port's copy of
// isp_tts_tpu/native/src/wavio.cc, the same code).
//
// Parses RIFF/WAVE, converts PCM 8/16/24/32 and IEEE-float32 payloads to
// mono float32 in [-1, 1], and decodes a whole batch of files on a
// std::thread pool, so the loader's WAV decode does not hold the Python
// interpreter.
//
// Conversion semantics match data/audio.py:read_wav exactly:
//   i16 / 32768, i24 / 2^23, i32 / 2^31, (u8 - 128) / 128, f32 passthrough;
//   mono mixdown = float32 mean over channels (channel-major accumulation).
//
// Plain C ABI for ctypes; built on first use by
// isp_tts_tpu_torch/native/__init__.py with g++.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kErrOpen = -1;       // file missing / unreadable
constexpr int kErrFormat = -2;     // not a RIFF/WAVE or no fmt/data chunk
constexpr int kErrCodec = -3;      // compressed / unsupported sample format
constexpr int kErrAlloc = -4;      // out of memory

struct Decoded {
  float* samples = nullptr;  // mono, malloc'd; caller frees via wav_free
  int64_t n = 0;             // sample count
  int32_t rate = 0;
  int32_t err = 0;           // 0 ok, else kErr*
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8));
}

// Convert one interleaved frame payload to mono f32. `stride` = bytes per
// sample, `ch` = channel count. Accumulate the channel sum in float32 to
// match numpy's float32 mean (axis=0 over a float32 array).
template <typename ReadFn>
void to_mono(const uint8_t* data, int64_t frames, int ch, int stride,
             float inv_scale, float* out, ReadFn read_one) {
  const float inv_ch = 1.0f / (float)ch;
  for (int64_t i = 0; i < frames; ++i) {
    const uint8_t* f = data + (int64_t)i * ch * stride;
    float acc = 0.0f;
    for (int c = 0; c < ch; ++c) acc += read_one(f + c * stride) * inv_scale;
    out[i] = (ch == 1) ? acc : acc * inv_ch;
  }
}

Decoded decode_file(const char* path) {
  Decoded d;
  FILE* fp = std::fopen(path, "rb");
  if (!fp) {
    d.err = kErrOpen;
    return d;
  }
  std::fseek(fp, 0, SEEK_END);
  long fsize = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  if (fsize < 44) {
    std::fclose(fp);
    d.err = kErrFormat;
    return d;
  }
  std::vector<uint8_t> buf((size_t)fsize);
  size_t got = std::fread(buf.data(), 1, (size_t)fsize, fp);
  std::fclose(fp);
  if (got != (size_t)fsize || std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0) {
    d.err = kErrFormat;
    return d;
  }

  // Chunk walk: find fmt and data. Chunks are word-aligned (odd sizes pad).
  uint16_t fmt_tag = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  uint64_t data_len = 0;
  size_t off = 12;
  while (off + 8 <= (size_t)fsize) {
    const uint8_t* hdr = buf.data() + off;
    uint32_t csize = rd_u32(hdr + 4);
    size_t body = off + 8;
    if (body + csize > (size_t)fsize) csize = (uint32_t)((size_t)fsize - body);
    if (std::memcmp(hdr, "fmt ", 4) == 0 && csize >= 16) {
      fmt_tag = rd_u16(buf.data() + body);
      channels = rd_u16(buf.data() + body + 2);
      rate = rd_u32(buf.data() + body + 4);
      bits = rd_u16(buf.data() + body + 14);
      if (fmt_tag == 0xFFFE && csize >= 40) {
        // WAVE_FORMAT_EXTENSIBLE: real format is the first 2 bytes of the
        // 16-byte SubFormat GUID at offset 24.
        fmt_tag = rd_u16(buf.data() + body + 24);
      }
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      data = buf.data() + body;
      data_len = csize;
    }
    off = body + csize + (csize & 1);
  }
  if (!rate || !channels || !bits || !data) {
    d.err = kErrFormat;
    return d;
  }
  const bool is_pcm = (fmt_tag == 1);
  const bool is_f32 = (fmt_tag == 3 && bits == 32);
  if (!is_pcm && !is_f32) {
    d.err = kErrCodec;
    return d;
  }
  if (is_pcm && bits != 8 && bits != 16 && bits != 24 && bits != 32) {
    d.err = kErrCodec;
    return d;
  }
  const int stride = bits / 8;
  const int64_t frames = (int64_t)(data_len / ((uint64_t)stride * channels));
  float* out = (float*)std::malloc(sizeof(float) * (size_t)(frames > 0 ? frames : 1));
  if (!out) {
    d.err = kErrAlloc;
    return d;
  }

  const int ch = channels;
  if (is_f32) {
    to_mono(data, frames, ch, 4, 1.0f, out, [](const uint8_t* p) {
      float v;
      std::memcpy(&v, p, 4);
      return v;
    });
  } else if (bits == 16) {
    to_mono(data, frames, ch, 2, 1.0f / 32768.0f, out, [](const uint8_t* p) {
      int16_t v;
      std::memcpy(&v, p, 2);
      return (float)v;
    });
  } else if (bits == 24) {
    to_mono(data, frames, ch, 3, 1.0f / 8388608.0f, out, [](const uint8_t* p) {
      int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      return (float)v;
    });
  } else if (bits == 32) {
    to_mono(data, frames, ch, 4, 1.0f / 2147483648.0f, out,
            [](const uint8_t* p) {
              int32_t v;
              std::memcpy(&v, p, 4);
              return (float)v;
            });
  } else {  // 8-bit unsigned
    to_mono(data, frames, ch, 1, 1.0f / 128.0f, out, [](const uint8_t* p) {
      return (float)*p - 128.0f;
    });
  }

  d.samples = out;
  d.n = frames;
  d.rate = (int32_t)rate;
  return d;
}

}  // namespace

extern "C" {

// Decode one file. On success returns the sample count and fills *out
// (malloc'd mono f32, free with wav_free) and *sample_rate. On failure
// returns a negative kErr* code.
int64_t wav_decode_mono(const char* path, float** out, int32_t* sample_rate) {
  Decoded d = decode_file(path);
  if (d.err) return d.err;
  *out = d.samples;
  *sample_rate = d.rate;
  return d.n;
}

void wav_free(float* p) { std::free(p); }

// Decode `n` files on up to `n_threads` worker threads. Per file i:
// outs[i] (malloc'd), lens[i], rates[i], errs[i] (0 ok / kErr*). Returns
// the number of failures.
int32_t wav_decode_batch(const char** paths, int32_t n, int32_t n_threads,
                         float** outs, int64_t* lens, int32_t* rates,
                         int32_t* errs) {
  if (n <= 0) return 0;
  int workers = n_threads;
  unsigned hw = std::thread::hardware_concurrency();
  if (workers <= 0) workers = hw ? (int)hw : 4;
  if (workers > n) workers = n;

  std::atomic<int32_t> next(0), failures(0);
  auto run = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      Decoded d = decode_file(paths[i]);
      outs[i] = d.samples;
      lens[i] = d.n;
      rates[i] = d.rate;
      errs[i] = d.err;
      if (d.err) failures.fetch_add(1);
    }
  };
  if (workers == 1) {
    run();
  } else {
    std::vector<std::thread> pool;
    pool.reserve((size_t)workers);
    for (int t = 0; t < workers; ++t) pool.emplace_back(run);
    for (auto& t : pool) t.join();
  }
  return failures.load();
}

// Version/ABI stamp so the Python side can verify it loaded the build it
// compiled (stale .so detection is by source hash in the filename, this is
// a belt-and-braces runtime check).
int32_t wavio_abi_version(void) { return 1; }

}  // extern "C"
