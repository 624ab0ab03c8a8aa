// hq_loader — native batch image loader + layout converters.
//
// C++ runtime component of hybridquantization: the equivalent
// of the reference's host-side image plumbing (Icy Sequence I/O +
// HybridQuantization.makeinline/makeChannels layout converters,
// HybridQuantization.java:95-125,279-309) and its multithreaded host worker
// pool (ImageManipulation.java:701-768). Decodes PNG (via zlib inflate +
// unfiltering) and PPM into float32 [0,1] HWC buffers with a std::thread
// pool, so large batches (BASELINE configs 4-5: 64-512 images) decode in
// parallel while the device computes.
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11 in
// this environment).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  std::vector<float> data;  // HWC, 3 channels, [0,1]
  std::string error;
};

// ---------------------------------------------------------------------------
// PPM (P6/P5)
// ---------------------------------------------------------------------------

bool read_file(const char* path, std::vector<uint8_t>& out) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return false;
  std::streamsize n = f.tellg();
  f.seekg(0);
  out.resize(static_cast<size_t>(n));
  return static_cast<bool>(f.read(reinterpret_cast<char*>(out.data()), n));
}

// Skip whitespace + '#' comments, parse a non-negative int.
bool pnm_token(const std::vector<uint8_t>& d, size_t& i, long& value) {
  while (i < d.size()) {
    if (isspace(d[i])) {
      ++i;
    } else if (d[i] == '#') {
      while (i < d.size() && d[i] != '\n') ++i;
    } else {
      break;
    }
  }
  if (i >= d.size() || !isdigit(d[i])) return false;
  value = 0;
  while (i < d.size() && isdigit(d[i])) value = value * 10 + (d[i++] - '0');
  return true;
}

Image decode_ppm(const std::vector<uint8_t>& d) {
  Image im;
  if (d.size() < 2 || d[0] != 'P' || (d[1] != '6' && d[1] != '5')) {
    im.error = "not a P6/P5 PNM";
    return im;
  }
  bool gray = d[1] == '5';
  size_t i = 2;
  long w, h, maxval;
  if (!pnm_token(d, i, w) || !pnm_token(d, i, h) || !pnm_token(d, i, maxval)) {
    im.error = "bad PNM header";
    return im;
  }
  ++i;  // single whitespace after maxval
  const int ch = gray ? 1 : 3;
  const size_t need = static_cast<size_t>(w) * h * ch * (maxval > 255 ? 2 : 1);
  if (d.size() - i < need) {
    im.error = "truncated PNM payload";
    return im;
  }
  im.width = static_cast<int>(w);
  im.height = static_cast<int>(h);
  im.data.resize(static_cast<size_t>(w) * h * 3);
  const float inv = 1.0f / static_cast<float>(maxval);
  for (size_t p = 0; p < static_cast<size_t>(w) * h; ++p) {
    float rgb[3];
    for (int c = 0; c < ch; ++c) {
      long v;
      if (maxval > 255) {
        v = (d[i + (p * ch + c) * 2] << 8) | d[i + (p * ch + c) * 2 + 1];
      } else {
        v = d[i + p * ch + c];
      }
      rgb[c] = static_cast<float>(v) * inv;
    }
    if (gray) rgb[1] = rgb[2] = rgb[0];
    std::memcpy(&im.data[p * 3], rgb, sizeof rgb);
  }
  return im;
}

// ---------------------------------------------------------------------------
// PNG (8/16-bit, gray/RGB/palette-less, no interlace)
// ---------------------------------------------------------------------------

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

Image decode_png(const std::vector<uint8_t>& d) {
  Image im;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (d.size() < 8 || std::memcmp(d.data(), sig, 8) != 0) {
    im.error = "not a PNG";
    return im;
  }
  size_t i = 8;
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // PLTE, 3 bytes/entry
  while (i + 8 <= d.size()) {
    uint32_t len = be32(&d[i]);
    if (i + 12 + len > d.size()) break;
    const char* type = reinterpret_cast<const char*>(&d[i + 4]);
    const uint8_t* body = &d[i + 8];
    if (!std::memcmp(type, "IHDR", 4)) {
      w = be32(body);
      h = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (!std::memcmp(type, "PLTE", 4)) {
      palette.assign(body, body + len);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    i += 12 + len;
  }
  if (!w || !h) {
    im.error = "bad IHDR";
    return im;
  }
  if (interlace) {
    im.error = "interlaced PNG unsupported";
    return im;
  }
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // RGB
    case 3: channels = 1; break;  // palette index
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // RGBA
    default:
      im.error = "unsupported PNG color type";
      return im;
  }
  const bool subbyte = bit_depth < 8;
  if (bit_depth != 8 && bit_depth != 16 && !(subbyte && color_type == 3)) {
    im.error = "unsupported PNG bit depth";
    return im;
  }
  // bytes per pixel for filtering; sub-byte palette rows filter per byte
  const int bypp = subbyte ? 1 : channels * bit_depth / 8;
  const size_t stride =
      subbyte ? (static_cast<size_t>(w) * bit_depth + 7) / 8
              : static_cast<size_t>(w) * bypp;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    im.error = "zlib inflate failed";
    return im;
  }

  // Undo per-scanline filters in place into `recon`.
  std::vector<uint8_t> recon(stride * h);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &recon[y * stride];
    const uint8_t* up = y ? &recon[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= static_cast<size_t>(bypp) ? dst[x - bypp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= static_cast<size_t>(bypp)) ? up[x - bypp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default:
          im.error = "bad PNG filter";
          return im;
      }
      dst[x] = static_cast<uint8_t>(v);
    }
  }

  // Unpack sub-byte palette indices to one byte per pixel.
  if (subbyte) {
    std::vector<uint8_t> unpacked(static_cast<size_t>(w) * h);
    const int per_byte = 8 / bit_depth;
    const uint8_t mask = static_cast<uint8_t>((1 << bit_depth) - 1);
    for (uint32_t y = 0; y < h; ++y) {
      for (uint32_t x = 0; x < w; ++x) {
        const uint8_t byte = recon[y * stride + x / per_byte];
        const int shift = 8 - bit_depth * (x % per_byte + 1);
        unpacked[static_cast<size_t>(y) * w + x] = (byte >> shift) & mask;
      }
    }
    recon.swap(unpacked);
  }

  im.width = static_cast<int>(w);
  im.height = static_cast<int>(h);
  im.data.resize(static_cast<size_t>(w) * h * 3);
  const float inv8 = 1.0f / 255.0f, inv16 = 1.0f / 65535.0f;
  for (size_t p = 0; p < static_cast<size_t>(w) * h; ++p) {
    float rgb[3];
    if (color_type == 3) {
      const uint8_t idx = recon[p];
      if (static_cast<size_t>(idx) * 3 + 2 >= palette.size()) {
        im.error = "palette index out of range";
        return im;
      }
      for (int c = 0; c < 3; ++c) rgb[c] = palette[idx * 3 + c] * inv8;
    } else if (bit_depth == 8) {
      const uint8_t* px = &recon[p * bypp];
      if (channels >= 3) {
        for (int c = 0; c < 3; ++c) rgb[c] = px[c] * inv8;
      } else {
        rgb[0] = rgb[1] = rgb[2] = px[0] * inv8;
      }
    } else {  // 16-bit big-endian
      const uint8_t* px = &recon[p * bypp];
      auto v16 = [&](int c) {
        return static_cast<float>((px[c * 2] << 8) | px[c * 2 + 1]) * inv16;
      };
      if (channels >= 3) {
        for (int c = 0; c < 3; ++c) rgb[c] = v16(c);
      } else {
        rgb[0] = rgb[1] = rgb[2] = v16(0);
      }
    }
    std::memcpy(&im.data[p * 3], rgb, sizeof rgb);
  }
  return im;
}

Image decode_file(const char* path) {
  Image im;
  std::vector<uint8_t> d;
  if (!read_file(path, d)) {
    im.error = std::string("cannot read ") + path;
    return im;
  }
  if (d.size() >= 8 && d[0] == 137 && d[1] == 'P') return decode_png(d);
  return decode_ppm(d);
}

}  // namespace

extern "C" {

// Probe an image's dimensions. Returns 0 on success.
int hq_image_size(const char* path, int* width, int* height) {
  Image im = decode_file(path);
  if (!im.error.empty()) return 1;
  *width = im.width;
  *height = im.height;
  return 0;
}

// Decode one image into a caller-allocated float32 HWC buffer of
// width*height*3 elements (dimensions must match hq_image_size).
int hq_load_image(const char* path, float* out, int width, int height) {
  Image im = decode_file(path);
  if (!im.error.empty() || im.width != width || im.height != height) return 1;
  std::memcpy(out, im.data.data(), im.data.size() * sizeof(float));
  return 0;
}

// Decode a batch of same-size images in parallel into (n, H, W, 3) float32.
// `paths` is a NUL-separated, double-NUL-terminated string list. Returns the
// number of images that FAILED (0 == all good); failed slots are zeroed.
int hq_load_batch(const char* paths, int n, float* out, int width, int height,
                  int num_threads) {
  std::vector<const char*> list;
  const char* p = paths;
  for (int k = 0; k < n; ++k) {
    list.push_back(p);
    p += std::strlen(p) + 1;
  }
  if (num_threads <= 0)
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (num_threads > n) num_threads = n;

  std::atomic<int> next{0}, failures{0};
  const size_t pixels = static_cast<size_t>(width) * height * 3;
  auto worker = [&] {
    for (;;) {
      const int k = next.fetch_add(1);
      if (k >= n) return;
      if (hq_load_image(list[k], out + pixels * k, width, height) != 0) {
        std::memset(out + pixels * k, 0, pixels * sizeof(float));
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Layout converters (HybridQuantization.java:279-309 parity, SIMD-friendly).

// (H*W, 3) HWC float -> planar [3][H*W]
void hq_hwc_to_planar(const float* in, float* out, long long npix) {
  for (long long p = 0; p < npix; ++p) {
    out[p] = in[p * 3];
    out[npix + p] = in[p * 3 + 1];
    out[2 * npix + p] = in[p * 3 + 2];
  }
}

// planar [3][H*W] -> (H*W, 3)
void hq_planar_to_hwc(const float* in, float* out, long long npix) {
  for (long long p = 0; p < npix; ++p) {
    out[p * 3] = in[p];
    out[p * 3 + 1] = in[npix + p];
    out[p * 3 + 2] = in[2 * npix + p];
  }
}

// float [0,1] -> u8 with round-half-up (reference UBYTE conversion,
// HybridQuantization.java:122)
void hq_float_to_u8(const float* in, unsigned char* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    float v = in[i] * 255.0f + 0.5f;
    out[i] = v <= 0.f ? 0 : v >= 255.f ? 255 : static_cast<unsigned char>(v);
  }
}

}  // extern "C"
