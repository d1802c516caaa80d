// The port's native data I/O: PNG scanlines to the dataset's float32 pixels,
// and the GIF writer's LZW coder.
//
// dataio_decode takes one image's inflated scanlines (Python reads the
// chunks and inflates the image data with zlib, which releases the GIL) and
// computes what the plain loader computes (nerf_tpu_torch/utils/png.py, then
// data/blender.py's _load_builtin): it undoes the five PNG filters, expands
// colour types 0, 2, 3 (with tRNS), 4 and 6 at 8 bits, or 16 bits by their
// high byte, to 8-bit RGB or RGBA, resamples it as Pillow's BILINEAR resize
// does (premultiplied RGBA, integer passes in 22-bit fixed point by the taps
// it is given), converts to float32 and composites over white.  Every
// arithmetic step is the plain version's, so the two agree bit for bit
// (built with -ffp-contract=off: no fused multiply-adds in the composite).
//
// dataio_lzw_encode is the GIF LZW coder of utils/gif.py's lzw_encode, byte
// for byte.
//
// ABI: plain C, loaded with ctypes; one call per image, no threads of its
// own (the loader runs the images on a thread pool).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kBadFilter = 1,
  kBadPaletteIndex = 2,
  kShortData = 3,
  kBadFormat = 4,
};

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the filter of every scanline: raw holds h rows of 1 + row_bytes.
int unfilter(const uint8_t* raw, int h, int64_t row_bytes, int bpp,
             uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + (int64_t)y * (row_bytes + 1);
    const int ftype = line[0];
    ++line;
    uint8_t* cur = out + (int64_t)y * row_bytes;
    const uint8_t* up = y ? cur - row_bytes : nullptr;
    for (int64_t i = 0; i < row_bytes; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (ftype) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return kBadFilter;
      }
      cur[i] = (uint8_t)((line[i] + pred) & 0xFF);
    }
  }
  return kOk;
}

// Unfiltered samples -> 8-bit RGB (has_alpha false) or RGBA, as the plain
// decoder's _expand.
int expand(const uint8_t* px, int w, int h, int depth, int ctype,
           const uint8_t* palette, int n_palette, const uint8_t* trns,
           int n_trns, bool has_alpha, uint8_t* out) {
  const int c = ctype == 0 ? 1 : ctype == 2 ? 3 : ctype == 3 ? 1
              : ctype == 4 ? 2 : 4;
  const int bytes = depth / 8;
  const int oc = has_alpha ? 4 : 3;
  // tRNS of grey or RGB: the transparent key's samples, 16 bits each
  int key[3] = {-1, -1, -1};
  const bool keyed = (ctype == 0 || ctype == 2) && n_trns >= 2 * c;
  if (keyed)
    for (int k = 0; k < c; ++k) key[k] = trns[2 * k] << 8 | trns[2 * k + 1];
  const int64_t n = (int64_t)w * h;
  for (int64_t p = 0; p < n; ++p) {
    const uint8_t* s = px + p * c * bytes;
    uint8_t* o = out + p * oc;
    int full[4];
    for (int k = 0; k < c; ++k)
      full[k] = bytes == 2 ? (s[2 * k] << 8 | s[2 * k + 1]) : s[k];
    const auto high = [&](int k) {
      return (uint8_t)(bytes == 2 ? full[k] >> 8 : full[k]);
    };
    if (ctype == 3) {
      const int idx = full[0];
      if (idx >= n_palette) return kBadPaletteIndex;
      o[0] = palette[3 * idx];
      o[1] = palette[3 * idx + 1];
      o[2] = palette[3 * idx + 2];
      if (has_alpha) o[3] = idx < n_trns ? trns[idx] : 255;
      continue;
    }
    const bool grey = ctype == 0 || ctype == 4;
    for (int k = 0; k < 3; ++k) o[k] = high(grey ? 0 : k);
    if (ctype == 4 || ctype == 6) {
      o[3] = high(c - 1);
    } else if (has_alpha) {
      bool hit = keyed;
      for (int k = 0; k < c; ++k) hit = hit && full[k] == key[k];
      o[3] = hit ? 0 : 255;
    }
  }
  return kOk;
}

constexpr int kPrecisionBits = 22;   // Pillow's 8-bit fixed point

// One 8-bit pass of Pillow's resampling along an axis: out[o] = clamp((2^21
// + sum_k w[o][k] * in[min(lo[o] + k, n_in - 1)]) >> 22, 0, 255), integer
// sums (exact in any order).  `in` holds `outer` blocks of n_in positions
// of `inner` contiguous values each.
void resample8(const uint8_t* in, uint8_t* out, int n_in, int n_out,
               const int32_t* lo, const int32_t* w, int k_taps, int64_t outer,
               int64_t inner) {
  std::vector<int64_t> acc((size_t)inner);
  for (int64_t b = 0; b < outer; ++b) {
    const uint8_t* src = in + b * n_in * inner;
    uint8_t* dst = out + b * n_out * inner;
    for (int o = 0; o < n_out; ++o) {
      std::fill(acc.begin(), acc.end(), (int64_t)1 << (kPrecisionBits - 1));
      for (int k = 0; k < k_taps; ++k) {
        int i = lo[o] + k;
        if (i > n_in - 1) i = n_in - 1;
        const int64_t wk = w[(int64_t)o * k_taps + k];
        const uint8_t* s = src + (int64_t)i * inner;
        for (int64_t v = 0; v < inner; ++v) acc[v] += wk * s[v];
      }
      uint8_t* d = dst + (int64_t)o * inner;
      for (int64_t v = 0; v < inner; ++v) {
        const int64_t r = acc[v] >> kPrecisionBits;
        d[v] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
      }
    }
  }
}

}  // namespace

extern "C" {

// One image.  raw: h rows of 1 + w * bpp filtered bytes; palette (n_palette
// entries of 3) and trns (n_trns bytes, the tRNS chunk) as in the file.
// white_bkg: decode to RGBA (adding opaque alpha) and composite over white,
// else to RGB.  lo_y/w_y (out_h x k_y) and lo_x/w_x (out_w x k_x): the
// fixed-point resampling taps of each axis, null for an axis whose size
// does not change (both null: no resampling).  Writes out[out_h * out_w *
// 3].  Returns 0, or a Status.
int dataio_decode(const uint8_t* raw, int64_t raw_len, int w, int h, int depth,
                  int ctype, const uint8_t* palette, int n_palette,
                  const uint8_t* trns, int n_trns, int white_bkg,
                  const int32_t* lo_y, const int32_t* w_y, int k_y,
                  const int32_t* lo_x, const int32_t* w_x, int k_x, int out_h,
                  int out_w, float* out) {
  if ((depth != 8 && depth != 16) || ctype == 1 || ctype == 5 || ctype > 6 ||
      (ctype == 3 && depth != 8))
    return kBadFormat;
  const int c = ctype == 0 ? 1 : ctype == 2 ? 3 : ctype == 3 ? 1
              : ctype == 4 ? 2 : 4;
  const int bpp = c * depth / 8;
  const int64_t row_bytes = (int64_t)w * bpp;
  if (raw_len < (int64_t)h * (row_bytes + 1)) return kShortData;
  std::vector<uint8_t> px((size_t)(h * row_bytes));
  int st = unfilter(raw, h, row_bytes, bpp, px.data());
  if (st != kOk) return st;
  const bool has_alpha = ctype == 4 || ctype == 6 || n_trns > 0;
  const int fc = has_alpha ? 4 : 3;
  std::vector<uint8_t> img((size_t)w * h * fc);
  st = expand(px.data(), w, h, depth, ctype, palette, n_palette, trns, n_trns,
              has_alpha, img.data());
  if (st != kOk) return st;

  // the mode: RGBA under white_bkg (opaque alpha added), else RGB
  const int mc = white_bkg ? 4 : 3;
  const int64_t n_in = (int64_t)w * h;
  std::vector<uint8_t> u8((size_t)n_in * mc);
  for (int64_t p = 0; p < n_in; ++p)
    for (int k = 0; k < mc; ++k)
      u8[p * mc + k] = k < 3 ? img[p * fc + k]
                             : (fc == 4 ? img[p * fc + 3] : 255);
  if (lo_x || lo_y) {
    // Pillow resizes RGBA premultiplied to 8 bits, horizontally first
    if (mc == 4)
      for (int64_t p = 0; p < n_in; ++p) {
        const unsigned a = u8[p * 4 + 3];
        for (int k = 0; k < 3; ++k) {
          const unsigned t = u8[p * 4 + k] * a + 128;
          u8[p * 4 + k] = (uint8_t)(((t >> 8) + t) >> 8);
        }
      }
    int cur_w = w, cur_h = h;
    if (lo_x) {
      std::vector<uint8_t> next((size_t)h * out_w * mc);
      resample8(u8.data(), next.data(), w, out_w, lo_x, w_x, k_x, h, mc);
      u8.swap(next);
      cur_w = out_w;
    }
    if (lo_y) {
      std::vector<uint8_t> next((size_t)out_h * cur_w * mc);
      resample8(u8.data(), next.data(), h, out_h, lo_y, w_y, k_y, 1,
                (int64_t)cur_w * mc);
      u8.swap(next);
      cur_h = out_h;
    }
    if (cur_h != out_h || cur_w != out_w) return kBadFormat;
    if (mc == 4)
      for (int64_t p = 0; p < (int64_t)out_h * out_w; ++p) {
        const int a = u8[p * 4 + 3];
        if (a == 0 || a == 255) continue;
        for (int k = 0; k < 3; ++k) {
          const int v = 255 * u8[p * 4 + k] / a;
          u8[p * 4 + k] = (uint8_t)(v > 255 ? 255 : v);
        }
      }
  } else if (out_h != h || out_w != w) {
    return kBadFormat;
  }
  const int64_t n_out = (int64_t)out_h * out_w;
  for (int64_t p = 0; p < n_out; ++p) {
    const uint8_t* s = u8.data() + p * mc;
    float* o = out + p * 3;
    if (mc == 4) {
      const float a = (float)s[3] / 255.0f;
      for (int k = 0; k < 3; ++k) {
        const float f = (float)s[k] / 255.0f;
        const float fa = f * a;
        o[k] = fa + (1.0f - a);
      }
    } else {
      for (int k = 0; k < 3; ++k) o[k] = (float)s[k] / 255.0f;
    }
  }
  return kOk;
}

// GIF LZW of n 8-bit indices (minimum code size 8): a clear code first,
// codes widened as the decoder widens them, a clear code when the table is
// full (4096 codes), the end code last; packed least significant bit first
// into out.  Returns the bytes written, or -1 when cap is too small.
int64_t dataio_lzw_encode(const uint8_t* idx, int64_t n, uint8_t* out,
                          int64_t cap) {
  const int kClear = 256, kEnd = 257, kFirst = 258, kMax = 4096;
  std::vector<int16_t> table((size_t)kMax * 256, -1);
  int64_t pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;
  const auto emit = [&](int code, int width) {
    acc |= (uint64_t)code << nbits;
    nbits += width;
    while (nbits >= 8) {
      if (pos < cap) out[pos] = (uint8_t)(acc & 0xFF);
      else overflow = true;
      ++pos;
      acc >>= 8;
      nbits -= 8;
    }
  };
  const auto bit_length = [](int v) {
    int b = 0;
    while (v) { ++b; v >>= 1; }
    return b;
  };
  int width = 9, next = kFirst;
  emit(kClear, width);
  if (n > 0) {
    int prefix = idx[0];
    for (int64_t i = 1; i < n; ++i) {
      const int c = idx[i];
      const int16_t code = table[(size_t)prefix * 256 + c];
      if (code >= 0) {
        prefix = code;
        continue;
      }
      emit(prefix, width);
      table[(size_t)prefix * 256 + c] = (int16_t)next;
      ++next;
      if (next - 1 == (1 << width)) ++width;
      if (next == kMax) {
        emit(kClear, width);
        std::fill(table.begin(), table.end(), (int16_t)-1);
        next = kFirst;
        width = 9;
      }
      prefix = c;
    }
    emit(prefix, width);
  }
  const int end_width = bit_length(next) > 12 ? 12
                      : bit_length(next) < 9 ? 9 : bit_length(next);
  emit(kEnd, end_width);
  if (nbits > 0) emit(0, 8 - nbits);
  return overflow ? -1 : pos;
}

}  // extern "C"
