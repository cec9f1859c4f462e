// Animated GIF writer and reader (host), for the render CLI's video.gif.
//
// gif_write: every frame reduced to its own adaptive palette of at most 256
// colours (its own colours when it has 256 or fewer; else median cut over
// a 6-bit-per-channel histogram that keeps each cell's exact pixel sums,
// each box's colour the mean of its pixels; each pixel then takes its
// nearest palette colour, exactly, by a search of the palette sorted by
// green), LZW-coded (minimum code size 8,
// variable-width codes up to 12 bits, a clear code when the table is
// full), written as GIF89a with a NETSCAPE2.0 loop count and a delay per
// frame. Frames are reduced and coded in parallel, one thread a frame.
//
// gif_info / gif_decode read a GIF back (any GIF89a/87a without
// interlacing: global or local tables, frames at offsets drawn onto the
// canvas, transparent pixels keeping it, disposal 2 clearing a frame's
// area), to check a written file where no other reader is installed.
//
// Exposed via ctypes (data/gif.py). The functions return 0, or 2 with a
// message in err.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kBits = 6;
constexpr int kCells = 1 << (3 * kBits);

struct Cell {
  int64_t count, r, g, b;
};

struct Box {
  std::vector<int32_t> cells;  // occupied cell ids
  int64_t count;
  int lo[3], hi[3];
  void bound(const std::vector<Cell>& hist) {
    count = 0;
    for (int k = 0; k < 3; ++k) lo[k] = 1 << kBits, hi[k] = -1;
    for (int32_t c : cells) {
      count += hist[c].count;
      int q[3] = {c >> (2 * kBits), (c >> kBits) & ((1 << kBits) - 1),
                  c & ((1 << kBits) - 1)};
      for (int k = 0; k < 3; ++k) {
        lo[k] = std::min(lo[k], q[k]);
        hi[k] = std::max(hi[k], q[k]);
      }
    }
  }
  int axis() const {
    int a = 0;
    for (int k = 1; k < 3; ++k)
      if (hi[k] - lo[k] > hi[a] - lo[a]) a = k;
    return a;
  }
  double score() const {
    int r = hi[axis()] - lo[axis()];
    return cells.size() > 1 ? (double)count * r * r : -1.0;
  }
};

inline int cell_of(const uint8_t* p) {
  return ((p[0] >> (8 - kBits)) << (2 * kBits)) |
         ((p[1] >> (8 - kBits)) << kBits) | (p[2] >> (8 - kBits));
}

// the frame's colours when there are 256 or fewer, else empty
std::vector<uint8_t> few_colours(const uint8_t* px, int64_t n) {
  const int slots = 1024;
  int32_t seen[slots];
  std::fill(seen, seen + slots, -1);
  std::vector<uint8_t> pal;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = px + 3 * i;
    int32_t key = (p[0] << 16) | (p[1] << 8) | p[2];
    uint32_t h = ((uint32_t)key * 2654435761u) >> 22;
    while (seen[h] != -1 && seen[h] != key) h = (h + 1) & (slots - 1);
    if (seen[h] == key) continue;
    if (pal.size() == 256 * 3) return {};
    seen[h] = key;
    pal.insert(pal.end(), p, p + 3);
  }
  return pal;
}

// the frame's own colours, or median cut -> palette (<= 256 colours, rgb
// triples)
std::vector<uint8_t> palette_of(const uint8_t* px, int64_t n,
                                std::vector<Cell>& hist) {
  std::vector<uint8_t> exact = few_colours(px, n);
  if (!exact.empty()) return exact;
  std::fill(hist.begin(), hist.end(), Cell{0, 0, 0, 0});
  std::vector<int32_t> occupied;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = px + 3 * i;
    Cell& c = hist[cell_of(p)];
    if (c.count == 0) occupied.push_back(cell_of(p));
    c.count += 1;
    c.r += p[0];
    c.g += p[1];
    c.b += p[2];
  }
  std::vector<Box> boxes(1);
  boxes[0].cells = std::move(occupied);
  boxes[0].bound(hist);
  while (boxes.size() < 256) {
    int best = -1;
    double bs = 0.0;
    for (size_t i = 0; i < boxes.size(); ++i) {
      double s = boxes[i].score();
      if (s > bs) bs = s, best = (int)i;
    }
    if (best < 0) break;  // every box is one cell
    Box& b = boxes[best];
    // split by a plane across the longest axis at the median pixel,
    // both halves non-empty
    int a = b.axis(), shift = (2 - a) * kBits, mask = (1 << kBits) - 1;
    int64_t along[1 << kBits] = {0};
    for (int32_t c : b.cells) along[(c >> shift) & mask] += hist[c].count;
    int cut = b.lo[a];
    for (int64_t acc = along[cut]; cut < b.hi[a] - 1 && 2 * acc < b.count;)
      acc += along[++cut];
    Box other;
    std::vector<int32_t> keep;
    for (int32_t c : b.cells)
      (((c >> shift) & mask) <= cut ? keep : other.cells).push_back(c);
    b.cells.swap(keep);
    b.bound(hist);
    other.bound(hist);
    boxes.push_back(std::move(other));
  }
  std::vector<uint8_t> pal;
  for (const Box& b : boxes) {
    int64_t s[3] = {0, 0, 0};
    for (int32_t c : b.cells) {
      s[0] += hist[c].r;
      s[1] += hist[c].g;
      s[2] += hist[c].b;
    }
    for (int k = 0; k < 3; ++k)
      pal.push_back((uint8_t)((s[k] + b.count / 2) / b.count));
  }
  return pal;
}

// nearest palette index of every pixel (squared RGB distance, ties to the
// lower index of the green-sorted palette), palette reordered by green
std::vector<uint8_t> map_pixels(const uint8_t* px, int64_t n,
                                std::vector<uint8_t>& pal) {
  int m = (int)pal.size() / 3;
  std::vector<int> order(m);
  for (int i = 0; i < m; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return pal[3 * a + 1] < pal[3 * b + 1];
  });
  std::vector<uint8_t> sorted(pal.size());
  for (int i = 0; i < m; ++i)
    std::memcpy(&sorted[3 * i], &pal[3 * order[i]], 3);
  pal.swap(sorted);
  std::vector<uint8_t> idx(n);
  int last = -1;
  uint8_t lastp[3] = {0, 0, 0};
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = px + 3 * i;
    if (last >= 0 && p[0] == lastp[0] && p[1] == lastp[1] &&
        p[2] == lastp[2]) {
      idx[i] = (uint8_t)last;
      continue;
    }
    int lo = 0, hi = m;
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if (pal[3 * mid + 1] < p[1]) lo = mid + 1; else hi = mid;
    }
    int best = -1, bd = 1 << 30;
    auto test = [&](int j) {
      int dr = pal[3 * j] - p[0], dg = pal[3 * j + 1] - p[1],
          db = pal[3 * j + 2] - p[2];
      int d = dr * dr + dg * dg + db * db;
      if (d < bd || (d == bd && j < best)) bd = d, best = j;
    };
    for (int j = lo; j < m; ++j) {
      int dg = pal[3 * j + 1] - p[1];
      if (dg * dg > bd) break;
      test(j);
    }
    for (int j = lo - 1; j >= 0; --j) {
      int dg = pal[3 * j + 1] - p[1];
      if (dg * dg > bd) break;
      test(j);
    }
    idx[i] = (uint8_t)best;
    last = best;
    std::memcpy(lastp, p, 3);
  }
  return idx;
}

// LZW, GIF flavour, into 255-byte sub-blocks
void lzw_encode(const std::vector<uint8_t>& idx, std::vector<uint8_t>& out) {
  const int min_size = 8, clear = 256, eoi = 257;
  const int hsize = 1 << 14;
  std::vector<int32_t> hkey(hsize, -1);
  std::vector<int16_t> hval(hsize);
  std::vector<uint8_t> bytes;
  uint32_t acc = 0;
  int nacc = 0, size = min_size + 1, next = eoi + 1;
  auto emit = [&](int code) {
    acc |= (uint32_t)code << nacc;
    nacc += size;
    while (nacc >= 8) {
      bytes.push_back((uint8_t)(acc & 0xFF));
      acc >>= 8;
      nacc -= 8;
    }
  };
  auto reset = [&]() {
    std::fill(hkey.begin(), hkey.end(), -1);
    size = min_size + 1;
    next = eoi + 1;
  };
  emit(clear);
  if (!idx.empty()) {
    int prefix = idx[0];
    for (size_t i = 1; i < idx.size(); ++i) {
      int k = idx[i];
      int32_t key = (prefix << 8) | k;
      uint32_t h = ((uint32_t)key * 2654435761u) >> (32 - 14);
      while (hkey[h] != -1 && hkey[h] != key) h = (h + 1) & (hsize - 1);
      if (hkey[h] == key) {
        prefix = hval[h];
        continue;
      }
      emit(prefix);
      if (next < 4096) {
        hkey[h] = key;
        hval[h] = (int16_t)next;
        if (next == (1 << size) && size < 12) ++size;
        ++next;
      } else {
        emit(clear);
        reset();
      }
      prefix = k;
    }
    emit(prefix);
  }
  emit(eoi);
  if (nacc > 0) bytes.push_back((uint8_t)(acc & 0xFF));
  out.push_back(min_size);
  for (size_t i = 0; i < bytes.size(); i += 255) {
    size_t len = std::min<size_t>(255, bytes.size() - i);
    out.push_back((uint8_t)len);
    out.insert(out.end(), bytes.begin() + i, bytes.begin() + i + len);
  }
  out.push_back(0);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v & 0xFF));
  o.push_back((uint8_t)(v >> 8));
}

// one frame's graphic control extension, image descriptor, local colour
// table and image data
std::vector<uint8_t> encode_frame(const uint8_t* px, int w, int h,
                                  int delay_cs, std::vector<Cell>& hist) {
  int64_t n = (int64_t)w * h;
  std::vector<uint8_t> pal = palette_of(px, n, hist);
  std::vector<uint8_t> idx = map_pixels(px, n, pal);
  std::vector<uint8_t> o;
  const uint8_t gce[4] = {0x21, 0xF9, 0x04, 0x04};  // disposal 1: keep
  o.insert(o.end(), gce, gce + 4);
  put16(o, delay_cs);
  o.push_back(0);
  o.push_back(0);
  o.push_back(0x2C);
  put16(o, 0);
  put16(o, 0);
  put16(o, w);
  put16(o, h);
  o.push_back(0x87);  // local table of 256 entries
  pal.resize(256 * 3, 0);
  o.insert(o.end(), pal.begin(), pal.end());
  lzw_encode(idx, o);
  return o;
}

struct Reader {
  const uint8_t* d;
  size_t n, pos = 0;
  uint8_t u8() {
    if (pos >= n) throw std::string("truncated GIF");
    return d[pos++];
  }
  int u16() {
    int lo = u8();
    return lo | (u8() << 8);
  }
  void skip_blocks() {
    for (int len = u8(); len; len = u8()) {
      if (pos + len > n) throw std::string("truncated GIF");
      pos += len;
    }
  }
};

void lzw_decode(Reader& r, std::vector<uint8_t>& out, size_t want) {
  int min_size = r.u8();
  if (min_size < 2 || min_size > 8) throw std::string("bad LZW code size");
  std::vector<uint8_t> data;
  for (int len = r.u8(); len; len = r.u8()) {
    if (r.pos + len > r.n) throw std::string("truncated GIF");
    data.insert(data.end(), r.d + r.pos, r.d + r.pos + len);
    r.pos += len;
  }
  const int clear = 1 << min_size, eoi = clear + 1;
  std::vector<int16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096), stack(4097);
  for (int i = 0; i < clear; ++i) suffix[i] = first[i] = (uint8_t)i;
  int size = min_size + 1, next = eoi + 1, prev = -1;
  size_t bit = 0;
  out.clear();
  while (out.size() < want) {
    if (bit + size > data.size() * 8) break;
    int code = 0;
    for (int k = 0; k < size; ++k, ++bit)
      code |= ((data[bit >> 3] >> (bit & 7)) & 1) << k;
    if (code == clear) {
      size = min_size + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    int c = code, sp = 0;
    if (prev < 0) {
      if (code >= clear) throw std::string("bad LZW data");
      out.push_back((uint8_t)code);
      prev = code;
      continue;
    }
    if (code > next || (code >= next && next >= 4096))
      throw std::string("bad LZW data");
    if (code == next) {
      stack[sp++] = first[prev];
      c = prev;
    }
    while (c >= clear) {
      stack[sp++] = suffix[c];
      c = prefix[c];
    }
    stack[sp++] = (uint8_t)c;
    while (sp) out.push_back(stack[--sp]);
    if (next < 4096) {
      prefix[next] = (int16_t)prev;
      suffix[next] = (uint8_t)c;
      first[next] = first[prev];
      ++next;
      if (next == (1 << size) && size < 12) ++size;
    }
    prev = code;
  }
  out.resize(want, 0);
}

// walks the file; with out, draws every frame
void walk(Reader& r, int* frames, int* w, int* h, int* loop, uint8_t* out,
          int32_t* delays) {
  if (r.n < 13 || (std::memcmp(r.d, "GIF89a", 6) && std::memcmp(r.d,
                                                               "GIF87a", 6)))
    throw std::string("not a GIF file");
  r.pos = 6;
  *w = r.u16();
  *h = r.u16();
  int packed = r.u8();
  r.u8();
  r.u8();
  std::vector<uint8_t> global;
  if (packed & 0x80) {
    size_t len = 3u << ((packed & 7) + 1);
    if (r.pos + len > r.n) throw std::string("truncated GIF");
    global.assign(r.d + r.pos, r.d + r.pos + len);
    r.pos += len;
  }
  *loop = -1;
  *frames = 0;
  int delay = 0, transparent = -1, disposal = 0;
  std::vector<uint8_t> canvas((size_t)*w * *h * 3, 0), idx;
  for (;;) {
    int b = r.u8();
    if (b == 0x3B) break;
    if (b == 0x21) {
      int label = r.u8();
      if (label == 0xF9) {
        int len = r.u8();
        if (len < 4) throw std::string("bad graphic control extension");
        int flags = r.u8();
        delay = r.u16();
        transparent = (flags & 1) ? r.u8() : (r.u8(), -1);
        disposal = (flags >> 2) & 7;
        r.pos += len - 4;
        r.skip_blocks();
      } else if (label == 0xFF) {
        int len = r.u8();
        if (r.pos + len > r.n) throw std::string("truncated GIF");
        bool netscape = len == 11 && std::memcmp(r.d + r.pos, "NETSCAPE2.0",
                                                 11) == 0;
        r.pos += len;
        for (int blen = r.u8(); blen; blen = r.u8()) {
          if (netscape && blen >= 3 && r.pos + 3 <= r.n && r.d[r.pos] == 1)
            *loop = r.d[r.pos + 1] | (r.d[r.pos + 2] << 8);
          r.pos += blen;
        }
      } else {
        r.skip_blocks();
      }
      continue;
    }
    if (b != 0x2C) throw std::string("bad GIF block");
    int x0 = r.u16(), y0 = r.u16(), fw = r.u16(), fh = r.u16();
    int ip = r.u8();
    if (ip & 0x40) throw std::string("interlaced GIF frames are not read");
    std::vector<uint8_t> local;
    if (ip & 0x80) {
      size_t len = 3u << ((ip & 7) + 1);
      if (r.pos + len > r.n) throw std::string("truncated GIF");
      local.assign(r.d + r.pos, r.d + r.pos + len);
      r.pos += len;
    }
    const std::vector<uint8_t>& table = local.empty() ? global : local;
    if (out) {
      lzw_decode(r, idx, (size_t)fw * fh);
      for (int y = 0; y < fh; ++y)
        for (int x = 0; x < fw; ++x) {
          int cx = x0 + x, cy = y0 + y;
          if (cx >= *w || cy >= *h) continue;
          int c = idx[(size_t)y * fw + x];
          if (c == transparent) continue;
          size_t k = 3 * (size_t)c;
          if (k + 3 > table.size()) throw std::string("index past the table");
          std::memcpy(&canvas[3 * ((size_t)cy * *w + cx)], &table[k], 3);
        }
      std::memcpy(out + canvas.size() * *frames, canvas.data(),
                  canvas.size());
      delays[*frames] = delay * 10;
      if (disposal == 2)  // restore the frame's area to the background
        for (int y = y0; y < y0 + fh && y < *h; ++y)
          for (int x = x0; x < x0 + fw && x < *w; ++x)
            std::memset(&canvas[3 * ((size_t)y * *w + x)], 0, 3);
    } else {
      r.u8();
      r.skip_blocks();
    }
    ++*frames;
  }
}

int fail(const std::string& msg, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
  return 2;
}

}  // namespace

extern "C" {

// frames: n pointers to [h, w, 3] uint8 RGB frames
int gif_write(const char* path, const uint8_t* const* frames, int32_t n,
              int32_t w, int32_t h, int32_t delay_ms, int32_t loop,
              int32_t n_threads, char* err, int32_t errlen) {
  if (n <= 0 || w <= 0 || h <= 0 || w > 65535 || h > 65535)
    return fail("frames must be non-empty and at most 65535 wide", err,
                errlen);
  if (n_threads <= 0) {
    n_threads = (int32_t)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  n_threads = std::min(n_threads, n);
  std::vector<std::vector<uint8_t>> coded(n);
  std::atomic<int> cursor{0};
  auto worker = [&]() {
    std::vector<Cell> hist(kCells);
    for (int i; (i = cursor.fetch_add(1)) < n;)
      coded[i] = encode_frame(frames[i], w, h, (delay_ms + 5) / 10, hist);
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();

  std::vector<uint8_t> head = {'G', 'I', 'F', '8', '9', 'a'};
  put16(head, w);
  put16(head, h);
  head.push_back(0);  // no global table
  head.push_back(0);
  head.push_back(0);
  const char app[] = "\x21\xFF\x0BNETSCAPE2.0\x03\x01";
  head.insert(head.end(), app, app + 16);
  put16(head, loop);
  head.push_back(0);
  FILE* f = std::fopen(path, "wb");
  if (!f) return fail(std::string("cannot open ") + path, err, errlen);
  bool ok = std::fwrite(head.data(), 1, head.size(), f) == head.size();
  for (auto& c : coded)
    ok = ok && std::fwrite(c.data(), 1, c.size(), f) == c.size();
  ok = ok && std::fputc(0x3B, f) != EOF;
  ok = (std::fclose(f) == 0) && ok;
  return ok ? 0 : fail(std::string("cannot write ") + path, err, errlen);
}

int gif_info(const uint8_t* data, int64_t n, int32_t* frames, int32_t* w,
             int32_t* h, int32_t* loop, char* err, int32_t errlen) {
  try {
    Reader r{data, (size_t)n};
    walk(r, frames, w, h, loop, nullptr, nullptr);
    return 0;
  } catch (const std::string& e) {
    return fail(e, err, errlen);
  }
}

// out: [frames, h, w, 3] uint8; delays_ms: [frames]
int gif_decode(const uint8_t* data, int64_t n, uint8_t* out,
               int32_t* delays_ms, char* err, int32_t errlen) {
  try {
    Reader r{data, (size_t)n};
    int frames, w, h, loop;
    walk(r, &frames, &w, &h, &loop, out, delays_ms);
    return 0;
  } catch (const std::string& e) {
    return fail(e, err, errlen);
  }
}

}  // extern "C"
