// Native host runtime: threaded PNG decode + frame prefetch pipeline.
//
// The port's copy of object_slam_tpu/native/oslam_host.cpp. The reference
// performs per-frame disk IO inline on the tracking thread (cv::imread of
// RGB/depth in Examples/RGB-D/rgbd_tum.cc:99-107 and of instance masks in
// src/Semantic.cc:45,88), so decode latency lands on the camera-rate
// critical path. This runtime moves ingestion off that path: a pthread
// worker pool decodes PNG files into per-frame slabs, a bounded in-order
// queue hands completed frames to the tracking loop, and buffers are
// recycled.
//
// PNG is decoded here over zlib's inflate (the card's machine has zlib but
// no libpng or libjpeg headers), with the output libpng gives the
// reference's copy: gray 1/2/4-bit expanded to 8, palette to RGB, alpha
// and transparency dropped, 16-bit samples in host (little-endian) order.
// Interlaced files and JPEG are refused with a message.
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (object_slam_tpu_torch/native/loader.py), built by that loader with
//   g++ -O2 -fPIC -std=c++17 -shared -o liboslam_host.so oslam_host.cpp -lz -lpthread

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <strings.h>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;   // 1 or 3
  int bit_depth = 8;  // 8 or 16
  std::vector<uint8_t> data;  // row-major, native endian for 16-bit
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool fail(std::string* err, const char* path, const char* what) {
  *err = std::string(path) + ": " + what;
  return false;
}

bool read_file(const char* path, std::vector<uint8_t>* out,
               std::string* err) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return fail(err, path, "cannot open");
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), fp)) > 0)
    out->insert(out->end(), buf, buf + n);
  fclose(fp);
  return true;
}

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return uint8_t(pb <= pc ? b : c);
}

bool decode_png_file(const char* path, Image* out, std::string* err) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file, err)) return false;
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                  '\n'};
  if (file.size() < 8 || memcmp(file.data(), kSig, 8) != 0)
    return fail(err, path, "not a PNG file");

  uint32_t w = 0, h = 0;
  int depth = 0, ctype = -1, interlace = 0;
  std::vector<uint8_t> palette, idat;
  size_t pos = 8;
  bool ended = false;
  while (pos + 8 <= file.size() && !ended) {
    uint32_t len = be32(&file[pos]);
    const uint8_t* type = &file[pos + 4];
    if (pos + 12 + size_t(len) > file.size())
      return fail(err, path, "truncated chunk");
    const uint8_t* body = &file[pos + 8];
    if (!memcmp(type, "IHDR", 4)) {
      if (len < 13) return fail(err, path, "short IHDR");
      w = be32(body);
      h = be32(body + 4);
      depth = body[8];
      ctype = body[9];
      interlace = body[12];
    } else if (!memcmp(type, "PLTE", 4)) {
      palette.assign(body, body + len);
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!memcmp(type, "IEND", 4)) {
      ended = true;
    }
    pos += 12 + size_t(len);
  }
  if (ctype < 0 || w == 0 || h == 0) return fail(err, path, "no IHDR");
  if (interlace != 0) return fail(err, path, "interlaced PNG unsupported");
  int in_ch;
  switch (ctype) {
    case 0: in_ch = 1; break;
    case 2: in_ch = 3; break;
    case 3: in_ch = 1; break;
    case 4: in_ch = 2; break;
    case 6: in_ch = 4; break;
    default: return fail(err, path, "unknown color type");
  }
  bool depth_ok =
      (ctype == 0 && (depth == 1 || depth == 2 || depth == 4 ||
                      depth == 8 || depth == 16)) ||
      (ctype == 3 && (depth == 1 || depth == 2 || depth == 4 ||
                      depth == 8)) ||
      ((ctype == 2 || ctype == 4 || ctype == 6) &&
       (depth == 8 || depth == 16));
  if (!depth_ok) return fail(err, path, "invalid bit depth");
  if (ctype == 3 && palette.empty()) return fail(err, path, "no PLTE");

  size_t stride = (size_t(w) * in_ch * depth + 7) / 8;
  size_t bpp = std::max<size_t>(1, size_t(in_ch) * depth / 8);
  std::vector<uint8_t> raw(size_t(h) * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return fail(err, path, "corrupt image data");

  // undo the scanline filters in place
  std::vector<uint8_t> pix(size_t(h) * stride);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* line = &raw[size_t(y) * (stride + 1)];
    uint8_t* cur = &pix[size_t(y) * stride];
    const uint8_t* up = y ? cur - stride : nullptr;
    uint8_t ftype = line[0];
    line += 1;
    for (size_t i = 0; i < stride; ++i) {
      int a = i >= bpp ? cur[i - bpp] : 0;
      int b = up ? up[i] : 0;
      int c = (up && i >= bpp) ? up[i - bpp] : 0;
      switch (ftype) {
        case 0: cur[i] = line[i]; break;
        case 1: cur[i] = uint8_t(line[i] + a); break;
        case 2: cur[i] = uint8_t(line[i] + b); break;
        case 3: cur[i] = uint8_t(line[i] + ((a + b) >> 1)); break;
        case 4: cur[i] = uint8_t(line[i] + paeth(a, b, c)); break;
        default: return fail(err, path, "unknown scanline filter");
      }
    }
  }

  int out_ch = (ctype == 2 || ctype == 3 || ctype == 6) ? 3 : 1;
  int out_depth = depth == 16 ? 16 : 8;
  out->width = int(w);
  out->height = int(h);
  out->channels = out_ch;
  out->bit_depth = out_depth;
  size_t sample = out_depth / 8;
  out->data.resize(size_t(w) * h * out_ch * sample);
  uint8_t* dst = out->data.data();
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* row = &pix[size_t(y) * stride];
    for (uint32_t x = 0; x < w; ++x) {
      if (depth < 8) {
        // packed samples, most significant bits first
        int per = 8 / depth;
        int shift = 8 - depth * (1 + int(x % per));
        int v = (row[x / per] >> shift) & ((1 << depth) - 1);
        if (ctype == 3) {
          if (size_t(v) * 3 + 2 >= palette.size())
            return fail(err, path, "palette index out of range");
          memcpy(dst, &palette[size_t(v) * 3], 3);
          dst += 3;
        } else {
          *dst++ = uint8_t(v * 255 / ((1 << depth) - 1));
        }
      } else if (ctype == 3) {
        int v = row[x];
        if (size_t(v) * 3 + 2 >= palette.size())
          return fail(err, path, "palette index out of range");
        memcpy(dst, &palette[size_t(v) * 3], 3);
        dst += 3;
      } else {
        // the first out_ch samples of the pixel (alpha dropped)
        const uint8_t* px = row + size_t(x) * in_ch * sample;
        for (int ch = 0; ch < out_ch; ++ch) {
          if (sample == 2) {            // big-endian -> host order
            dst[0] = px[ch * 2 + 1];
            dst[1] = px[ch * 2];
            dst += 2;
          } else {
            *dst++ = px[ch];
          }
        }
      }
    }
  }
  return true;
}

void copy_error(const std::string& msg, char* err, int err_cap) {
  if (err == nullptr || err_cap <= 0) return;
  snprintf(err, size_t(err_cap), "%s", msg.c_str());
}

bool decode_any(const char* path, Image* out, std::string* err) {
  size_t n = strlen(path);
  if ((n > 4 && strcasecmp(path + n - 4, ".jpg") == 0) ||
      (n > 5 && strcasecmp(path + n - 5, ".jpeg") == 0))
    return fail(err, path, "JPEG is not supported (no libjpeg)");
  return decode_png_file(path, out, err);
}

// ---------------------------------------------------------------------------
// Frame prefetch pipeline
// ---------------------------------------------------------------------------

struct FrameRequest {
  int frame_id;
  std::string rgb_path;
  std::string depth_path;            // empty -> none
  std::vector<std::string> mask_paths;
};

struct FrameResult {
  int frame_id = -1;
  bool ok = false;
  std::string error;
  Image rgb;
  Image depth;
  std::vector<Image> masks;
};

class Loader {
 public:
  Loader(int n_workers, int capacity) : capacity_(capacity), stop_(false) {
    for (int i = 0; i < n_workers; ++i)
      workers_.emplace_back([this] { this->Work(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_req_.notify_all();
    cv_done_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Non-blocking: requests are cheap (paths only). Backpressure applies to
  // DECODED results — workers pause when `capacity` frames sit unconsumed,
  // so memory stays bounded while the consumer may submit the whole
  // sequence up front.
  bool Submit(FrameRequest req) {
    std::lock_guard<std::mutex> lk(mu_);
    if (stop_) return false;
    pending_.push_back(std::move(req));
    cv_req_.notify_one();
    return true;
  }

  // Blocks until the given frame id is decoded; transfers ownership.
  // The waited id is decoded even when the result buffer is full (priority
  // bypass) so arbitrary get-order cannot deadlock against backpressure.
  bool Wait(int frame_id, FrameResult* out) {
    std::unique_lock<std::mutex> lk(mu_);
    priority_id_ = frame_id;
    cv_req_.notify_all();
    cv_done_.wait(lk, [this, frame_id] {
      return stop_ || done_.count(frame_id) > 0;
    });
    priority_id_ = -1;
    if (stop_ && !done_.count(frame_id)) return false;
    *out = std::move(done_[frame_id]);
    done_.erase(frame_id);
    cv_req_.notify_all();   // room for workers to decode ahead again
    return true;
  }

 private:
  void Work() {
    for (;;) {
      FrameRequest req;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_req_.wait(lk, [this] {
          if (stop_) return true;
          if (pending_.empty()) return false;
          if (static_cast<int>(done_.size()) + in_flight_ < capacity_)
            return true;
          // priority bypass: the consumer is blocked on a specific frame
          for (const auto& r : pending_)
            if (r.frame_id == priority_id_) return true;
          return false;
        });
        if (stop_) return;
        // pick the priority frame if present, else FIFO
        auto it = pending_.begin();
        if (priority_id_ >= 0)
          for (auto p = pending_.begin(); p != pending_.end(); ++p)
            if (p->frame_id == priority_id_) { it = p; break; }
        req = std::move(*it);
        pending_.erase(it);
        ++in_flight_;
      }
      FrameResult res;
      res.frame_id = req.frame_id;
      res.ok = decode_any(req.rgb_path.c_str(), &res.rgb, &res.error);
      if (res.ok && !req.depth_path.empty())
        res.ok = decode_any(req.depth_path.c_str(), &res.depth, &res.error);
      res.masks.resize(req.mask_paths.size());
      for (size_t i = 0; i < req.mask_paths.size() && res.ok; ++i)
        res.ok = decode_any(req.mask_paths[i].c_str(), &res.masks[i],
                            &res.error);
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_[req.frame_id] = std::move(res);
        --in_flight_;
      }
      cv_done_.notify_all();
    }
  }

  int capacity_;
  bool stop_;
  int in_flight_ = 0;
  int priority_id_ = -1;
  std::mutex mu_;
  std::condition_variable cv_req_, cv_done_;
  std::deque<FrameRequest> pending_;
  std::unordered_map<int, FrameResult> done_;
  std::vector<std::thread> workers_;
};

std::mutex g_results_mu;
std::unordered_map<int64_t, FrameResult> g_results;  // key: (loader, frame)
int64_t ResultKey(void* loader, int frame_id) {
  return (reinterpret_cast<int64_t>(loader) << 20) ^ frame_id;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* oslam_loader_create(int n_workers, int capacity) {
  return new Loader(n_workers, capacity);
}

void oslam_loader_destroy(void* loader) {
  delete static_cast<Loader*>(loader);
}

int oslam_submit(void* loader, int frame_id, const char* rgb_path,
                 const char* depth_path, const char** mask_paths,
                 int n_masks) {
  FrameRequest req;
  req.frame_id = frame_id;
  req.rgb_path = rgb_path ? rgb_path : "";
  req.depth_path = depth_path ? depth_path : "";
  for (int i = 0; i < n_masks; ++i) req.mask_paths.emplace_back(mask_paths[i]);
  return static_cast<Loader*>(loader)->Submit(std::move(req)) ? 0 : -1;
}

// Waits for a frame; returns 0 on success and fills the descriptor arrays,
// else -1 with the reason in err. Buffers stay owned by the runtime until
// oslam_release(frame_id). Each frame id is handed out once.
int oslam_wait(void* loader, int frame_id,
               uint8_t** rgb, int* rgb_h, int* rgb_w, int* rgb_c,
               uint8_t** depth, int* depth_h, int* depth_w, int* depth_bits,
               uint8_t** masks, int* mask_h, int* mask_w, int* n_masks,
               int max_masks, char* err, int err_cap) {
  FrameResult res;
  if (!static_cast<Loader*>(loader)->Wait(frame_id, &res)) {
    copy_error("the loader stopped", err, err_cap);
    return -1;
  }
  if (!res.ok) {
    copy_error(res.error, err, err_cap);
    return -1;
  }
  int64_t key = ResultKey(loader, frame_id);
  std::lock_guard<std::mutex> lk(g_results_mu);
  FrameResult& stored = g_results[key] = std::move(res);
  *rgb = stored.rgb.data.data();
  *rgb_h = stored.rgb.height;
  *rgb_w = stored.rgb.width;
  *rgb_c = stored.rgb.channels;
  if (stored.depth.data.empty()) {
    *depth = nullptr;
    *depth_h = *depth_w = *depth_bits = 0;
  } else {
    *depth = stored.depth.data.data();
    *depth_h = stored.depth.height;
    *depth_w = stored.depth.width;
    *depth_bits = stored.depth.bit_depth;
  }
  int nm = static_cast<int>(stored.masks.size());
  if (nm > max_masks) nm = max_masks;
  *n_masks = nm;
  for (int i = 0; i < nm; ++i) {
    masks[i] = stored.masks[i].data.data();
    mask_h[i] = stored.masks[i].height;
    mask_w[i] = stored.masks[i].width;
  }
  return 0;
}

void oslam_release(void* loader, int frame_id) {
  std::lock_guard<std::mutex> lk(g_results_mu);
  g_results.erase(ResultKey(loader, frame_id));
}

// One-shot synchronous decode (tests / simple paths): the byte count, or
// -1 with the reason in err, or minus the size needed.
int oslam_decode(const char* path, uint8_t* out, int out_capacity,
                 int* h, int* w, int* c, int* bits, char* err, int err_cap) {
  Image img;
  std::string msg;
  if (!decode_any(path, &img, &msg)) {
    copy_error(msg, err, err_cap);
    return -1;
  }
  *h = img.height;
  *w = img.width;
  *c = img.channels;
  *bits = img.bit_depth;
  int need = static_cast<int>(img.data.size());
  if (need > out_capacity) return -need;
  memcpy(out, img.data.data(), need);
  return need;
}

}  // extern "C"
