// Native multi-threaded frame loader (the port's copy of
// native/dataloader.cpp).
//
// Replaces the reference's host-side data parallelism
// (torch.utils.data.DataLoader(num_workers=4), dataset/dataset.py:249) with
// a C++ thread-pool PNG/JPEG decoder, exposed to Python via a C ABI
// (ctypes): one pool task per frame of a batch.  It keeps no frames: the
// dataset caches what it returns.
//
// Beyond the original: a frame that fails to decode (missing file, corrupt
// data: libjpeg's errors return through longjmp instead of exiting) or has
// another size than the loader's H x W makes sr_loader_batch return -1
// instead of copying from an empty or short buffer; the path lists keep
// their empty entries (a frame without a normal map); each batch slot
// decodes into its own buffers (a frame id may repeat), and a task signals
// its end while it holds the batch's lock (the caller's lock and condition
// variable live on its stack, and it returns as soon as it sees the count
// reach 0).
//
// Built by selfreconcode_tpu_torch/data/native_loader.py:
//   g++ -O3 -fPIC -std=c++17 -shared -o libsrloader.so dataloader.cpp
//       -lpng -ljpeg -lpthread

#include <png.h>
#include <jpeglib.h>

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <cstdio>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // h*w*c, row-major, BGR to match cv2 consumers
};

bool ends_with(const std::string& s, const char* suf) {
  size_t n = strlen(suf);
  return s.size() >= n && s.compare(s.size() - n, n, suf) == 0;
}

bool decode_png(const std::string& path, Image* out) {
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_set_bgr(png);  // match cv2's BGR layout
  png_read_update_info(png, info);
  out->h = h;
  out->w = w;
  out->c = 3;
  out->data.resize(size_t(h) * w * 3);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->data.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
}

struct JpegError {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegError*>(cinfo->err)->jump, 1);
}

bool decode_jpeg(const std::string& path, Image* out) {
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
#ifdef JCS_EXTENSIONS
  cinfo.out_color_space = JCS_EXT_BGR;
#else
  cinfo.out_color_space = JCS_RGB;
#endif
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = 3;
  out->data.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
#ifndef JCS_EXTENSIONS
  // swap R/B in place to BGR
  for (size_t i = 0; i < out->data.size(); i += 3)
    std::swap(out->data[i], out->data[i + 2]);
#endif
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return true;
}

bool decode(const std::string& path, Image* out) {
  if (ends_with(path, ".png") || ends_with(path, ".PNG"))
    return decode_png(path, out);
  return decode_jpeg(path, out);
}

struct Frame {
  Image img;     // (H,W,3) BGR uint8
  Image mask;    // (H,W,3) -> reduced to any-channel>0 on assembly
  Image normal;  // optional (empty if absent)
  bool ok = false;  // every image decoded at the loader's size
};

class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i)
      threads_.emplace_back([this] { Work(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  void Submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      q_.push(std::move(f));
    }
    cv_.notify_one();
  }

 private:
  void Work() {
    for (;;) {
      std::function<void()> f;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        f = std::move(q_.front());
        q_.pop();
      }
      f();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> q_;
  std::vector<std::thread> threads_;
  bool stop_;
};

struct Loader {
  std::vector<std::string> img_paths, mask_paths, normal_paths;
  std::unique_ptr<Pool> pool;
  int H = 0, W = 0;

  bool Fits(const Image& im) const { return im.h == H && im.w == W; }

  void Load(int fid, Frame* f) const {
    f->ok = decode(img_paths[fid], &f->img) && Fits(f->img) &&
            decode(mask_paths[fid], &f->mask) && Fits(f->mask);
    if (f->ok && !normal_paths.empty() && !normal_paths[fid].empty())
      f->ok = decode(normal_paths[fid], &f->normal) && Fits(f->normal);
  }
};

}  // namespace

extern "C" {

// paths: flat "\n"-joined, one entry a frame; normals may be an empty
// string (no normals) or hold an empty entry for a frame without one.
void* sr_loader_create(const char* imgs, const char* masks,
                       const char* normals, int n_frames, int h, int w,
                       int n_threads) {
  auto split = [](const char* s) {
    std::vector<std::string> out;
    if (!s || !*s) return out;
    const char* p = s;
    const char* q;
    while ((q = strchr(p, '\n'))) {
      out.emplace_back(p, q - p);
      p = q + 1;
    }
    out.emplace_back(p);
    return out;
  };
  auto* L = new Loader;
  L->img_paths = split(imgs);
  L->mask_paths = split(masks);
  L->normal_paths = split(normals);
  if ((int)L->img_paths.size() != n_frames ||
      (int)L->mask_paths.size() != n_frames ||
      (!L->normal_paths.empty() &&
       (int)L->normal_paths.size() != n_frames)) {
    delete L;
    return nullptr;
  }
  L->H = h;
  L->W = w;
  L->pool.reset(new Pool(n_threads > 0 ? n_threads : 4));
  return L;
}

void sr_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

// Decode (parallel) + assemble a batch:
//   imgs_out   (bs,H,W,3) uint8 BGR
//   masks_out  (bs,H,W)   uint8 {0,1}
//   normals_out(bs,H,W,3) uint8 (RGB as stored) or nullptr
// Returns the number of frames with a normal map, or -1 when a frame id is
// out of range or a frame failed to decode at H x W (nothing is written).
int sr_loader_batch(void* handle, const int* fids, int bs, uint8_t* imgs_out,
                    uint8_t* masks_out, uint8_t* normals_out) {
  auto* L = static_cast<Loader*>(handle);
  for (int i = 0; i < bs; ++i)
    if (fids[i] < 0 || fids[i] >= (int)L->img_paths.size()) return -1;
  std::vector<Frame> frames(bs);
  int remaining = bs;
  std::mutex done_mu;
  std::condition_variable done_cv;
  for (int i = 0; i < bs; ++i) {
    Frame* f = &frames[i];
    int fid = fids[i];
    L->pool->Submit([L, fid, f, &remaining, &done_mu, &done_cv] {
      L->Load(fid, f);
      std::lock_guard<std::mutex> lk(done_mu);
      --remaining;
      done_cv.notify_one();
    });
  }
  {
    std::unique_lock<std::mutex> lk(done_mu);
    done_cv.wait(lk, [&] { return remaining == 0; });
  }
  for (const Frame& f : frames)
    if (!f.ok) return -1;
  int n_normals = 0;
  size_t hw3 = size_t(L->H) * L->W * 3;
  size_t hw = size_t(L->H) * L->W;
  for (int i = 0; i < bs; ++i) {
    const Frame& f = frames[i];
    memcpy(imgs_out + i * hw3, f.img.data.data(), hw3);
    const uint8_t* m = f.mask.data.data();
    uint8_t* mo = masks_out + i * hw;
    for (size_t p = 0; p < hw; ++p)
      mo[p] = (m[3 * p] | m[3 * p + 1] | m[3 * p + 2]) ? 1 : 0;
    if (normals_out && f.normal.h) {
      // stored BGR by our decoder; consumers expect RGB like cv2[...,::-1]
      const uint8_t* nb = f.normal.data.data();
      uint8_t* no = normals_out + i * hw3;
      for (size_t p = 0; p < hw; ++p) {
        no[3 * p] = nb[3 * p + 2];
        no[3 * p + 1] = nb[3 * p + 1];
        no[3 * p + 2] = nb[3 * p];
      }
      ++n_normals;
    }
  }
  return n_normals;
}

}  // extern "C"
