// frame_pump: host video decode + PIL-exact crop / resize on a thread.
//
// The port's copy of the JAX package's native decoder.  It decodes the
// container with OpenCV (libavcodec), center-crops and resizes each frame
// on a background thread, and hands ready uint8 RGB frames to Python
// through a bounded queue, so that host decode overlaps device work and
// only the resized crops cross to the device.
//
// C ABI (ctypes):
//   fp_open(path, out_size, crop_h_frac, crop_w_frac, queue_cap) -> handle
//   fp_meta(handle, &fps, &nframes, &height, &width)
//   fp_read(handle, out, max_frames) -> frames written (0 == EOF)
//   fp_close(handle)
//
// Crop bounds match sais_tpu_torch.ops.preprocess.center_crop_bounds
// (torchvision CenterCrop's rounded origin, PIL's crop box rounding each
// coordinate half to even), and the resize is bit-identical with
// PIL.Image.resize(BILINEAR) and with the device twin resize_pil_exact.
// Built at first use by sais_tpu_torch/io/native_loader.py.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

namespace {

struct CropBounds {
  int lo, hi;
};

CropBounds crop_bounds(int size, double frac) {
  const double crop = frac * size;
  // round half to even, as Python's round() in center_crop_bounds
  // (std::lround rounds half away from zero); std::nearbyint under the
  // default FE_TONEAREST mode rounds half to even
  const int top = static_cast<int>(std::nearbyint((size - crop) / 2.0));
  return {top, static_cast<int>(std::nearbyint(top + crop))};
}

// ---------------------------------------------------------------------------
// PIL-exact BILINEAR resample (Pillow Resample.c fixed-point arithmetic):
// triangle filter with adaptive support, coefficients quantized to
// 1 << PRECISION_BITS, horizontal pass rounded/clipped to uint8 BEFORE the
// vertical pass.  Bit-identical with Image.resize((n, n), BILINEAR) and
// with sais_tpu_torch.ops.preprocess.resize_pil_exact (the device twin).
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;
constexpr int kRoundBias = 1 << (kPrecisionBits - 1);

inline uint8_t clip8(int v) {
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

struct AxisCoeffs {
  int ksize = 0;
  std::vector<int> xmin;  // (out,)
  std::vector<int> kk;    // (out, ksize) row-major, zero-padded past xmax
};

AxisCoeffs pil_coeffs(int in_size, int out_size) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // bilinear support = 1.0
  AxisCoeffs c;
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.xmin.resize(out_size);
  c.kk.assign(static_cast<size_t>(out_size) * c.ksize, 0);
  std::vector<double> w(c.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    const double ss = 1.0 / filterscale;
    double total = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double a = (x + xmin - center + 0.5) * ss;
      const double v = a < 0 ? 1.0 + a : 1.0 - a;  // triangle filter
      w[x] = v < 0 ? 0.0 : v;
      total += w[x];
    }
    for (int x = 0; x < xmax; ++x) {
      const double k = total != 0.0 ? w[x] / total : w[x];
      c.kk[static_cast<size_t>(xx) * c.ksize + x] = static_cast<int>(
          k < 0 ? k * (1 << kPrecisionBits) - 0.5
                : k * (1 << kPrecisionBits) + 0.5);
    }
    c.xmin[xx] = xmin;
  }
  return c;
}

// horizontal fixed-point pass: (rows, in) 8UC3 -> (rows, out) 8UC3
void resample_rows(const cv::Mat& in, cv::Mat& out, const AxisCoeffs& c) {
  const int out_w = static_cast<int>(c.xmin.size());
  out.create(in.rows, out_w, CV_8UC3);
  for (int y = 0; y < in.rows; ++y) {
    const uint8_t* row = in.ptr<uint8_t>(y);
    uint8_t* orow = out.ptr<uint8_t>(y);
    for (int xx = 0; xx < out_w; ++xx) {
      const int* k = &c.kk[static_cast<size_t>(xx) * c.ksize];
      const int xmin = c.xmin[xx];
      int s0 = kRoundBias, s1 = kRoundBias, s2 = kRoundBias;
      for (int t = 0; t < c.ksize; ++t) {
        int xi = xmin + t;
        if (xi >= in.cols) xi = in.cols - 1;  // coeff is 0 past xmax
        const uint8_t* px = row + 3 * xi;
        s0 += px[0] * k[t];
        s1 += px[1] * k[t];
        s2 += px[2] * k[t];
      }
      orow[3 * xx + 0] = clip8(s0);
      orow[3 * xx + 1] = clip8(s1);
      orow[3 * xx + 2] = clip8(s2);
    }
  }
}

// full resize: horizontal first, uint8 intermediate, then vertical —
// ImagingResample's pass order
void pil_resize_exact(const cv::Mat& in, cv::Mat& out, int out_size) {
  AxisCoeffs ch = pil_coeffs(in.cols, out_size);
  cv::Mat horiz;
  resample_rows(in, horiz, ch);
  AxisCoeffs cv_ = pil_coeffs(in.rows, out_size);
  cv::Mat t = horiz.t();  // operate on columns as rows
  // t is (out_size, rows) 8UC3; resample its rows (= original columns)
  cv::Mat tout;
  resample_rows(t, tout, cv_);
  out = tout.t();
}

struct FramePump {
  cv::VideoCapture cap;
  int out_size;
  double crop_h, crop_w;
  size_t queue_cap;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<cv::Mat> queue;
  std::atomic<bool> done{false};
  std::atomic<bool> stop{false};

  double fps = 0;
  long nframes = 0;
  int height = 0, width = 0;

  void run() {
    cv::Mat bgr;
    while (!stop.load()) {
      if (!cap.read(bgr)) break;
      CropBounds rb = crop_bounds(bgr.rows, crop_h);
      CropBounds cb = crop_bounds(bgr.cols, crop_w);
      cv::Mat cropped = bgr(cv::Range(rb.lo, rb.hi), cv::Range(cb.lo, cb.hi));
      cv::Mat resized;
      pil_resize_exact(cropped, resized, out_size);
      cv::Mat rgb;
      cv::cvtColor(resized, rgb, cv::COLOR_BGR2RGB);
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return queue.size() < queue_cap || stop; });
        if (stop) break;
        queue.push_back(rgb.clone());
      }
      cv_pop.notify_one();
    }
    done.store(true);
    cv_pop.notify_all();
  }
};

}  // namespace

extern "C" {

void* fp_open(const char* path, int out_size, double crop_h_frac,
              double crop_w_frac, int queue_cap) {
  auto* p = new FramePump();
  if (!p->cap.open(path)) {
    delete p;
    return nullptr;
  }
  p->out_size = out_size;
  p->crop_h = crop_h_frac;
  p->crop_w = crop_w_frac;
  p->queue_cap = queue_cap > 0 ? static_cast<size_t>(queue_cap) : 64;
  p->fps = p->cap.get(cv::CAP_PROP_FPS);
  p->nframes = static_cast<long>(p->cap.get(cv::CAP_PROP_FRAME_COUNT));
  p->height = static_cast<int>(p->cap.get(cv::CAP_PROP_FRAME_HEIGHT));
  p->width = static_cast<int>(p->cap.get(cv::CAP_PROP_FRAME_WIDTH));
  p->worker = std::thread([p] { p->run(); });
  return p;
}

int fp_meta(void* h, double* fps, long* nframes, int* height, int* width) {
  if (!h) return -1;
  auto* p = static_cast<FramePump*>(h);
  *fps = p->fps;
  *nframes = p->nframes;
  *height = p->height;
  *width = p->width;
  return 0;
}

long fp_read(void* h, unsigned char* out, long max_frames) {
  if (!h) return -1;
  auto* p = static_cast<FramePump*>(h);
  const size_t frame_bytes =
      static_cast<size_t>(p->out_size) * p->out_size * 3;
  long written = 0;
  while (written < max_frames) {
    cv::Mat frame;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_pop.wait(lk, [&] { return !p->queue.empty() || p->done.load(); });
      if (p->queue.empty()) break;  // EOF
      frame = p->queue.front();
      p->queue.pop_front();
    }
    p->cv_push.notify_one();
    std::memcpy(out + written * frame_bytes, frame.data, frame_bytes);
    ++written;
  }
  return written;
}

void fp_close(void* h) {
  if (!h) return;
  auto* p = static_cast<FramePump*>(h);
  p->stop.store(true);
  p->cv_push.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
