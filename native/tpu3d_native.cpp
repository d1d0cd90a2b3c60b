// tpu3d native runtime — host-side C++ components.
//
// The reference keeps its host runtime in C++ (thread_pool.hpp, the PLY
// parser at registration.cpp:416-461, per-instance mask prep in
// pipeline.cpp:39-55). This library provides the framework's native
// equivalents at the host edge, exposed through a plain C ABI consumed via
// ctypes (tpu3d/native.py); the device compute path stays JAX/XLA/Pallas.
//
// Components:
//   - ThreadPool: fixed worker pool, mutex+condvar queue (parity with
//     include/thread_pool.hpp:14-80).
//   - t3d_load_ply: ASCII + binary_little_endian PLY vertex parser with the
//     reference's semantics (vertex count from header, red/diffuse_red
//     color detection, /255 normalization when any component > 1).
//   - t3d_resize_mask_nearest: nearest-neighbor mask resize + binary
//     threshold at 10 (cv::resize INTER_NEAREST + cv::threshold,
//     pipeline.cpp:39-41 + :50-52), parallelized over row bands.
//
// Build: make -C native   (produces libtpu3d_native.so)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <functional>
#include <mutex>
#include <queue>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
          if (--in_flight_ == 0) {
            std::unique_lock<std::mutex> lock(mu_);
            done_cv_.notify_all();
          }
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void enqueue(std::function<void()> f) {
    ++in_flight_;
    {
      std::unique_lock<std::mutex> lock(mu_);
      if (stop_) {
        // Parity with the reference pool, which throws on enqueue after
        // stop (include/thread_pool.hpp:72-74).
        --in_flight_;
        throw std::runtime_error("tpu3d pool: enqueue after stop()");
      }
      tasks_.push(std::move(f));
    }
    cv_.notify_one();
  }

  void wait_all() {
    std::unique_lock<std::mutex> lock(mu_);
    done_cv_.wait(lock, [this] { return in_flight_.load() == 0; });
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  std::atomic<int> in_flight_{0};
  bool stop_;
};

struct PlyProp {
  std::string name;
  int size;       // bytes
  bool integer;   // integer type (needs int->float conversion)
  bool is_signed; // signed integer (needs sign extension)
};

int type_size(const std::string& t, bool* integer, bool* is_signed) {
  *integer = true;
  *is_signed = false;
  if (t == "float" || t == "float32") { *integer = false; return 4; }
  if (t == "double" || t == "float64") { *integer = false; return 8; }
  if (t == "char" || t == "int8") { *is_signed = true; return 1; }
  if (t == "short" || t == "int16") { *is_signed = true; return 2; }
  if (t == "int" || t == "int32") { *is_signed = true; return 4; }
  if (t == "uchar" || t == "uint8") return 1;
  if (t == "ushort" || t == "uint16") return 2;
  if (t == "uint" || t == "uint32") return 4;
  return -1;
}

double read_prop(const unsigned char* p, const PlyProp& prop) {
  if (!prop.integer) {
    if (prop.size == 4) { float v; std::memcpy(&v, p, 4); return v; }
    double v; std::memcpy(&v, p, 8); return v;
  }
  if (prop.is_signed) {
    // Sign-extend by declared width so negative integer coordinates load
    // correctly (matches the Python fallback parser).
    switch (prop.size) {
      case 1: { int8_t v; std::memcpy(&v, p, 1); return v; }
      case 2: { int16_t v; std::memcpy(&v, p, 2); return v; }
      default: { int32_t v; std::memcpy(&v, p, 4); return v; }
    }
  }
  uint32_t v = 0;
  std::memcpy(&v, p, prop.size);
  return static_cast<double>(v);
}

}  // namespace

extern "C" {

int t3d_version() { return 1; }

void t3d_free(void* p) { std::free(p); }

// Parses vertices from a PLY file. Returns 0 on success.
// *points receives malloc'd float[3n]; *colors float[3n] or nullptr.
int t3d_load_ply(const char* path, float** points, float** colors, int* n) {
  *points = nullptr;
  *colors = nullptr;
  *n = 0;
  std::ifstream f(path, std::ios::binary);
  if (!f.is_open()) return 1;

  std::string line, format = "ascii";
  int vertex_count = 0;
  std::vector<PlyProp> props;
  bool in_vertex = false;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    std::istringstream ss(line);
    std::string tok;
    ss >> tok;
    if (tok == "format") {
      ss >> format;
    } else if (tok == "element") {
      std::string name;
      int cnt;
      ss >> name >> cnt;
      in_vertex = (name == "vertex");
      if (in_vertex) vertex_count = cnt;
    } else if (tok == "property" && in_vertex) {
      std::string type, name;
      ss >> type >> name;
      if (type == "list") continue;  // not a vertex scalar
      bool integer, is_signed;
      int size = type_size(type, &integer, &is_signed);
      if (size < 0) return 2;
      props.push_back({name, size, integer, is_signed});
    } else if (tok == "end_header") {
      break;
    }
  }
  if (vertex_count <= 0 || props.empty()) return 3;

  int xi = -1, yi = -1, zi = -1, ri = -1, gi = -1, bi = -1;
  for (size_t i = 0; i < props.size(); ++i) {
    const std::string& nm = props[i].name;
    if (nm == "x") xi = (int)i;
    else if (nm == "y") yi = (int)i;
    else if (nm == "z") zi = (int)i;
    else if (nm == "red" || nm == "diffuse_red") ri = (int)i;
    else if (nm == "green" || nm == "diffuse_green") gi = (int)i;
    else if (nm == "blue" || nm == "diffuse_blue") bi = (int)i;
  }
  if (xi < 0 || yi < 0 || zi < 0) return 4;
  bool has_color = ri >= 0 && gi >= 0 && bi >= 0;

  float* pts = (float*)std::malloc(sizeof(float) * 3 * vertex_count);
  float* cols =
      has_color ? (float*)std::malloc(sizeof(float) * 3 * vertex_count)
                : nullptr;
  if (!pts || (has_color && !cols)) {
    std::free(pts);
    std::free(cols);
    return 5;
  }

  if (format == "ascii") {
    for (int i = 0; i < vertex_count; ++i) {
      if (!std::getline(f, line)) { std::free(pts); std::free(cols); return 6; }
      std::istringstream ss(line);
      std::vector<double> vals(props.size(), 0.0);
      for (size_t j = 0; j < props.size(); ++j) ss >> vals[j];
      pts[3 * i + 0] = (float)vals[xi];
      pts[3 * i + 1] = (float)vals[yi];
      pts[3 * i + 2] = (float)vals[zi];
      if (has_color) {
        cols[3 * i + 0] = (float)vals[ri];
        cols[3 * i + 1] = (float)vals[gi];
        cols[3 * i + 2] = (float)vals[bi];
      }
    }
  } else if (format == "binary_little_endian") {
    int stride = 0;
    std::vector<int> offsets(props.size());
    for (size_t j = 0; j < props.size(); ++j) {
      offsets[j] = stride;
      stride += props[j].size;
    }
    std::vector<unsigned char> buf((size_t)stride * vertex_count);
    f.read((char*)buf.data(), buf.size());
    if (f.gcount() != (std::streamsize)buf.size()) {
      std::free(pts); std::free(cols); return 6;
    }
    int nthreads = (int)std::thread::hardware_concurrency();
    if (nthreads < 1) nthreads = 1;
    ThreadPool pool(nthreads);
    int band = (vertex_count + nthreads - 1) / nthreads;
    for (int b = 0; b < nthreads; ++b) {
      int lo = b * band, hi = std::min(vertex_count, lo + band);
      if (lo >= hi) break;
      pool.enqueue([&, lo, hi] {
        for (int i = lo; i < hi; ++i) {
          const unsigned char* rec = buf.data() + (size_t)i * stride;
          pts[3 * i + 0] = (float)read_prop(rec + offsets[xi], props[xi]);
          pts[3 * i + 1] = (float)read_prop(rec + offsets[yi], props[yi]);
          pts[3 * i + 2] = (float)read_prop(rec + offsets[zi], props[zi]);
          if (has_color) {
            cols[3 * i + 0] = (float)read_prop(rec + offsets[ri], props[ri]);
            cols[3 * i + 1] = (float)read_prop(rec + offsets[gi], props[gi]);
            cols[3 * i + 2] = (float)read_prop(rec + offsets[bi], props[bi]);
          }
        }
      });
    }
    pool.wait_all();
  } else {
    std::free(pts); std::free(cols);
    return 7;  // big-endian unsupported
  }

  // Normalize colors if any component exceeds 1 (registration.cpp:453).
  if (has_color) {
    bool over = false;
    for (int i = 0; i < 3 * vertex_count && !over; ++i) over = cols[i] > 1.0f;
    if (over)
      for (int i = 0; i < 3 * vertex_count; ++i) cols[i] /= 255.0f;
  }

  *points = pts;
  *colors = cols;
  *n = vertex_count;
  return 0;
}

// Nearest-neighbor resize of a u8 mask to (out_h, out_w) with binary
// threshold at 10 → 255/0, parallel over row bands.
int t3d_resize_mask_nearest(const unsigned char* mask, int in_h, int in_w,
                            unsigned char* out, int out_h, int out_w,
                            int nthreads) {
  if (!mask || !out || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0)
    return 1;
  if (nthreads < 1) nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  std::vector<int> xs(out_w);
  for (int x = 0; x < out_w; ++x)
    xs[x] = std::min((int)((int64_t)x * in_w / out_w), in_w - 1);

  ThreadPool pool(nthreads);
  int band = (out_h + nthreads - 1) / nthreads;
  for (int b = 0; b < nthreads; ++b) {
    int lo = b * band, hi = std::min(out_h, lo + band);
    if (lo >= hi) break;
    pool.enqueue([&, lo, hi] {
      for (int y = lo; y < hi; ++y) {
        int sy = std::min((int)((int64_t)y * in_h / out_h), in_h - 1);
        const unsigned char* src = mask + (size_t)sy * in_w;
        unsigned char* dst = out + (size_t)y * out_w;
        for (int x = 0; x < out_w; ++x)
          dst[x] = src[xs[x]] > 10 ? 255 : 0;
      }
    });
  }
  pool.wait_all();
  return 0;
}

// Opaque thread-pool handles for host-side orchestration experiments.
void* t3d_pool_create(int n) { return new ThreadPool(n < 1 ? 1 : n); }
void t3d_pool_destroy(void* pool) { delete (ThreadPool*)pool; }

}  // extern "C"
