// Native host runtime for arap_flow: reference-exact forward rasterizer,
// Middlebury .flo codec, and an asynchronous file-writer pool.
//
// Semantics replicated (not copied) from the reference CPU implementations:
// - triangle coverage + barycentric weights: the LK edge-function test of
//   ARAP/warping/src/main.cpp:68-104;
// - quad iteration, validity gating, draw order and color truncation:
//   warping/src/main.cpp:145-225 and deformation CombinedSolver.h:248-342;
// - .flo layout ('PIEH', int32 w/h, interleaved row-major float32 u,v):
//   sintel_io.py:26-73 / deformation/src/main.cpp:53-75.
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11).
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread arap_native.cpp -o libarap_native.so

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// LK edge-function point-in-triangle test; returns true and the barycentric
// weights when the pixel is covered (accept rule: not backfacing and all
// normalised edge functions >= 0).
inline bool tri_cover(float x0, float y0, float x1, float y1, float x2,
                      float y2, float sx, float sy, float* w0, float* w1,
                      float* w2) {
  float X0 = x0 - sx, X1 = x1 - sx, X2 = x2 - sx;
  float Y0 = y0 - sy, Y1 = y1 - sy, Y2 = y2 - sy;
  float d01 = X0 * Y1 - Y0 * X1;
  float d12 = X1 * Y2 - Y1 * X2;
  float d20 = X2 * Y0 - Y2 * X0;
  if ((d01 < 0) & (d12 < 0) & (d20 < 0)) return false;  // backfacing
  float inv = 1.f / (d01 + d12 + d20);
  float n01 = d01 * inv, n12 = d12 * inv, n20 = d20 * inv;
  if (!(n01 >= 0 && n12 >= 0 && n20 >= 0)) return false;  // rejects NaN too
  *w0 = n12;
  *w1 = n20;
  *w2 = n01;
  return true;
}

struct Vec3f {
  float r, g, b;
};

inline void paint_tri(const float* P0, const float* P1, const float* P2,
                      Vec3f c0, Vec3f c1, Vec3f c2, uint8_t* rgb_out,
                      uint8_t* cov_out, int W, int H) {
  float minx = std::floor(std::min(P0[0], std::min(P1[0], P2[0])));
  float miny = std::floor(std::min(P0[1], std::min(P1[1], P2[1])));
  float maxx = std::ceil(std::max(P0[0], std::max(P1[0], P2[0])));
  float maxy = std::ceil(std::max(P0[1], std::max(P1[1], P2[1])));
  for (int x = (int)minx; x <= (int)maxx; ++x) {
    for (int y = (int)miny; y <= (int)maxy; ++y) {
      if (x < 0 || x >= W || y < 0 || y >= H) continue;
      float w0, w1, w2;
      if (!tri_cover(P0[0], P0[1], P1[0], P1[1], P2[0], P2[1], (float)x,
                     (float)y, &w0, &w1, &w2))
        continue;
      float r = c0.r * w0 + c1.r * w1 + c2.r * w2;
      float g = c0.g * w0 + c1.g * w1 + c2.g * w2;
      float b = c0.b * w0 + c1.b * w1 + c2.b * w2;
      uint8_t* px = rgb_out + 3 * (y * W + x);
      px[0] = (uint8_t)r;  // C-cast truncation (mLib vec3uc semantics)
      px[1] = (uint8_t)g;
      px[2] = (uint8_t)b;
      cov_out[y * W + x] = 255;
    }
  }
}

}  // namespace

extern "C" {

// warp: (H, W, 2) float32 absolute positions; rgb: (H, W, 3) u8;
// mask: (H, W) u8 with 0 = drawable object. Outputs must be zero-initialised
// by the caller: out_rgb (H, W, 3), out_mask (H, W).
void raster_warp(const float* warp, const uint8_t* rgb, const uint8_t* mask,
                 int H, int W, uint8_t* out_rgb, uint8_t* out_mask) {
  auto P = [&](int y, int x) { return warp + 2 * (y * W + x); };
  auto C = [&](int y, int x) {
    const uint8_t* p = rgb + 3 * (y * W + x);
    return Vec3f{(float)p[0], (float)p[1], (float)p[2]};
  };
  for (int y = 0; y + 1 < H; ++y) {
    for (int x = 0; x + 1 < W; ++x) {
      if (mask[y * W + x] != 0) continue;
      if (mask[y * W + x + 1] != 0 || mask[(y + 1) * W + x] != 0 ||
          mask[(y + 1) * W + x + 1] != 0)
        continue;
      const float* p00 = P(y, x);
      const float* p01 = P(y, x + 1);
      const float* p10 = P(y + 1, x);
      const float* p11 = P(y + 1, x + 1);
      paint_tri(p00, p01, p10, C(y, x), C(y, x + 1), C(y + 1, x), out_rgb,
                out_mask, W, H);
      paint_tri(p10, p01, p11, C(y + 1, x), C(y, x + 1), C(y + 1, x + 1),
                out_rgb, out_mask, W, H);
    }
  }
}

// ---------------- .flo codec ----------------

int flo_write_file(const char* path, const float* uv, int W, int H) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const char tag[4] = {'P', 'I', 'E', 'H'};
  std::fwrite(tag, 1, 4, f);
  int32_t w32 = W, h32 = H;
  std::fwrite(&w32, 4, 1, f);
  std::fwrite(&h32, 4, 1, f);
  size_t n = (size_t)W * H * 2;
  size_t wrote = std::fwrite(uv, 4, n, f);
  std::fclose(f);
  return wrote == n ? 0 : -2;
}

// Reads dims only (out=nullptr) or the full payload. Returns 0 on success.
int flo_read_file(const char* path, float* out, long max_floats, int* W,
                  int* H) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  float tag;
  int32_t w32, h32;
  if (std::fread(&tag, 4, 1, f) != 1 || std::fread(&w32, 4, 1, f) != 1 ||
      std::fread(&h32, 4, 1, f) != 1) {
    std::fclose(f);
    return -2;
  }
  if (tag != 202021.25f || w32 <= 0 || h32 <= 0 || w32 > 99999 || h32 > 99999) {
    std::fclose(f);
    return -3;
  }
  *W = w32;
  *H = h32;
  if (out != nullptr) {
    long n = (long)w32 * h32 * 2;
    if (n > max_floats) {
      std::fclose(f);
      return -4;
    }
    if ((long)std::fread(out, 4, n, f) != n) {
      std::fclose(f);
      return -5;
    }
  }
  std::fclose(f);
  return 0;
}

// ---------------- async writer pool ----------------
//
// Replaces the reference's synchronous per-frame writes inside worker
// processes (para_gen.py do_arap): IO overlaps with device compute.

namespace {
struct Job {
  std::string path;
  std::vector<uint8_t> data;
  bool is_flo;
  int w, h;
};

std::deque<Job> g_queue;
std::mutex g_mu;
std::condition_variable g_cv;
std::vector<std::thread> g_threads;
std::atomic<bool> g_stop{false};
std::atomic<int> g_inflight{0};
std::atomic<long> g_errors{0};

void worker_loop() {
  for (;;) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(g_mu);
      g_cv.wait(lk, [] { return g_stop.load() || !g_queue.empty(); });
      if (g_queue.empty()) {
        if (g_stop.load()) return;
        continue;
      }
      job = std::move(g_queue.front());
      g_queue.pop_front();
    }
    int rc = 0;
    if (job.is_flo) {
      rc = flo_write_file(job.path.c_str(),
                          reinterpret_cast<const float*>(job.data.data()),
                          job.w, job.h);
    } else {
      FILE* f = std::fopen(job.path.c_str(), "wb");
      if (!f) {
        rc = -1;
      } else {
        if (std::fwrite(job.data.data(), 1, job.data.size(), f) !=
            job.data.size())
          rc = -2;
        std::fclose(f);
      }
    }
    if (rc != 0) g_errors.fetch_add(1);
    {
      // predicate state must change UNDER the condvar's mutex: decrementing
      // outside g_mu lets writer_drain() evaluate its predicate between the
      // fetch_sub and notify_all (lost wakeup -> drain blocks forever at the
      // end of a run)
      std::lock_guard<std::mutex> lk(g_mu);
      g_inflight.fetch_sub(1);
    }
    g_cv.notify_all();
  }
}
}  // namespace

void writer_start(int nthreads) {
  g_stop.store(false);
  g_errors.store(0);  // per-writer-lifecycle counter (a pipeline run's
                      // end-of-run check must not see a previous run's
                      // failures in the same process)
  for (int i = 0; i < nthreads; ++i) g_threads.emplace_back(worker_loop);
}

void writer_submit_flo(const char* path, const float* uv, int W, int H) {
  Job job;
  job.path = path;
  job.is_flo = true;
  job.w = W;
  job.h = H;
  size_t bytes = (size_t)W * H * 2 * 4;
  job.data.assign(reinterpret_cast<const uint8_t*>(uv),
                  reinterpret_cast<const uint8_t*>(uv) + bytes);
  g_inflight.fetch_add(1);
  {
    std::lock_guard<std::mutex> lk(g_mu);
    g_queue.push_back(std::move(job));
  }
  g_cv.notify_one();
}

void writer_submit_bytes(const char* path, const void* data, long n) {
  Job job;
  job.path = path;
  job.is_flo = false;
  job.w = job.h = 0;
  job.data.assign(reinterpret_cast<const uint8_t*>(data),
                  reinterpret_cast<const uint8_t*>(data) + n);
  g_inflight.fetch_add(1);
  {
    std::lock_guard<std::mutex> lk(g_mu);
    g_queue.push_back(std::move(job));
  }
  g_cv.notify_one();
}

long writer_pending() { return g_inflight.load(); }
long writer_errors() { return g_errors.load(); }

void writer_drain() {
  std::unique_lock<std::mutex> lk(g_mu);
  g_cv.wait(lk, [] { return g_queue.empty() && g_inflight.load() == 0; });
}

void writer_stop() {
  g_stop.store(true);
  g_cv.notify_all();
  for (auto& t : g_threads) t.join();
  g_threads.clear();
}

}  // extern "C"
