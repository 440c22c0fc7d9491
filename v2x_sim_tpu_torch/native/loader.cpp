// Native data-loading runtime: threaded .pcd.bin batch reader (the port's
// copy of v2x_sim_tpu/native/loader.cpp).
//
// An in-process C++ thread pool: each worker mmap-free streams one nuScenes-format
// .pcd.bin sweep (float32 x,y,z,intensity,ring records), optionally
// applies a 4x4 rigid transform, and writes padded fixed-size point/mask
// buffers owned by the caller (numpy arrays). No GIL, no pickling, no
// per-worker process fork.
//
// C API (ctypes-friendly):
//   v2x_read_pcd_batch(paths, n_files, stride_floats, max_points,
//                      transforms_or_null, out_points, out_mask, n_threads)
//     -> 0 on success, else the (1-based) index of the first failing file.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Read one .pcd.bin file into padded (max_points, 3) + mask buffers.
// Returns true on success.
bool read_one(const char* path, int stride_floats, int64_t max_points,
              const float* transform,  // 4x4 row-major or nullptr
              float* out_points,       // (max_points, 3)
              uint8_t* out_mask) {     // (max_points,)
  std::memset(out_points, 0, sizeof(float) * 3 * max_points);
  std::memset(out_mask, 0, max_points);

  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  const size_t chunk_records = 4096;
  std::vector<float> buf(chunk_records * stride_floats);
  int64_t written = 0;
  while (written < max_points) {
    size_t got = std::fread(buf.data(), sizeof(float) * stride_floats,
                            chunk_records, f);
    if (got == 0) break;
    for (size_t r = 0; r < got && written < max_points; ++r, ++written) {
      const float* p = &buf[r * stride_floats];
      float x = p[0], y = p[1], z = p[2];
      if (transform) {
        const float* t = transform;
        float tx = t[0] * x + t[1] * y + t[2] * z + t[3];
        float ty = t[4] * x + t[5] * y + t[6] * z + t[7];
        float tz = t[8] * x + t[9] * y + t[10] * z + t[11];
        x = tx; y = ty; z = tz;
      }
      out_points[written * 3 + 0] = x;
      out_points[written * 3 + 1] = y;
      out_points[written * 3 + 2] = z;
      out_mask[written] = 1;
    }
    if (got < chunk_records) break;
  }
  std::fclose(f);
  return true;
}

}  // namespace

extern "C" {

// paths: array of n_files C strings.
// transforms: nullptr, or (n_files, 16) row-major 4x4 floats.
// out_points: (n_files, max_points, 3) float32.
// out_mask:   (n_files, max_points) uint8.
int64_t v2x_read_pcd_batch(const char** paths, int64_t n_files,
                           int32_t stride_floats, int64_t max_points,
                           const float* transforms, float* out_points,
                           uint8_t* out_mask, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> first_error(0);  // 0 = ok, else 1-based file index

  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_files) break;
      const float* t = transforms ? transforms + i * 16 : nullptr;
      bool ok = read_one(paths[i], stride_floats, max_points, t,
                         out_points + i * max_points * 3,
                         out_mask + i * max_points);
      if (!ok) {
        int64_t expect = 0;
        first_error.compare_exchange_strong(expect, i + 1);
      }
    }
  };

  std::vector<std::thread> pool;
  int32_t n = static_cast<int32_t>(
      n_files < n_threads ? n_files : n_threads);
  pool.reserve(n);
  for (int32_t k = 0; k < n; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return first_error.load();
}

}  // extern "C"
