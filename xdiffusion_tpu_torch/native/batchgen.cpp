// Native host-side batch assembly for the input pipeline (the port's copy
// of xdiffusion_tpu/native/batchgen.cpp).
//
// The per-step host op (gather the sampled examples out of the uint8
// dataset arena and normalize to float32 in one fused pass) runs in C++
// with the GIL released, so the prefetch thread overlaps batch assembly
// with the device step. Bound through ctypes (native/__init__.py).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libbatchgen.so batchgen.cpp -lpthread

#include <cstdint>
#include <cstddef>
#include <thread>
#include <vector>

extern "C" {

// dst[i, :] = float(src[idx[i], :]) * scale  for i in [0, n_idx)
void gather_normalize_u8(const uint8_t* src, const int64_t* idx,
                         int64_t n_idx, int64_t item_elems, float scale,
                         float* dst, int n_threads) {
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      const uint8_t* s = src + idx[i] * item_elems;
      float* d = dst + i * item_elems;
      for (int64_t j = 0; j < item_elems; ++j) d[j] = s[j] * scale;
    }
  };
  if (n_threads <= 1 || n_idx < 2 * n_threads) {
    worker(0, n_idx);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b = t * chunk;
    int64_t e = b + chunk < n_idx ? b + chunk : n_idx;
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
}

// dst[i] = int32(src[idx[i]])
void gather_i32(const int32_t* src, const int64_t* idx, int64_t n_idx,
                int32_t* dst) {
  for (int64_t i = 0; i < n_idx; ++i) dst[i] = src[idx[i]];
}

}  // extern "C"
