// Native host-side data loader for tpurpn.
//
// Plays the role the reference delegates to tf.data's C++ worker threads
// (SURVEY.md §2 row 7): producing fixed-shape, padded detection batches fast
// enough to feed a TPU running thousands of images/sec. The Python generator
// (tpurpn.data.SyntheticVOC.sample) manages ~240 img/s single-threaded; this
// OpenMP loader fills batches at >10k img/s.
//
// Deterministic per (seed, index) like the Python twin (its own splitmix64
// RNG — values differ from numpy's Philox, format and distribution match).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC dataloader.cpp
//        -o libtpurpn_data.so      (done on demand by native/__init__.py)

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  // uniform double in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
  uint32_t uniform_int(uint32_t lo, uint32_t hi_excl) {  // [lo, hi)
    return lo + static_cast<uint32_t>(next() % (hi_excl - lo));
  }
};

void generate_one(uint64_t seed, int64_t index, int raw_h, int raw_w,
                  int max_boxes, int min_boxes, int num_classes,
                  uint8_t* img, float* boxes, int32_t* labels) {
  SplitMix64 rng(seed * 1000003ull + static_cast<uint64_t>(index) + 1ull);

  // background noise in [0, 60)
  const int64_t npix = static_cast<int64_t>(raw_h) * raw_w * 3;
  for (int64_t i = 0; i < npix; i += 8) {
    uint64_t r = rng.next();
    const int64_t n = std::min<int64_t>(8, npix - i);
    for (int64_t k = 0; k < n; ++k) {
      img[i + k] = static_cast<uint8_t>((r >> (8 * k)) % 60);
    }
  }

  std::memset(boxes, 0, sizeof(float) * max_boxes * 4);
  for (int i = 0; i < max_boxes; ++i) labels[i] = -1;

  const int n = static_cast<int>(
      rng.uniform_int(static_cast<uint32_t>(min_boxes),
                      static_cast<uint32_t>(max_boxes) + 1));
  int count = 0;
  for (int obj = 0; obj < n; ++obj) {
    // rejection-sample low-overlap boxes (heavily occluded objects would be
    // unlearnable — later rectangles overwrite earlier pixels)
    float y1 = 0, x1 = 0, h = 0, w = 0;
    bool ok = false;
    for (int attempt = 0; attempt < 8 && !ok; ++attempt) {
      h = static_cast<float>(rng.uniform(0.12, 0.6));
      w = static_cast<float>(rng.uniform(0.12, 0.6));
      y1 = static_cast<float>(rng.uniform(0.0, 1.0 - h));
      x1 = static_cast<float>(rng.uniform(0.0, 1.0 - w));
      ok = true;
      for (int j = 0; j < count && ok; ++j) {
        const float* o = boxes + j * 4;
        const float iy1 = std::max(y1, o[0]);
        const float ix1 = std::max(x1, o[1]);
        const float iy2 = std::min(y1 + h, o[2]);
        const float ix2 = std::min(x1 + w, o[3]);
        const float inter = std::max(0.f, iy2 - iy1) * std::max(0.f, ix2 - ix1);
        const float uni =
            h * w + (o[2] - o[0]) * (o[3] - o[1]) - inter;
        if (inter / std::max(uni, 1e-8f) >= 0.3f) ok = false;
      }
    }
    if (!ok) continue;
    const int i = count++;
    boxes[i * 4 + 0] = y1;
    boxes[i * 4 + 1] = x1;
    boxes[i * 4 + 2] = y1 + h;
    boxes[i * 4 + 3] = x1 + w;
    labels[i] = static_cast<int32_t>(rng.uniform_int(1, num_classes + 1));

    const uint8_t r = static_cast<uint8_t>(rng.uniform_int(120, 255));
    const uint8_t g = static_cast<uint8_t>(rng.uniform_int(120, 255));
    const uint8_t b = static_cast<uint8_t>(rng.uniform_int(120, 255));
    const int py1 = static_cast<int>(y1 * raw_h);
    const int px1 = static_cast<int>(x1 * raw_w);
    const int py2 = static_cast<int>((y1 + h) * raw_h);
    const int px2 = static_cast<int>((x1 + w) * raw_w);
    for (int y = py1; y < py2; ++y) {
      uint8_t* row = img + (static_cast<int64_t>(y) * raw_w + px1) * 3;
      for (int x = px1; x < px2; ++x) {
        row[0] = r; row[1] = g; row[2] = b; row += 3;
      }
    }
  }
}

}  // namespace

extern "C" {

// Fill a whole batch in parallel. indices: int64[batch]. Outputs are
// caller-allocated contiguous arrays:
//   imgs  uint8 [batch, raw_h, raw_w, 3]
//   boxes float32[batch, max_boxes, 4]
//   labels int32[batch, max_boxes]
void tpurpn_generate_batch(uint64_t seed, const int64_t* indices, int batch,
                           int raw_h, int raw_w, int max_boxes, int min_boxes,
                           int num_classes, uint8_t* imgs, float* boxes,
                           int32_t* labels) {
  const int64_t img_stride = static_cast<int64_t>(raw_h) * raw_w * 3;
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < batch; ++b) {
    generate_one(seed, indices[b], raw_h, raw_w, max_boxes, min_boxes,
                 num_classes, imgs + b * img_stride, boxes + b * max_boxes * 4,
                 labels + b * max_boxes);
  }
}

int tpurpn_loader_version() { return 1; }

}  // extern "C"
