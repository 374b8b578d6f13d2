// specpack: memory-mapped packed spectrogram dataset + multithreaded batch
// gather, on the host.
//
// The port's copy of music_style_transfer_ldm_tpu/native/specpack.cc (same
// container, same C API). A batch is gathered from one mapped file instead
// of decoding a PNG per sample; this library provides:
//
//   * a flat binary container (built once from the ETL output):
//       header | class table | labels[u16] | images[u8: n * h * w]
//   * O(1) mmap open, zero deserialization;
//   * spk_gather_f32: gather a batch of items by index, crop to
//     (crop_h, crop_w), convert uint8 -> float32 / 255, parallelized over a
//     persistent pthread pool; spk_gather_u8: the raw bytes.
//
// C API only (stable ABI for ctypes). Built with the host C++ compiler by
// ops/_build.py build_host_library (c++ -O3 -shared -fPIC -std=c++17
// -pthread), or: python -m music_style_transfer_ldm_tpu_torch.datasets.packed
// --build
//
// Format SPK1 (little endian):
//   u32 magic 0x314B5053 ("SPK1")  u32 n_items  u32 height  u32 width
//   u32 n_classes  u32 name_table_bytes
//   name_table: n_classes x (u16 len, bytes)   (padded to 8-byte boundary)
//   labels: n_items x u16
//   data:   n_items x height x width x u8      (8-byte aligned)

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x314B5053u;  // "SPK1"

struct Header {
  uint32_t magic;
  uint32_t n_items;
  uint32_t height;
  uint32_t width;
  uint32_t n_classes;
  uint32_t name_table_bytes;
};

struct Pack {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  Header hdr{};
  const uint16_t* labels = nullptr;
  const uint8_t* data = nullptr;
};

size_t align8(size_t x) { return (x + 7) & ~size_t(7); }

// ---- persistent worker pool (avoids per-batch thread spawn cost) ---------
//
// Each ParallelFor allocates its own Task (shared_ptr): workers always
// snapshot the task they joined, so a thread that wakes late — or one that
// finishes the final item and loops once more — draws indices from *its*
// task's exhausted counter and exits, never from a newer batch and never
// through a dangling fn pointer.

class Pool {
 public:
  struct Task {
    const std::function<void(int)>* fn;
    std::atomic<int> next{0};
    int total = 0;
    std::atomic<int> pending{0};
  };

  explicit Pool(int n) : stop_(false), epoch_(0) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { Run(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> g(m_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  // Run fn(i) for i in [0, n) across the pool; blocks until done.
  void ParallelFor(int n, const std::function<void(int)>& fn) {
    if (n <= 0) return;
    auto task = std::make_shared<Task>();
    task->fn = &fn;
    task->total = n;
    task->pending.store(n);
    {
      std::lock_guard<std::mutex> g(m_);
      task_ = task;
      ++epoch_;
    }
    cv_.notify_all();
    RunTask(*task);  // the calling thread participates too
    std::unique_lock<std::mutex> lk(m_);
    done_cv_.wait(lk, [&] { return task->pending.load() == 0; });
    if (task_ == task) task_ = nullptr;  // fn is about to go out of scope
  }

 private:
  void RunTask(Task& t) {
    while (true) {
      int i = t.next.fetch_add(1);
      if (i >= t.total) break;
      (*t.fn)(i);
      if (t.pending.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> g(m_);
        done_cv_.notify_all();
      }
    }
  }

  void Run() {
    uint64_t seen = 0;
    while (true) {
      std::shared_ptr<Task> task;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&] { return stop_ || epoch_ != seen; });
        if (stop_) return;
        seen = epoch_;
        task = task_;
      }
      if (task) RunTask(*task);
    }
  }

  std::vector<std::thread> workers_;
  std::mutex m_;
  std::condition_variable cv_, done_cv_;
  bool stop_;
  uint64_t epoch_;
  std::shared_ptr<Task> task_;
};

Pool* pool() {
  static Pool* p = new Pool(
      std::max(2u, std::thread::hardware_concurrency()) - 1);
  return p;
}

}  // namespace

extern "C" {

// Opens a pack; returns an opaque handle or nullptr.
void* spk_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || size_t(st.st_size) < sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* p = new Pack();
  p->fd = fd;
  p->base = static_cast<const uint8_t*>(base);
  p->size = st.st_size;
  std::memcpy(&p->hdr, p->base, sizeof(Header));
  if (p->hdr.magic != kMagic) {
    munmap(base, st.st_size);
    ::close(fd);
    delete p;
    return nullptr;
  }
  size_t off = align8(sizeof(Header) + p->hdr.name_table_bytes);
  p->labels = reinterpret_cast<const uint16_t*>(p->base + off);
  off = align8(off + size_t(p->hdr.n_items) * sizeof(uint16_t));
  p->data = p->base + off;
  const size_t need =
      off + size_t(p->hdr.n_items) * p->hdr.height * p->hdr.width;
  if (p->size < need) {
    munmap(base, st.st_size);
    ::close(fd);
    delete p;
    return nullptr;
  }
  return p;
}

void spk_close(void* h) {
  auto* p = static_cast<Pack*>(h);
  if (!p) return;
  munmap(const_cast<uint8_t*>(p->base), p->size);
  ::close(p->fd);
  delete p;
}

uint32_t spk_n_items(void* h) { return static_cast<Pack*>(h)->hdr.n_items; }
uint32_t spk_height(void* h) { return static_cast<Pack*>(h)->hdr.height; }
uint32_t spk_width(void* h) { return static_cast<Pack*>(h)->hdr.width; }
uint32_t spk_n_classes(void* h) {
  return static_cast<Pack*>(h)->hdr.n_classes;
}

// Copies the class-name table (utf-8, '\n'-joined) into buf; returns bytes
// written (or required size if buf null).
uint32_t spk_class_names(void* h, char* buf, uint32_t cap) {
  auto* p = static_cast<Pack*>(h);
  const uint8_t* t = p->base + sizeof(Header);
  std::string joined;
  for (uint32_t i = 0; i < p->hdr.n_classes; ++i) {
    uint16_t len;
    std::memcpy(&len, t, 2);
    t += 2;
    joined.append(reinterpret_cast<const char*>(t), len);
    t += len;
    if (i + 1 < p->hdr.n_classes) joined.push_back('\n');
  }
  if (buf && cap >= joined.size())
    std::memcpy(buf, joined.data(), joined.size());
  return static_cast<uint32_t>(joined.size());
}

namespace {
bool indices_ok(const Pack* p, const int64_t* idx, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    if (idx[i] < 0 || idx[i] >= int64_t(p->hdr.n_items)) return false;
  return true;
}
}  // namespace

// Gather labels for a batch of indices; -2 on out-of-range index.
int spk_labels(void* h, const int64_t* idx, int64_t n, int32_t* out) {
  auto* p = static_cast<Pack*>(h);
  if (!indices_ok(p, idx, n)) return -2;
  for (int64_t i = 0; i < n; ++i) out[i] = p->labels[idx[i]];
  return 0;
}

// Gather a batch: out[n, crop_h, crop_w] float32 = u8 / 255, cropped from
// the top-left of each stored image. Parallel over items.
// Returns -1 on bad crop, -2 on out-of-range index.
int spk_gather_f32(void* h, const int64_t* idx, int64_t n, int32_t crop_h,
                   int32_t crop_w, float* out) {
  auto* p = static_cast<Pack*>(h);
  const int64_t H = p->hdr.height, W = p->hdr.width;
  if (crop_h > H || crop_w > W) return -1;
  if (!indices_ok(p, idx, n)) return -2;
  const int64_t item_out = int64_t(crop_h) * crop_w;
  static float lut[256];
  static std::once_flag once;
  std::call_once(once, [] {
    for (int v = 0; v < 256; ++v) lut[v] = float(v) / 255.0f;
  });
  pool()->ParallelFor(static_cast<int>(n), [&](int i) {
    const uint8_t* src = p->data + size_t(idx[i]) * H * W;
    float* dst = out + int64_t(i) * item_out;
    for (int r = 0; r < crop_h; ++r) {
      const uint8_t* srow = src + int64_t(r) * W;
      float* drow = dst + int64_t(r) * crop_w;
      for (int c = 0; c < crop_w; ++c) drow[c] = lut[srow[c]];
    }
  });
  return 0;
}

// Raw uint8 gather (no conversion) for custom host pipelines.
int spk_gather_u8(void* h, const int64_t* idx, int64_t n, uint8_t* out) {
  auto* p = static_cast<Pack*>(h);
  if (!indices_ok(p, idx, n)) return -2;
  const int64_t item = int64_t(p->hdr.height) * p->hdr.width;
  pool()->ParallelFor(static_cast<int>(n), [&](int i) {
    std::memcpy(out + int64_t(i) * item, p->data + size_t(idx[i]) * item,
                item);
  });
  return 0;
}

}  // extern "C"
