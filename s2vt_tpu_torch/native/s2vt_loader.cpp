// s2vt_loader: multithreaded prefetching .npy feature-batch loader.
//
// The port's copy of the JAX package's native/s2vt_loader.cpp, unchanged in
// behaviour. A C++ reader pool parses .npy headers, loads feature files and
// assembles contiguous fixed-shape [B, T, D] float32 batches into a bounded
// ring ahead of the training loop, so host IO overlaps device work. The
// consumer passes the output pointer of each batch, so a batch can land
// straight in pinned host memory for an asynchronous copy to the card.
//
// Built by s2vt_tpu_torch/utils/native_build.py (g++ -O3 -pthread -shared)
// into build/native/; driven through ctypes by
// s2vt_tpu_torch/data/native_loader.py. C ABI:
//   s2vt_loader_create(paths, n_files, feat_len, feat_dim, threads, depth)
//   s2vt_loader_begin(h, order, n, batch)   -- start prefetching an epoch
//   s2vt_loader_next(h, out)                -- blocking; returns #valid rows
//   s2vt_loader_failed(h)                   -- files that failed to load
//   s2vt_loader_destroy(h)

#include <atomic>
#include <memory>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  long rows = 0;
  long cols = 0;
  long data_offset = 0;
  bool f4 = false;  // little-endian float32
};

// Minimal .npy v1/v2 header parser (dtype <f4, C-order, 2-D).
bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    info->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  info->f4 = header.find("'<f4'") != std::string::npos ||
             header.find("\"<f4\"") != std::string::npos;
  if (header.find("'fortran_order': True") != std::string::npos) return false;

  size_t sp = header.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t lp = header.find('(', sp);
  size_t rp = header.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) return false;
  std::string shape = header.substr(lp + 1, rp - lp - 1);
  long rows = 0, cols = 0;
  if (sscanf(shape.c_str(), "%ld , %ld", &rows, &cols) != 2 &&
      sscanf(shape.c_str(), "%ld, %ld", &rows, &cols) != 2) {
    return false;
  }
  info->rows = rows;
  info->cols = cols;
  return true;
}

struct Loader {
  std::vector<std::string> paths;
  long feat_len;
  long feat_dim;
  int n_threads;
  int depth;

  // epoch state
  std::vector<int> order;
  int batch = 0;
  int n_batches = 0;

  // ring of assembled batches
  struct Slot {
    std::vector<float> data;
    int valid = 0;
    std::atomic<int> remaining{0};  // rows not yet filled
    bool ready = false;
  };
  std::vector<std::unique_ptr<Slot>> ring;
  std::atomic<int> next_task{0};   // next (batch, row) flat task index
  int consume_idx = 0;             // next batch the consumer takes
  std::atomic<int> produce_limit{0};  // batches the pool may work on

  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  // Epoch lifecycle: begin() sets abandon_gen = start_gen (invalidating any
  // epoch workers have started), waits for busy == 0, mutates state, then
  // bumps start_gen to release the pool. Workers never touch epoch state
  // while begin() mutates it.
  std::atomic<long> start_gen{0};
  std::atomic<long> abandon_gen{-1};
  std::atomic<int> busy{0};
  std::atomic<long> failed{0};  // count of unreadable/mismatched files

  ~Loader() {
    stop.store(true);
    cv.notify_all();
    for (auto& t : workers) t.join();
  }

  // Load file `fi`'s features into dst [feat_len, feat_dim], truncating or
  // zero-padding rows as needed (dataloader.py pads captions, not feats —
  // feature files are fixed [T, D], but be safe for ragged 'free'-mode
  // files).
  bool load_file(int fi, float* dst) {
    FILE* f = fopen(paths[fi].c_str(), "rb");
    if (!f) return false;
    NpyInfo info;
    if (!parse_npy_header(f, &info) || !info.f4 || info.cols != feat_dim) {
      fclose(f);
      return false;
    }
    long rows = info.rows < feat_len ? info.rows : feat_len;
    fseek(f, info.data_offset, SEEK_SET);
    size_t want = static_cast<size_t>(rows) * feat_dim;
    size_t got = fread(dst, sizeof(float), want, f);
    fclose(f);
    if (got != want) return false;
    if (rows < feat_len) {
      memset(dst + want, 0,
             sizeof(float) * (static_cast<size_t>(feat_len - rows) * feat_dim));
    }
    return true;
  }

  void worker() {
    long seen = 0;
    while (!stop.load()) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop.load() || start_gen.load() > seen;
        });
        if (stop.load()) return;
        seen = start_gen.load();
        busy.fetch_add(1);
      }
      // Claim row tasks in order. A claimed task is NEVER returned (a
      // returned task could be double-claimed and leave a slot's
      // `remaining` count stranded => deadlock); instead the worker waits
      // until the consumer advances produce_limit to cover it, or the
      // epoch is abandoned (begin() called before the epoch drained).
      while (true) {
        if (abandon_gen.load() >= seen) break;
        int task = next_task.fetch_add(1);
        int total = n_batches * batch;
        if (task >= total) break;  // epoch drained for this worker
        if (task >= produce_limit.load() * batch) {
          std::unique_lock<std::mutex> lk(mu);
          cv.wait(lk, [&] {
            return stop.load() || abandon_gen.load() >= seen ||
                   task < produce_limit.load() * batch;
          });
          if (stop.load()) {
            busy.fetch_sub(1);
            cv.notify_all();
            return;
          }
          if (abandon_gen.load() >= seen) break;
        }
        int b = task / batch;
        int r = task % batch;
        Slot& slot = *ring[b % depth];
        long stride = feat_len * feat_dim;
        int oi = b * batch + r;
        if (oi < static_cast<int>(order.size())) {
          if (!load_file(order[oi], slot.data.data() + r * stride)) {
            memset(slot.data.data() + r * stride, 0, sizeof(float) * stride);
            failed.fetch_add(1);
          }
        } else {
          memset(slot.data.data() + r * stride, 0, sizeof(float) * stride);
        }
        if (slot.remaining.fetch_sub(1) == 1) {
          std::lock_guard<std::mutex> lk(mu);
          slot.ready = true;
          cv.notify_all();
        }
      }
      busy.fetch_sub(1);
      {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

void* s2vt_loader_create(const char* const* paths, int n_files, long feat_len,
                         long feat_dim, int n_threads, int depth) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_files);
  L->feat_len = feat_len;
  L->feat_dim = feat_dim;
  L->n_threads = n_threads > 0 ? n_threads : 4;
  L->depth = depth > 1 ? depth : 2;
  for (int i = 0; i < L->n_threads; ++i) {
    L->workers.emplace_back([L] { L->worker(); });
  }
  return L;
}

void s2vt_loader_begin(void* h, const int* order, int n, int batch) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  // Invalidate any in-flight epoch and wait for the pool to quiesce before
  // mutating shared state (prevents use-after-free of the old ring).
  L->abandon_gen.store(L->start_gen.load());
  L->cv.notify_all();
  L->cv.wait(lk, [&] { return L->busy.load() == 0; });
  L->order.assign(order, order + n);
  L->batch = batch;
  L->n_batches = (n + batch - 1) / batch;
  L->ring.clear();
  long stride = L->feat_len * L->feat_dim;
  for (int i = 0; i < L->depth; ++i) {
    L->ring.emplace_back(new Loader::Slot());
    L->ring[i]->data.resize(static_cast<size_t>(batch) * stride);
  }
  for (int b = 0; b < L->depth && b < L->n_batches; ++b) {
    L->ring[b % L->depth]->remaining.store(batch);
    L->ring[b % L->depth]->ready = false;
  }
  L->next_task.store(0);
  L->consume_idx = 0;
  L->produce_limit.store(L->depth < L->n_batches ? L->depth : L->n_batches);
  L->start_gen.fetch_add(1);
  L->cv.notify_all();
}

// Number of files that failed to load (missing, wrong dtype/shape, short
// read) since creation. The Python wrapper raises when this advances.
long s2vt_loader_failed(void* h) {
  return static_cast<Loader*>(h)->failed.load();
}

// Blocks until the next batch is assembled; copies it to out and returns the
// number of valid rows (0 = epoch done).
int s2vt_loader_next(void* h, float* out) {
  auto* L = static_cast<Loader*>(h);
  if (L->consume_idx >= L->n_batches) return 0;
  int b = L->consume_idx;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    Loader::Slot& slot = *L->ring[b % L->depth];
    L->cv.wait(lk, [&] { return slot.ready; });
    long stride = L->feat_len * L->feat_dim;
    memcpy(out, slot.data.data(),
           sizeof(float) * static_cast<size_t>(L->batch) * stride);
    // recycle the slot for batch b + depth
    int nb = b + L->depth;
    if (nb < L->n_batches) {
      slot.remaining.store(L->batch);
      slot.ready = false;
      L->produce_limit.fetch_add(1);
    }
  }
  L->cv.notify_all();
  L->consume_idx++;
  int n = static_cast<int>(L->order.size());
  int valid = n - b * L->batch;
  if (valid > L->batch) valid = L->batch;
  return valid;
}

void s2vt_loader_destroy(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
