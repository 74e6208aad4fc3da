// Threaded batch-assembly engine for the data pipeline.
//
// The port's copy of diffusesg_tpu/data/native/batcher.cc, the counterpart
// of the reference DataLoader's C++ worker pool (reference:
// DiffuseSG/utils/dataloader.py:29-32 -- torch DataLoader with num_workers,
// whose gather/collate runs in libtorch's native workers).  The dataset
// already lives in packed host arrays, so the only hot host work is the
// per-batch row gather; this engine runs it in C++ threads (GIL-free) with a
// bounded ring of pre-assembled batches so batch i+1/i+2 are being gathered
// while Python consumes batch i.
//
// One handle == one epoch: the permutation is fixed at creation and the
// handle is destroyed at epoch end (or early generator exit), so there are
// no epoch-transition races by construction.
//
// Contract: single consumer; arrays are row-major contiguous; perm values
// are in [0, num_rows).
#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<std::vector<char>> bufs;  // one staging buffer per array
  int64_t rows = 0;
  int64_t batch_idx = -1;  // -1 = free
  bool ready = false;
};

struct Batcher {
  int num_arrays = 0;
  std::vector<const char*> bases;
  std::vector<int64_t> row_bytes;
  int64_t num_rows = 0;
  int64_t batch_size = 0;
  std::vector<int64_t> perm;
  int64_t num_batches = 0;

  std::vector<Slot> slots;
  int64_t fill_cursor = 0;     // next batch index to be claimed by a worker
  int64_t next_consume = 0;    // next batch index the consumer expects
  bool stop = false;

  std::mutex mu;
  std::condition_variable cv_work;   // workers: a slot became free / stop
  std::condition_variable cv_ready;  // consumer: a batch became ready
  std::vector<std::thread> workers;

  void worker_loop() {
    for (;;) {
      int64_t b;
      Slot* s;
      {
        std::unique_lock<std::mutex> l(mu);
        cv_work.wait(l, [&] {
          return stop || (fill_cursor < num_batches &&
                          slots[fill_cursor % slots.size()].batch_idx == -1);
        });
        if (stop) return;
        b = fill_cursor++;
        s = &slots[b % slots.size()];
        s->batch_idx = b;
        s->ready = false;
      }
      const int64_t start = b * batch_size;
      const int64_t rows = std::min(batch_size, num_rows - start);
      for (int a = 0; a < num_arrays; ++a) {
        const int64_t rb = row_bytes[a];
        char* dst = s->bufs[a].data();
        const char* base = bases[a];
        for (int64_t r = 0; r < rows; ++r)
          std::memcpy(dst + r * rb, base + perm[start + r] * rb, rb);
      }
      {
        std::lock_guard<std::mutex> l(mu);
        s->rows = rows;
        s->ready = true;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* batcher_create(int num_arrays, const void** bases,
                     const int64_t* row_bytes, int64_t num_rows,
                     const int64_t* perm, int64_t perm_len,
                     int64_t batch_size, int depth, int num_threads) {
  // bounds-check the permutation against the SOURCE array length up front:
  // a bad index would otherwise become a silent out-of-bounds memcpy in a
  // worker thread
  for (int64_t i = 0; i < perm_len; ++i)
    if (perm[i] < 0 || perm[i] >= num_rows) return nullptr;
  auto* h = new Batcher();
  h->num_arrays = num_arrays;
  for (int a = 0; a < num_arrays; ++a) {
    h->bases.push_back(static_cast<const char*>(bases[a]));
    h->row_bytes.push_back(row_bytes[a]);
  }
  h->num_rows = perm_len;  // rows addressed THROUGH the permutation
  h->batch_size = batch_size;
  h->perm.assign(perm, perm + perm_len);
  h->num_batches = (perm_len + batch_size - 1) / batch_size;
  depth = std::max(1, depth);
  h->slots.resize(static_cast<size_t>(depth));
  for (auto& s : h->slots) {
    s.bufs.resize(num_arrays);
    for (int a = 0; a < num_arrays; ++a)
      s.bufs[a].resize(static_cast<size_t>(batch_size * row_bytes[a]));
  }
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const int nt = std::max(1, std::min<int>(num_threads,
                                           static_cast<int>(hw)));
  for (int t = 0; t < nt; ++t)
    h->workers.emplace_back([h] { h->worker_loop(); });
  return h;
}

// Blocks until the next batch is assembled, copies it into the caller's
// buffers (each sized batch_size * row_bytes[a]), and recycles the slot.
// Returns the number of valid rows; 0 when the epoch is exhausted.
int64_t batcher_next(void* handle, void** out_ptrs) {
  auto* h = static_cast<Batcher*>(handle);
  Slot* s;
  int64_t rows;
  {
    std::unique_lock<std::mutex> l(h->mu);
    if (h->next_consume >= h->num_batches) return 0;
    s = &h->slots[h->next_consume % h->slots.size()];
    h->cv_ready.wait(l, [&] {
      return s->ready && s->batch_idx == h->next_consume;
    });
    rows = s->rows;
  }
  for (int a = 0; a < h->num_arrays; ++a)
    std::memcpy(out_ptrs[a], s->bufs[a].data(),
                static_cast<size_t>(rows * h->row_bytes[a]));
  {
    std::lock_guard<std::mutex> l(h->mu);
    s->batch_idx = -1;
    s->ready = false;
    ++h->next_consume;
  }
  h->cv_work.notify_all();
  return rows;
}

void batcher_destroy(void* handle) {
  auto* h = static_cast<Batcher*>(handle);
  {
    std::lock_guard<std::mutex> l(h->mu);
    h->stop = true;
  }
  h->cv_work.notify_all();
  for (auto& w : h->workers) w.join();
  delete h;
}

}  // extern "C"
