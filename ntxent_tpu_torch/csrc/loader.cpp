// Threaded batch-gather engine of the port's native loader
// (ntxent_tpu_torch/training/native_loader.py), host C++ built with the
// host compiler at first use (ntxent_tpu_torch/ops/_build.py).
//
// Python keeps the loading policy: the seeded epoch order, each rank's
// rows and the resume position live in one place (ShardedShuffle,
// training/datasets.py) whatever the engine. This engine gathers the
// scattered rows of a memory-mapped row store into dense batch buffers
// on a pool of worker threads, `queue_depth` batches ahead of the
// consumer, outside the GIL.
//
// C ABI (bound with ctypes):
//   ntx_loader_open(path, offset, n_rows, row_bytes, batch_rows,
//                   num_threads, queue_depth) -> handle | NULL
//   ntx_loader_submit(handle, indices, count, out) -> 0 | -1  (blocking)
//   ntx_loader_next(handle)                   -> rows | -1    (blocking)
//   ntx_loader_outstanding(handle)            -> #batches in flight
//   ntx_loader_close(handle)
//
// submit() queues one batch's row indices (count <= batch_rows; a short
// last batch is fine) with the buffer the batch is gathered into, and
// blocks while `queue_depth` batches are in flight. Workers write
// straight into that buffer, which the caller keeps alive and untouched
// until the matching next() returns. next() blocks until the oldest
// submitted batch is complete and returns its row count: batches come
// back in submission order, whatever order the workers finish in. Rows
// are checked against [0, n_rows) at submit.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<int64_t> idx;
  uint8_t* dst = nullptr;  // caller-owned destination (alive until next())
  int remaining = 0;       // gather chunks still outstanding (under mu)
  bool ready = false;
};

// One unit of worker work: rows [lo, hi) of slot `sid`. Batches are split
// into ~num_threads chunks at submit time so a single large batch uses
// the whole pool (intra-batch parallelism), not just one worker — without
// it, effective parallelism would be min(num_threads, queue_depth).
struct Chunk {
  int sid;
  int64_t lo, hi;
};

struct Loader {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_len = 0;
  int64_t offset = 0;
  int64_t n_rows = 0;
  int64_t row_bytes = 0;
  int64_t batch_rows = 0;

  int num_threads = 1;
  std::vector<Slot> slots;
  std::deque<int> free_ids;    // slots available to submit into
  std::deque<Chunk> work;      // gather chunks awaiting a worker
  std::deque<int> order;       // submission order, consumed by next()
  std::mutex mu;
  std::condition_variable cv_work, cv_ready, cv_space, cv_drain;
  std::vector<std::thread> workers;
  int active_calls = 0;  // blocked/running submit()/next() calls
  bool stop = false;
};

// Counts a caller inside submit()/next() so close() can wait for them to
// drain before freeing the Loader — without this, a consumer thread
// blocked in a wait() would wake up inside freed memory.
struct CallGuard {
  Loader* ld;
  explicit CallGuard(Loader* l) : ld(l) {
    std::lock_guard<std::mutex> lk(ld->mu);
    ++ld->active_calls;
  }
  ~CallGuard() {
    {
      std::lock_guard<std::mutex> lk(ld->mu);
      --ld->active_calls;
    }
    ld->cv_drain.notify_all();
  }
};

void worker_main(Loader* ld) {
  for (;;) {
    Chunk c;
    {
      std::unique_lock<std::mutex> lk(ld->mu);
      ld->cv_work.wait(lk, [&] { return ld->stop || !ld->work.empty(); });
      if (ld->stop) return;
      c = ld->work.front();
      ld->work.pop_front();
    }
    Slot& s = ld->slots[c.sid];
    const uint8_t* base = ld->map + ld->offset;
    for (int64_t r = c.lo; r < c.hi; ++r)
      std::memcpy(s.dst + r * ld->row_bytes,
                  base + s.idx[static_cast<size_t>(r)] * ld->row_bytes,
                  static_cast<size_t>(ld->row_bytes));
    bool done;
    {
      std::lock_guard<std::mutex> lk(ld->mu);
      done = (--s.remaining == 0);
      if (done) s.ready = true;
    }
    if (done) ld->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* ntx_loader_open(const char* path, int64_t offset, int64_t n_rows,
                      int64_t row_bytes, int64_t batch_rows,
                      int32_t num_threads, int32_t queue_depth) {
  if (!path || offset < 0 || n_rows <= 0 || row_bytes <= 0 ||
      batch_rows <= 0 || num_threads <= 0 || queue_depth <= 0)
    return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 ||
      st.st_size < offset + n_rows * row_bytes) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                     MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* ld = new Loader();
  ld->num_threads = num_threads;
  ld->fd = fd;
  ld->map = static_cast<const uint8_t*>(map);
  ld->map_len = static_cast<size_t>(st.st_size);
  ld->offset = offset;
  ld->n_rows = n_rows;
  ld->row_bytes = row_bytes;
  ld->batch_rows = batch_rows;
  ld->slots.resize(static_cast<size_t>(queue_depth));
  for (int i = 0; i < queue_depth; ++i) ld->free_ids.push_back(i);
  ld->workers.reserve(static_cast<size_t>(num_threads));
  for (int i = 0; i < num_threads; ++i)
    ld->workers.emplace_back(worker_main, ld);
  return ld;
}

int ntx_loader_submit(void* h, const int64_t* indices, int64_t count,
                      uint8_t* out) {
  auto* ld = static_cast<Loader*>(h);
  if (!ld || !indices || !out || count <= 0 || count > ld->batch_rows)
    return -1;
  for (int64_t i = 0; i < count; ++i)
    if (indices[i] < 0 || indices[i] >= ld->n_rows) return -1;
  CallGuard guard(ld);
  int sid;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->cv_space.wait(lk, [&] { return ld->stop || !ld->free_ids.empty(); });
    if (ld->stop) return -1;
    sid = ld->free_ids.front();
    ld->free_ids.pop_front();
    Slot& s = ld->slots[sid];
    s.idx.assign(indices, indices + count);
    s.dst = out;
    s.ready = false;
    int64_t chunks = ld->num_threads < count ? ld->num_threads : count;
    int64_t per = (count + chunks - 1) / chunks;
    s.remaining = 0;
    for (int64_t lo = 0; lo < count; lo += per) {
      ld->work.push_back({sid, lo, lo + per < count ? lo + per : count});
      ++s.remaining;
    }
    ld->order.push_back(sid);
  }
  ld->cv_work.notify_all();
  return 0;
}

int64_t ntx_loader_next(void* h) {
  auto* ld = static_cast<Loader*>(h);
  if (!ld) return -1;
  CallGuard guard(ld);
  int64_t rows;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    if (ld->order.empty()) return -1;  // nothing submitted: caller bug
    int sid = ld->order.front();
    ld->cv_ready.wait(lk, [&] { return ld->stop || ld->slots[sid].ready; });
    if (ld->stop) return -1;
    rows = static_cast<int64_t>(ld->slots[sid].idx.size());
    ld->order.pop_front();
    ld->free_ids.push_back(sid);
  }
  ld->cv_space.notify_one();
  return rows;
}

int64_t ntx_loader_outstanding(void* h) {
  auto* ld = static_cast<Loader*>(h);
  if (!ld) return -1;
  std::lock_guard<std::mutex> lk(ld->mu);
  return static_cast<int64_t>(ld->order.size());
}

void ntx_loader_close(void* h) {
  auto* ld = static_cast<Loader*>(h);
  if (!ld) return;
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stop = true;
  }
  ld->cv_work.notify_all();
  ld->cv_ready.notify_all();
  ld->cv_space.notify_all();
  {
    // Wait for any caller still blocked in submit()/next() to observe
    // `stop` and leave before the Loader is freed under it.
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->cv_drain.wait(lk, [&] { return ld->active_calls == 0; });
  }
  for (auto& t : ld->workers) t.join();
  ::munmap(const_cast<uint8_t*>(ld->map), ld->map_len);
  ::close(ld->fd);
  delete ld;
}

}  // extern "C"
