// Host runtime of paddle_tpu_torch (the port's copy of the reference's
// csrc/paddle_tpu_rt.cc, with the same C ABI, minus its TCP store: the
// port's store is torch.distributed.TCPStore).
//   * Arena allocator: auto-growth best-fit caching allocator with stats,
//     for host staging buffers (batch assembly before the copy to the
//     card; the card's own memory is PyTorch's caching allocator).
//   * Batch stacker: parallel memcpy of N sample buffers into one
//     contiguous batch (the hot loop of DataLoader collate), over a
//     shared thread pool.
//   * Trace buffer: host RecordEvent buffer with chrome-trace export
//     (paddle.profiler's host tracer).
//
// A plain C API loaded through ctypes (runtime/native.py builds it with
// g++ at first use). Everything is thread-safe unless noted.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

// ===========================================================================
// Arena allocator (auto-growth best-fit with coalescing free)
// ===========================================================================
namespace {

constexpr size_t kAlign = 64;

static size_t align_up(size_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }

struct Chunk;

struct Block {
  char* ptr;
  size_t size;
  bool free_;
  Chunk* chunk;
  Block* prev;  // address-ordered neighbors within the chunk
  Block* next;
  std::multimap<size_t, Block*>::iterator free_it;  // valid iff free_
};

struct Chunk {
  char* base;
  size_t size;
};

class Arena {
 public:
  explicit Arena(size_t chunk_size) : chunk_size_(chunk_size) {}

  ~Arena() {
    for (auto& c : chunks_) ::free(c->base);
    for (auto& c : chunks_) delete c;
    for (auto* b : all_blocks_) delete b;
  }

  void* alloc(size_t n) {
    n = align_up(n ? n : 1);
    std::lock_guard<std::mutex> g(mu_);
    auto it = free_blocks_.lower_bound(n);
    Block* b;
    if (it == free_blocks_.end()) {
      b = grow(n);
      if (!b) return nullptr;
    } else {
      b = it->second;
      free_blocks_.erase(it);
      b->free_ = false;
    }
    maybe_split(b, n);
    allocated_ += b->size;
    peak_ = std::max(peak_, allocated_);
    ++alloc_count_;
    live_.emplace(b->ptr, b);
    return b->ptr;
  }

  void free(void* p) {
    if (!p) return;
    std::lock_guard<std::mutex> g(mu_);
    auto it = live_.find(static_cast<char*>(p));
    if (it == live_.end()) return;  // double free / foreign pointer: ignore
    Block* b = it->second;
    live_.erase(it);
    allocated_ -= b->size;
    b->free_ = true;
    // coalesce with address neighbors
    if (b->next && b->next->free_) {
      Block* n = b->next;
      free_blocks_.erase(n->free_it);
      b->size += n->size;
      unlink(n);
    }
    if (b->prev && b->prev->free_) {
      Block* pr = b->prev;
      free_blocks_.erase(pr->free_it);
      pr->size += b->size;
      unlink(b);
      b = pr;
    }
    b->free_it = free_blocks_.emplace(b->size, b);
  }

  // out: allocated, reserved, peak_allocated, alloc_count
  void stats(uint64_t out[4]) {
    std::lock_guard<std::mutex> g(mu_);
    out[0] = allocated_;
    out[1] = reserved_;
    out[2] = peak_;
    out[3] = alloc_count_;
  }

 private:
  // Block records killed by coalescing are recycled through block_pool_;
  // without recycling every alloc/free cycle that splits+coalesces would
  // retain one dead record forever (unbounded growth in a long-lived arena).
  Block* new_block(char* ptr, size_t size, bool is_free, Chunk* c, Block* prev,
                   Block* next) {
    Block* b;
    if (!block_pool_.empty()) {
      b = block_pool_.back();
      block_pool_.pop_back();
    } else {
      b = new Block;
      all_blocks_.push_back(b);
    }
    *b = Block{ptr, size, is_free, c, prev, next, {}};
    return b;
  }

  Block* grow(size_t n) {
    size_t sz = std::max(n, chunk_size_);
    char* base = static_cast<char*>(::malloc(sz));
    if (!base) return nullptr;
    auto* c = new Chunk{base, sz};
    chunks_.push_back(c);
    reserved_ += sz;
    return new_block(base, sz, false, c, nullptr, nullptr);
  }

  void maybe_split(Block* b, size_t n) {
    if (b->size >= n + kAlign * 2) {
      Block* rest =
          new_block(b->ptr + n, b->size - n, true, b->chunk, b, b->next);
      if (b->next) b->next->prev = rest;
      b->next = rest;
      b->size = n;
      rest->free_it = free_blocks_.emplace(rest->size, rest);
    }
  }

  void unlink(Block* b) {
    if (b->prev) b->prev->next = b->next;
    if (b->next) b->next->prev = b->prev;
    b->size = 0;
    b->free_ = false;
    block_pool_.push_back(b);
  }

  std::mutex mu_;
  size_t chunk_size_;
  std::multimap<size_t, Block*> free_blocks_;
  std::unordered_map<char*, Block*> live_;
  std::vector<Chunk*> chunks_;
  std::vector<Block*> all_blocks_;   // ownership (for ~Arena)
  std::vector<Block*> block_pool_;   // dead records available for reuse
  uint64_t allocated_ = 0, reserved_ = 0, peak_ = 0, alloc_count_ = 0;
};

}  // namespace

PT_EXPORT void* pt_arena_create(uint64_t chunk_size) {
  return new Arena(chunk_size ? chunk_size : (64u << 20));
}
PT_EXPORT void pt_arena_destroy(void* a) { delete static_cast<Arena*>(a); }
PT_EXPORT void* pt_arena_alloc(void* a, uint64_t n) {
  return static_cast<Arena*>(a)->alloc(n);
}
PT_EXPORT void pt_arena_free(void* a, void* p) {
  static_cast<Arena*>(a)->free(p);
}
PT_EXPORT void pt_arena_stats(void* a, uint64_t out[4]) {
  static_cast<Arena*>(a)->stats(out);
}

// ===========================================================================
// Thread pool + batch stacker
// ===========================================================================
namespace {

class Pool {
 public:
  explicit Pool(int n) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { run(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> g(mu_);
      q_.push_back(std::move(f));
    }
    cv_.notify_one();
  }
  size_t size() const { return workers_.size(); }

 private:
  void run() {
    for (;;) {
      std::function<void()> f;
      {
        std::unique_lock<std::mutex> l(mu_);
        cv_.wait(l, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        f = std::move(q_.front());
        q_.pop_front();
      }
      f();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::function<void()>> q_;
  std::vector<std::thread> workers_;
  bool stop_ = false;
};

Pool* global_pool(int nthreads) {
  static Pool* p = new Pool(std::max(
      1, nthreads > 0 ? nthreads
                      : static_cast<int>(std::thread::hardware_concurrency())));
  return p;
}

}  // namespace

// Stack n equally-sized sample buffers into dst (contiguous batch).
// Parallelized over samples via the shared pool; caller may release the GIL.
PT_EXPORT void pt_stack(void* dst, void* const* srcs, int64_t n,
                        uint64_t bytes_per_sample, int nthreads) {
  char* d = static_cast<char*>(dst);
  if (n <= 0) return;
  // Small batches: do it inline, the pool handoff would dominate.
  if (static_cast<uint64_t>(n) * bytes_per_sample < (1u << 20) || n == 1) {
    for (int64_t i = 0; i < n; ++i)
      memcpy(d + i * bytes_per_sample, srcs[i], bytes_per_sample);
    return;
  }
  Pool* pool = global_pool(nthreads);
  int shards = static_cast<int>(std::min<int64_t>(n, pool->size()));
  // done is incremented under mu: if it were bumped outside, the caller's
  // wait predicate could observe completion and destroy mu/cv while the
  // last worker is still about to lock/notify them (use-after-free).
  int done = 0;
  std::mutex mu;
  std::condition_variable cv;
  int64_t per = (n + shards - 1) / shards;
  for (int s = 0; s < shards; ++s) {
    int64_t lo = s * per, hi = std::min<int64_t>(n, lo + per);
    pool->submit([=, &done, &mu, &cv] {
      for (int64_t i = lo; i < hi; ++i)
        memcpy(d + i * bytes_per_sample, srcs[i], bytes_per_sample);
      {
        std::lock_guard<std::mutex> g(mu);
        ++done;
        // notify while holding mu: the caller can only re-check the
        // predicate (and destroy mu/cv on return) after we release, so the
        // worker is guaranteed done touching both by then.
        cv.notify_all();
      }
    });
  }
  std::unique_lock<std::mutex> l(mu);
  cv.wait(l, [&] { return done == shards; });
}

// ===========================================================================
// Trace buffer (host RecordEvent ring + chrome trace export)
// ===========================================================================
namespace {

struct TraceEvent {
  std::string name;
  std::string cat;
  int64_t ts_ns;
  int64_t dur_ns;
  int64_t tid;
};

struct Tracer {
  std::mutex mu;
  std::vector<TraceEvent> events;
  bool on = false;
  size_t cap = 1u << 20;
};

Tracer& tracer() {
  static Tracer t;
  return t;
}

void json_escape(const std::string& s, std::string* out) {
  for (char c : s) {
    if (c == '"' || c == '\\') {
      out->push_back('\\');
      out->push_back(c);
    } else if (static_cast<unsigned char>(c) >= 0x20) {
      out->push_back(c);
    }
  }
}

}  // namespace

PT_EXPORT int64_t pt_now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

PT_EXPORT void pt_trace_start() {
  auto& t = tracer();
  std::lock_guard<std::mutex> g(t.mu);
  t.events.clear();
  t.on = true;
}

PT_EXPORT void pt_trace_stop() {
  auto& t = tracer();
  std::lock_guard<std::mutex> g(t.mu);
  t.on = false;
}

PT_EXPORT int pt_trace_enabled() { return tracer().on ? 1 : 0; }

PT_EXPORT void pt_trace_record(const char* name, const char* cat,
                               int64_t ts_ns, int64_t dur_ns, int64_t tid) {
  auto& t = tracer();
  std::lock_guard<std::mutex> g(t.mu);
  if (!t.on || t.events.size() >= t.cap) return;
  t.events.push_back(TraceEvent{name ? name : "", cat ? cat : "op", ts_ns,
                                dur_ns, tid});
}

PT_EXPORT int64_t pt_trace_count() {
  auto& t = tracer();
  std::lock_guard<std::mutex> g(t.mu);
  return static_cast<int64_t>(t.events.size());
}

// Export chrome-trace "traceEvents" JSON array into out (utf-8).
// Returns bytes needed; writes at most cap bytes. Call with cap=0 to size.
PT_EXPORT int64_t pt_trace_export(char* out, int64_t cap) {
  auto& t = tracer();
  std::lock_guard<std::mutex> g(t.mu);
  std::string s = "[";
  for (size_t i = 0; i < t.events.size(); ++i) {
    auto& e = t.events[i];
    if (i) s += ",";
    s += "{\"name\":\"";
    json_escape(e.name, &s);
    s += "\",\"cat\":\"";
    json_escape(e.cat, &s);
    s += "\",\"ph\":\"X\",\"pid\":0,\"tid\":" + std::to_string(e.tid) +
         ",\"ts\":" + std::to_string(e.ts_ns / 1000.0) +
         ",\"dur\":" + std::to_string(e.dur_ns / 1000.0) + "}";
  }
  s += "]";
  int64_t need = static_cast<int64_t>(s.size());
  if (out && cap > 0) memcpy(out, s.data(), std::min<int64_t>(need, cap));
  return need;
}
