// Smoke test of the port's host runtime (host_rt.cc), built against the
// library itself so that a symbol hidden by -fvisibility=hidden fails to
// link here, and run under the sanitizers by the tests
// (tests/test_torch_runtime_native.py). Exercises, concurrently where it
// matters:
//   * arena: multithreaded alloc/free with coalescing, stats invariants
//   * pt_stack: parallel batch stacking against a serial copy
//   * tracer: concurrent record + export
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* pt_arena_create(uint64_t chunk_size);
void pt_arena_destroy(void* a);
void* pt_arena_alloc(void* a, uint64_t n);
void pt_arena_free(void* a, void* p);
void pt_arena_stats(void* a, uint64_t out[4]);
void pt_stack(void* dst, void* const* srcs, int64_t n,
              uint64_t bytes_per_sample, int nthreads);
void pt_trace_start();
void pt_trace_stop();
void pt_trace_record(const char* name, const char* cat, int64_t ts_ns,
                     int64_t dur_ns, int64_t tid);
int64_t pt_trace_count();
int64_t pt_trace_export(char* out, int64_t cap);
}

static void test_arena() {
  void* a = pt_arena_create(1 << 20);
  const int kThreads = 4, kIters = 2000;
  std::vector<std::thread> ts;
  for (int t = 0; t < kThreads; ++t) {
    ts.emplace_back([a, t] {
      std::vector<void*> live;
      for (int i = 0; i < kIters; ++i) {
        size_t n = 64 + ((t * 1315423911u + i * 2654435761u) % 4096);
        void* p = pt_arena_alloc(a, n);
        assert(p);
        memset(p, t, n);  // ASAN: must be writable, non-overlapping
        live.push_back(p);
        if (live.size() > 32) {
          pt_arena_free(a, live.front());
          live.erase(live.begin());
        }
      }
      for (void* p : live) pt_arena_free(a, p);
    });
  }
  for (auto& th : ts) th.join();
  uint64_t st[4];  // {allocated, reserved, peak, alloc_count}
  pt_arena_stats(a, st);
  assert(st[0] == 0 && "all blocks freed => allocated == 0");
  assert(st[3] == (uint64_t)kThreads * kIters);
  pt_arena_destroy(a);
  printf("arena ok\n");
}

static void test_stack() {
  const int64_t n = 64;
  const uint64_t bytes = 64 * 1024;  // > 1MB total => parallel path
  std::vector<std::vector<char>> samples(n, std::vector<char>(bytes));
  std::vector<void*> srcs(n);
  for (int64_t i = 0; i < n; ++i) {
    memset(samples[i].data(), static_cast<int>(i), bytes);
    srcs[i] = samples[i].data();
  }
  std::vector<char> dst(n * bytes), ref(n * bytes);
  for (int64_t i = 0; i < n; ++i)
    memcpy(ref.data() + i * bytes, srcs[i], bytes);
  pt_stack(dst.data(), srcs.data(), n, bytes, 4);
  assert(memcmp(dst.data(), ref.data(), dst.size()) == 0);
  printf("stack ok\n");
}

static void test_tracer() {
  pt_trace_start();
  std::vector<std::thread> ts;
  for (int t = 0; t < 4; ++t) {
    ts.emplace_back([t] {
      for (int i = 0; i < 500; ++i)
        pt_trace_record("ev", "cat", 1000 + i, 10, t);
    });
  }
  for (auto& th : ts) th.join();
  assert(pt_trace_count() == 2000);
  std::string out(1 << 20, '\0');
  int64_t len = pt_trace_export(out.data(), (int64_t)out.size());
  assert(len > 0);
  pt_trace_stop();
  printf("tracer ok\n");
}

int main() {
  test_arena();
  test_stack();
  test_tracer();
  printf("RT_TEST PASS\n");
  return 0;
}
