// mpc_ros_tpu_torch native runtime: transport shim, rate executor, CSV
// logger, path fit. The same source as the JAX package's native runtime.
//
// Replaces the runtime pieces the reference delegated to ROS:
//  * Topic slots  — the pub/sub boundary (reference: TCPROS topics). The
//    reference's feedback_vel subscriber writes a shared Twist from the
//    spinner thread while the control loop reads it with NO synchronization
//    (mpc_ros's src/mpc_planner_ros.cpp:122-124,177-179 —
//    SURVEY.md §5.2). Here: a seqlock per topic slot gives wait-free,
//    tear-free reads of fixed-size payloads.
//  * Rate executor — move_base drives the planner at controller_frequency
//    with no overrun detection (the 0.5 s solver cap exceeds the 0.05/0.1 s
//    period, SURVEY.md §6). Here: absolute-deadline clock_nanosleep pacing
//    with cycle/overrun/jitter accounting.
//  * CSV logger  — buffered tracking-log appender in the reference's
//    assets/*.csv schema, off the Python hot path.
//
// Built as a plain shared library with a C ABI; consumed via ctypes from
// runtime.py.

#include <atomic>
#include <cerrno>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <cmath>
#include <vector>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <new>

extern "C" {

// ---------------------------------------------------------------- topics --

// Seqlock-protected latest-value slot for POD payloads (<= capacity bytes).
// The payload is stored as relaxed-atomic 64-bit words (not a plain buffer):
// a classic memcpy seqlock reads data racing with the writer, which the C++
// memory model calls UB and ThreadSanitizer rightly flags even though the
// s1==s2 check discards torn values. Relaxed word copies keep the wait-free
// property, are a single MOV each on x86/ARM, and make the structure
// formally race-free — verified under -fsanitize=thread in tests.
struct TopicSlot {
  std::atomic<uint64_t> seq;       // even = stable, odd = write in progress
  uint32_t capacity;               // payload capacity in bytes
  uint32_t n_words;                // payload storage in 64-bit words
  std::atomic<uint32_t> size;      // bytes of last publish
  std::atomic<uint64_t> publish_count;
  std::atomic<uint64_t> data[];    // payload words (flexible tail)
};

TopicSlot* topic_create(uint32_t capacity) {
  const uint32_t n_words = (capacity + 7) / 8;
  void* mem = ::operator new(sizeof(TopicSlot) + n_words * 8, std::nothrow);
  if (!mem) return nullptr;
  auto* t = new (mem) TopicSlot();
  t->seq.store(0, std::memory_order_relaxed);
  t->capacity = capacity;
  t->n_words = n_words;
  t->size.store(0, std::memory_order_relaxed);
  t->publish_count.store(0, std::memory_order_relaxed);
  for (uint32_t i = 0; i < n_words; ++i)
    t->data[i].store(0, std::memory_order_relaxed);
  return t;
}

void topic_destroy(TopicSlot* t) {
  if (t) {
    t->~TopicSlot();
    ::operator delete(t);
  }
}

// Single-writer publish: bump to odd, word-copy, bump to even.
int topic_publish(TopicSlot* t, const void* payload, uint32_t size) {
  if (!t || size > t->capacity) return -1;
  uint64_t s = t->seq.load(std::memory_order_relaxed);
  t->seq.store(s + 1, std::memory_order_release);
  std::atomic_thread_fence(std::memory_order_release);
  const uint32_t full = size / 8;
  uint64_t w;
  for (uint32_t i = 0; i < full; ++i) {
    std::memcpy(&w, static_cast<const unsigned char*>(payload) + i * 8, 8);
    t->data[i].store(w, std::memory_order_relaxed);
  }
  if (size % 8) {
    w = 0;
    std::memcpy(&w, static_cast<const unsigned char*>(payload) + full * 8,
                size % 8);
    t->data[full].store(w, std::memory_order_relaxed);
  }
  t->size.store(size, std::memory_order_relaxed);
  t->publish_count.fetch_add(1, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_release);
  t->seq.store(s + 2, std::memory_order_release);
  return 0;
}

// Wait-free read of the latest value; retries while a write is in flight.
// Returns payload size, 0 if nothing published yet, -1 on error.
int topic_read(TopicSlot* t, void* out, uint32_t out_capacity) {
  if (!t) return -1;
  for (;;) {
    uint64_t s1 = t->seq.load(std::memory_order_acquire);
    if (s1 & 1) continue;  // write in progress
    if (s1 == 0) return 0;
    uint32_t size = t->size.load(std::memory_order_relaxed);
    if (size > out_capacity) return -1;
    std::atomic_thread_fence(std::memory_order_acquire);
    const uint32_t full = size / 8;
    uint64_t w;
    for (uint32_t i = 0; i < full; ++i) {
      w = t->data[i].load(std::memory_order_relaxed);
      std::memcpy(static_cast<unsigned char*>(out) + i * 8, &w, 8);
    }
    if (size % 8) {
      w = t->data[full].load(std::memory_order_relaxed);
      std::memcpy(static_cast<unsigned char*>(out) + full * 8, &w, size % 8);
    }
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s2 = t->seq.load(std::memory_order_acquire);
    if (s1 == s2) return (int)size;
  }
}

uint64_t topic_publish_count(TopicSlot* t) {
  return t ? t->publish_count.load(std::memory_order_relaxed) : 0;
}

// ---------------------------------------------------- cross-process topics
// The same seqlock TopicSlot placed in a POSIX shared-memory object: a real
// PROCESS boundary for the planner node (the reference exchanged
// feedback_vel/cmd_vel across processes over TCPROS pub/sub; here the
// robot-side process and the planner process share wait-free latest-value
// slots with zero serialization beyond the payload word copy). The struct
// is stored by value in the mapping; std::atomic<uint64_t> is
// address-free/lock-free on x86-64 and aarch64, so the seqlock protocol is
// valid across address spaces. `capacity` doubles as the readiness flag:
// the creator publishes it LAST with release ordering, attachers spin on
// it with acquire.

TopicSlot* topic_shm_create(const char* name, uint32_t capacity) {
  const uint32_t n_words = (capacity + 7) / 8;
  const size_t bytes = sizeof(TopicSlot) + n_words * 8;
  int fd = shm_open(name, O_CREAT | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)bytes) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* t = new (mem) TopicSlot();
  t->seq.store(0, std::memory_order_relaxed);
  t->n_words = n_words;
  t->size.store(0, std::memory_order_relaxed);
  t->publish_count.store(0, std::memory_order_relaxed);
  for (uint32_t i = 0; i < n_words; ++i)
    t->data[i].store(0, std::memory_order_relaxed);
  __atomic_store_n(&t->capacity, capacity, __ATOMIC_RELEASE);
  return t;
}

TopicSlot* topic_shm_attach(const char* name, int timeout_ms) {
  int fd = -1;
  for (int i = 0; i <= timeout_ms; ++i) {
    fd = shm_open(name, O_RDWR, 0600);
    if (fd >= 0) break;
    usleep(1000);
  }
  if (fd < 0) return nullptr;
  struct stat st {};
  bool sized = false;
  for (int i = 0; i <= timeout_ms; ++i) {
    if (fstat(fd, &st) == 0 && st.st_size >= (off_t)sizeof(TopicSlot)) {
      sized = true;
      break;
    }
    usleep(1000);
  }
  if (!sized) {
    close(fd);
    return nullptr;
  }
  void* mem =
      mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED,
           fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* t = reinterpret_cast<TopicSlot*>(mem);
  for (int i = 0; i <= timeout_ms; ++i) {
    if (__atomic_load_n(&t->capacity, __ATOMIC_ACQUIRE) != 0) return t;
    usleep(1000);
  }
  munmap(mem, (size_t)st.st_size);
  return nullptr;
}

void topic_shm_close(TopicSlot* t) {
  if (t) munmap(t, sizeof(TopicSlot) + (size_t)t->n_words * 8);
}

int topic_shm_unlink(const char* name) { return shm_unlink(name); }

// ------------------------------------------------------------- rate loop --

struct RateLoop {
  int64_t period_ns;
  struct timespec next;
  uint64_t cycles;
  uint64_t overruns;
  int64_t worst_late_ns;
  int64_t total_late_ns;
  int started;
};

static inline int64_t ts_diff_ns(const timespec& a, const timespec& b) {
  return (int64_t)(a.tv_sec - b.tv_sec) * 1000000000LL +
         (a.tv_nsec - b.tv_nsec);
}

static inline void ts_add_ns(timespec* t, int64_t ns) {
  t->tv_sec += ns / 1000000000LL;
  t->tv_nsec += ns % 1000000000LL;
  if (t->tv_nsec >= 1000000000L) {
    t->tv_sec += 1;
    t->tv_nsec -= 1000000000L;
  }
}

RateLoop* rate_create(int64_t period_ns) {
  auto* r = new (std::nothrow) RateLoop();
  if (!r) return nullptr;
  r->period_ns = period_ns;
  r->cycles = 0;
  r->overruns = 0;
  r->worst_late_ns = 0;
  r->total_late_ns = 0;
  // first deadline: one period from creation (loop-entry anchor)
  clock_gettime(CLOCK_MONOTONIC, &r->next);
  ts_add_ns(&r->next, period_ns);
  r->started = 1;
  return r;
}

void rate_destroy(RateLoop* r) { delete r; }

// Sleep until the current cycle's absolute deadline. Returns the cycle's
// lateness in ns (>0 = the work overran its deadline; no sleep happens and
// the schedule re-anchors at `now` rather than bursting).
int64_t rate_sleep(RateLoop* r) {
  if (!r) return 0;
  struct timespec now;
  clock_gettime(CLOCK_MONOTONIC, &now);
  int64_t late = ts_diff_ns(now, r->next);
  if (late > 0) {
    r->overruns++;
    if (late > r->worst_late_ns) r->worst_late_ns = late;
    r->total_late_ns += late;
    r->next = now;  // re-anchor
  } else {
    // EINTR wakes the sleep early (SIGPROF/SIGCHLD/...); TIMER_ABSTIME
    // makes the retry exact — without it the cycle releases pre-deadline
    while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &r->next,
                           nullptr) == EINTR) {
    }
  }
  ts_add_ns(&r->next, r->period_ns);
  r->cycles++;
  return late > 0 ? late : 0;
}

uint64_t rate_cycles(RateLoop* r) { return r ? r->cycles : 0; }
uint64_t rate_overruns(RateLoop* r) { return r ? r->overruns : 0; }
int64_t rate_worst_late_ns(RateLoop* r) { return r ? r->worst_late_ns : 0; }

// ------------------------------------------------------------ CSV logger --

struct CsvLogger {
  FILE* f;
  uint64_t rows;
};

CsvLogger* csv_open(const char* path) {
  FILE* f = std::fopen(path, "w");
  if (!f) return nullptr;
  std::setvbuf(f, nullptr, _IOFBF, 1 << 16);
  std::fputs("idx,cte,etheta,cmd_vel.linear.x,cmd_vel.angular.z\n", f);
  auto* l = new (std::nothrow) CsvLogger();
  if (!l) {
    std::fclose(f);
    return nullptr;
  }
  l->f = f;
  l->rows = 0;
  return l;
}

int csv_row(CsvLogger* l, int64_t idx, double cte, double etheta, double v,
            double w) {
  if (!l || !l->f) return -1;
  std::fprintf(l->f, "%lld,%.6g,%.6g,%.6g,%.6g\n", (long long)idx, cte,
               etheta, v, w);
  l->rows++;
  return 0;
}

// Footer format: "tracking time,<sec>,<nsec>" (reference assets/mpc.csv).
int csv_close(CsvLogger* l, int64_t sec, int64_t nsec) {
  if (!l) return -1;
  if (l->f) {
    std::fprintf(l->f, "tracking time,%lld,%lld\n", (long long)sec,
                 (long long)nsec);
    std::fclose(l->f);
  }
  uint64_t rows = l->rows;
  delete l;
  return (int)rows;
}

}  // extern "C"

// ---------------------------------------------------------------- plan fit
// Native per-cycle path-fit core — the numeric hot path of the reference's
// Tracking::findBestPath (mpc_ros's src/driving_state.cpp:
// 196-235) and its Eigen-QR polyfit (:273-300): world->robot transform,
// Householder-QR polynomial fit, cte at x=0, and the 30%-lookahead path
// direction. The branchy plan pruning stays in Python (planner/plan_utils);
// this replaces the numpy lstsq in the real-time single-robot loop.

extern "C" int plan_fit(const double* xs, const double* ys, int n,
                        double px, double py, double theta, int order,
                        double lookahead_frac,
                        double* coeffs_out /* order+1 */,
                        double* cte_out, double* heading_out,
                        int* heading_valid) {
  if (n < 2 || order < 1 || order > 8 || order > n - 1) return -1;
  const int m = order + 1;
  const double ct = std::cos(theta), st = std::sin(theta);

  // Vandermonde in robot frame: A[i][j] = xv_i^j, b[i] = yv_i
  std::vector<double> A(static_cast<size_t>(n) * m), b(n);
  for (int i = 0; i < n; ++i) {
    const double dx = xs[i] - px, dy = ys[i] - py;
    const double xv = dx * ct + dy * st;
    const double yv = dy * ct - dx * st;
    double p = 1.0;
    for (int j = 0; j < m; ++j) {
      A[static_cast<size_t>(i) * m + j] = p;
      p *= xv;
    }
    b[i] = yv;
  }

  // Householder QR: reduce A in place, apply reflectors to b.
  for (int k = 0; k < m; ++k) {
    double norm = 0.0;
    for (int i = k; i < n; ++i) {
      const double v = A[static_cast<size_t>(i) * m + k];
      norm += v * v;
    }
    norm = std::sqrt(norm);
    if (norm == 0.0) return -2;  // rank deficient
    double akk = A[static_cast<size_t>(k) * m + k];
    const double alpha = (akk > 0.0) ? -norm : norm;
    // v = a_k - alpha e_k (stored in column k below the diagonal + vk)
    std::vector<double> v(n - k);
    v[0] = akk - alpha;
    for (int i = k + 1; i < n; ++i)
      v[i - k] = A[static_cast<size_t>(i) * m + k];
    double vtv = 0.0;
    for (double q : v) vtv += q * q;
    if (vtv == 0.0) return -2;
    A[static_cast<size_t>(k) * m + k] = alpha;
    for (int i = k + 1; i < n; ++i) A[static_cast<size_t>(i) * m + k] = 0.0;
    for (int j = k + 1; j < m; ++j) {
      double dot = 0.0;
      for (int i = k; i < n; ++i)
        dot += v[i - k] * A[static_cast<size_t>(i) * m + j];
      const double s = 2.0 * dot / vtv;
      for (int i = k; i < n; ++i)
        A[static_cast<size_t>(i) * m + j] -= s * v[i - k];
    }
    double dotb = 0.0;
    for (int i = k; i < n; ++i) dotb += v[i - k] * b[i];
    const double sb = 2.0 * dotb / vtv;
    for (int i = k; i < n; ++i) b[i] -= sb * v[i - k];
  }
  // back-substitute R x = b[0..m)
  for (int j = m - 1; j >= 0; --j) {
    double acc = b[j];
    for (int k2 = j + 1; k2 < m; ++k2)
      acc -= A[static_cast<size_t>(j) * m + k2] * coeffs_out[k2];
    coeffs_out[j] = acc / A[static_cast<size_t>(j) * m + j];
  }
  *cte_out = coeffs_out[0];

  // 30%-lookahead world-frame path direction (driving_state.cpp:215-221)
  const int n_sample = static_cast<int>(n * lookahead_frac);
  double gx = 0.0, gy = 0.0;
  for (int i = 1; i < n_sample; ++i) {
    gx += xs[i] - xs[i - 1];
    gy += ys[i] - ys[i - 1];
  }
  *heading_valid = (gx != 0.0 && gy != 0.0) ? 1 : 0;
  *heading_out = std::atan2(gy, gx);
  return 0;
}
