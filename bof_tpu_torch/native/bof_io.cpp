// bof_io — native asynchronous strided-I/O engine for bof_tpu.
//
// TPU-native re-design of the reference's I/O plane (reference:
// src/file_handles/flash_file_handle.cpp + src/scheduler/io_executor.cpp):
// a pool of I/O worker threads services strided read/write requests against
// O_DIRECT (or buffered) files.  Per the reference's decomposition, one
// strided request becomes one sub-op per stride run (flash_file_handle.cpp
// :429-506 issues one iocb per stride), runs larger than a chunk limit are
// split (MAX_CHUNK_SIZE, :25), unaligned O_DIRECT reads bounce through an
// aligned buffer (:247-312), and unaligned O_DIRECT writes do locked
// read-modify-write of the boundary sectors (:314-407).  Where the
// reference *detects* write-write sector overlap pairwise and defers
// conflicting writes (io_executor.cpp:249-361), we *exclude* it by
// construction: a per-file sector-interval lock serializes RMW writes whose
// sector extents intersect.  Completion callbacks are replaced by ticket
// futures polled/awaited from Python (ctypes releases the GIL in bof_wait).
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread bof_io.cpp -o libbof_io.so
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

#include <errno.h>
#include <fcntl.h>
#include <linux/aio_abi.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

// Raw kernel-AIO syscalls (the reference links libaio for the same three
// calls, flash_file_handle.cpp:28-76; no libaio headers in this image).
static int sys_io_setup(unsigned nr, aio_context_t* ctx) {
  return syscall(SYS_io_setup, nr, ctx);
}
static int sys_io_destroy(aio_context_t ctx) {
  return syscall(SYS_io_destroy, ctx);
}
static int sys_io_submit(aio_context_t ctx, long n, struct iocb** iocbs) {
  return syscall(SYS_io_submit, ctx, n, iocbs);
}
static int sys_io_getevents(aio_context_t ctx, long min_nr, long nr,
                            struct io_event* events) {
  return syscall(SYS_io_getevents, ctx, min_nr, nr, events, nullptr);
}

constexpr int64_t kSector = 512;

static int64_t round_down(int64_t x, int64_t m) { return (x / m) * m; }
static int64_t round_up(int64_t x, int64_t m) { return ((x + m - 1) / m) * m; }
static bool ptr_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % kSector) == 0;
}

// ---------------------------------------------------------------- tickets
struct TicketSlot {
  std::atomic<int64_t> remaining{0};
  std::atomic<int> err{0};
  bool in_use = false;
  int64_t id = -1;
};

struct TicketTable {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<TicketSlot*> free_slots;
  std::vector<TicketSlot*> slots;  // index = ticket id

  int64_t acquire(int64_t n_ops) {
    std::lock_guard<std::mutex> g(mu);
    TicketSlot* s;
    int64_t id;
    if (!free_slots.empty()) {
      s = free_slots.front();
      free_slots.pop_front();
      id = s->id;
    } else {
      s = new TicketSlot();
      slots.push_back(s);
      id = (int64_t)slots.size() - 1;
      s->id = id;
    }
    s->remaining.store(n_ops, std::memory_order_relaxed);
    s->err.store(0, std::memory_order_relaxed);
    s->in_use = true;
    return id;
  }

  TicketSlot* get(int64_t id) {
    std::lock_guard<std::mutex> g(mu);
    if (id < 0 || id >= (int64_t)slots.size() || !slots[id]->in_use)
      return nullptr;
    return slots[id];
  }

  void op_done(TicketSlot* s, int err) {
    if (err) s->err.store(err, std::memory_order_relaxed);
    if (s->remaining.fetch_sub(1, std::memory_order_acq_rel) == 1) {
      std::lock_guard<std::mutex> g(mu);
      cv.notify_all();
    }
  }

  // Returns 0 ok / -errno; frees the slot.
  int wait_free(int64_t id) {
    TicketSlot* s = get(id);
    if (!s) return -EINVAL;
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [&] { return s->remaining.load(std::memory_order_acquire) == 0; });
    int e = s->err.load(std::memory_order_relaxed);
    s->in_use = false;
    free_slots.push_back(s);
    return e ? -e : 0;
  }

  int poll(int64_t id) {  // 1 done-ok, 0 pending, -errno done-error
    TicketSlot* s = get(id);
    if (!s) return -EINVAL;
    if (s->remaining.load(std::memory_order_acquire) != 0) return 0;
    int e = s->err.load(std::memory_order_relaxed);
    return e ? -e : 1;
  }
};

// ------------------------------------------- sector-interval write locks
// Serializes O_DIRECT RMW writes whose sector extents intersect — the
// race the reference detects at io_executor.cpp:10-156 is prevented here.
struct IntervalLocks {
  std::mutex mu;
  std::condition_variable cv;
  std::unordered_map<int, std::vector<std::pair<int64_t, int64_t>>> held;

  void lock(int fd, int64_t lo, int64_t hi) {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      auto& v = held[fd];
      bool clash = false;
      for (auto& p : v)
        if (lo < p.second && p.first < hi) { clash = true; break; }
      if (!clash) { v.emplace_back(lo, hi); return; }
      cv.wait(lk);
    }
  }

  void unlock(int fd, int64_t lo, int64_t hi) {
    std::lock_guard<std::mutex> g(mu);
    auto& v = held[fd];
    for (size_t i = 0; i < v.size(); ++i)
      if (v[i].first == lo && v[i].second == hi) {
        v[i] = v.back();
        v.pop_back();
        break;
      }
    cv.notify_all();
  }
};

// ----------------------------------------------------------------- engine
struct Op {
  int fd;
  int64_t off;       // file offset of the first run
  int64_t len;       // bytes per run
  char* buf;         // contiguous buffer side
  bool is_write;
  bool o_direct;
  TicketSlot* slot;
  // strided batching: n_runs runs of `len` bytes, `stride` apart in the
  // file, contiguous in buf.  n_runs==1 == plain contiguous op.
  int64_t stride = 0;
  int64_t n_runs = 1;
};

struct Engine {
  std::mutex qmu;
  std::condition_variable qcv;
  std::deque<Op> q;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  TicketTable tickets;
  IntervalLocks wlocks;
  std::mutex fdmu;
  std::unordered_map<int, bool> fd_direct;  // fd -> opened O_DIRECT

  void push(Op op) {
    {
      std::lock_guard<std::mutex> g(qmu);
      q.push_back(op);
    }
    qcv.notify_one();
  }

  void worker();
};

static Engine* g_engine = nullptr;
static std::atomic<long long> g_aio_ops{0};
// Runtime AIO depth knobs (reference exposes MAX_SIMUL_REQS / MAX_EVENTS as
// compile-time -D flags, CMakeLists.txt:38-91, used flash_file_handle.cpp
// :78-102); set via bof_set_aio_depth from FlashConfig.max_simul_reqs.
static std::atomic<int> g_max_simul{128};
static std::atomic<unsigned> g_max_events{256};

static bool aio_eligible(const Op& op) {
  return op.o_direct && (op.off % kSector) == 0 && (op.len % kSector) == 0
         && (op.n_runs == 1 || (op.stride % kSector) == 0)
         && ptr_aligned(op.buf);
}

// aio_execute returning this sentinel means iocbs may still be in flight
// in the context (io_getevents failed hard): the caller MUST io_destroy
// the context and set up a fresh one — the thread_local context outlives
// this call, and stale events would corrupt the next op's slot accounting
// (and the kernel could still DMA into a buffer reported complete).
static constexpr int kCtxPoisoned = -1;

static int aio_execute(aio_context_t ctx, const Op& op, int max_slots) {
  constexpr int kSlots = 128;  // compile-time ceiling on in-flight iocbs
  if (max_slots < 1) max_slots = 1;
  if (max_slots > kSlots) max_slots = kSlots;
  struct RunSlot {
    char* buf;
    int64_t len;
  };
  iocb cbs[kSlots];
  RunSlot slots[kSlots];
  int free_idx[kSlots];
  int n_free = max_slots;
  for (int i = 0; i < max_slots; ++i) free_idx[i] = i;
  io_event ev[kSlots];
  iocb* subs[kSlots];
  int64_t next = 0;
  int inflight = 0;
  int err = 0;
  while ((next < op.n_runs && !err) || inflight) {
    int n_sub = 0;
    while (!err && next < op.n_runs && n_free) {
      int s = free_idx[--n_free];
      iocb& cb = cbs[s];
      memset(&cb, 0, sizeof cb);
      cb.aio_lio_opcode = op.is_write ? IOCB_CMD_PWRITE : IOCB_CMD_PREAD;
      cb.aio_fildes = op.fd;
      cb.aio_buf = (uint64_t)(uintptr_t)(op.buf + next * op.len);
      cb.aio_nbytes = (uint64_t)op.len;
      cb.aio_offset = op.off + next * op.stride;
      cb.aio_data = (uint64_t)s;
      slots[s] = {op.buf + next * op.len, op.len};
      subs[n_sub++] = &cb;
      ++next;
    }
    int done = 0;
    while (done < n_sub) {
      int r = sys_io_submit(ctx, n_sub - done, subs + done);
      if (r < 0) {
        if (errno == EINTR) continue;
        err = errno;
        for (int i = done; i < n_sub; ++i)
          free_idx[n_free++] = (int)subs[i]->aio_data;
        break;
      }
      done += r;
      inflight += r;
    }
    if (inflight) {
      int got = sys_io_getevents(ctx, 1, kSlots, ev);
      if (got < 0) {
        if (errno == EINTR) continue;
        err = errno;
        break;  // drained (or poisoned) below — context is reused
      }
      int n_retry = 0;
      iocb* retry[kSlots];
      for (int i = 0; i < got; ++i) {
        int s = (int)ev[i].data;
        long res = (long)ev[i].res;
        if (res < 0) {
          err = (int)-res;
        } else if (res < (long)slots[s].len) {
          if (op.is_write) {
            err = EIO;  // short aligned O_DIRECT write
          } else if (res == 0) {
            // true EOF: zero-fill like the sync path (full_pread)
            memset(slots[s].buf, 0, (size_t)slots[s].len);
          } else if ((res % kSector) == 0) {
            // partial completion mid-file: re-issue the remainder — only
            // res==0 means EOF (full_pread retries exactly the same way;
            // blindly zero-filling here replaced valid file bytes)
            slots[s].buf += res;
            slots[s].len -= res;
            iocb& cb = cbs[s];
            cb.aio_buf += (uint64_t)res;
            cb.aio_nbytes -= (uint64_t)res;
            cb.aio_offset += res;
            retry[n_retry++] = &cb;
            continue;  // slot stays in flight
          } else {
            // unaligned partial on O_DIRECT: cannot resubmit (alignment);
            // treat the tail as EOF-zero only if nothing remains on disk
            memset(slots[s].buf + res, 0, (size_t)(slots[s].len - res));
          }
        }
        free_idx[n_free++] = s;
        --inflight;
      }
      int done_r = 0;
      while (done_r < n_retry && !err) {
        int r = sys_io_submit(ctx, n_retry - done_r, retry + done_r);
        if (r < 0) {
          if (errno == EINTR) continue;
          err = errno;
          break;
        }
        done_r += r;
      }
      // anything not (re)submitted is not in the kernel: release its slot
      // or the drain loop below would wait for events that never come
      for (int i = done_r; i < n_retry; ++i) {
        free_idx[n_free++] = (int)retry[i]->aio_data;
        --inflight;
      }
    }
  }
  // The thread_local context outlives this call (worker threads live until
  // engine stop), so iocbs must never be left in flight: a later op on this
  // thread would reap the stale events — whose ev.data indexes *its*
  // slots/free_idx arrays — and the kernel could still DMA into a buffer
  // whose ticket was already reported complete.  Drain everything.
  while (inflight > 0) {
    int got = sys_io_getevents(ctx, inflight, kSlots, ev);
    if (got < 0) {
      if (errno == EINTR) continue;
      return kCtxPoisoned;  // cannot drain: caller must io_destroy + reset
    }
    inflight -= got;
  }
  return err;
}

// Thread-local aligned bounce buffer for O_DIRECT unaligned paths.
struct Bounce {
  char* p = nullptr;
  size_t cap = 0;
  ~Bounce() { free(p); }
  char* ensure(size_t n) {
    if (cap < n) {
      free(p);
      if (posix_memalign((void**)&p, 4096, n) != 0) { p = nullptr; cap = 0; }
      else cap = n;
    }
    return p;
  }
};
thread_local Bounce tl_bounce;

static int full_pread(int fd, char* buf, int64_t len, int64_t off) {
  int64_t pos = 0;
  while (pos < len) {
    ssize_t n = pread(fd, buf + pos, (size_t)(len - pos), off + pos);
    if (n < 0) {
      if (errno == EINTR) continue;
      return errno;
    }
    if (n == 0) {  // read past EOF: zero-fill (sparse/short file)
      memset(buf + pos, 0, (size_t)(len - pos));
      return 0;
    }
    pos += n;
  }
  return 0;
}

static int full_pwrite(int fd, const char* buf, int64_t len, int64_t off) {
  int64_t pos = 0;
  while (pos < len) {
    ssize_t n = pwrite(fd, buf + pos, (size_t)(len - pos), off + pos);
    if (n < 0) {
      if (errno == EINTR) continue;
      return errno;
    }
    pos += n;
  }
  return 0;
}


// ------------------------------------------------------------ kernel AIO
// Fully-aligned O_DIRECT strided ops go through io_submit batches — the
// reference's exact mechanism (one iocb per stride, submit+reap loop,
// flash_file_handle.cpp:28-102) — giving per-thread queue depth beyond
// one synchronous request.  Everything else (unaligned, buffered, RMW)
// keeps the synchronous worker path.
struct TlAio {
  aio_context_t ctx = 0;
  bool tried = false;
  ~TlAio() {
    if (ctx) sys_io_destroy(ctx);
  }
  bool ready() {
    if (!tried) {
      tried = true;
      if (getenv("BOF_NO_KERNEL_AIO")
          || sys_io_setup(g_max_events.load(std::memory_order_relaxed),
                          &ctx) != 0)
        ctx = 0;
    }
    return ctx != 0;
  }
  void reset() {  // poisoned context: tear down, retry fresh next op
    if (ctx) sys_io_destroy(ctx);
    ctx = 0;
    tried = false;
  }
};
thread_local TlAio tl_aio;

// ------------------------------------------------- span-coalesced reads
// Small strided runs with a dense-enough fill are served by ONE
// sequential read of the covering byte span into the bounce buffer, then
// scattered to the destination.  Small O_DIRECT IOs are IOPS-bound (a
// 16 KiB-run matrix tile read achieves ~1/10th of the device's
// sequential rate; measured on this box: 16 KiB QD1 ~0.16 GB/s vs
// >=1 MiB ~1.3 GB/s), so paying <=4x byte amplification for the
// sequential rate is a large net win.  The reference merges overlapping
// strides at WRITE time (flash_file_handle.cpp:508-716); this is the
// read-side analog for gapped strides.  Kill-switch: BOF_NO_SPAN_COALESCE
// (used by paired A/Bs).  Writes never take this path (RMW hazards stay
// with the interval-locked write machinery).
static std::atomic<long long> g_span_ops{0};
// Kill-switch state: a cached atomic, NOT a per-op getenv — workers
// calling getenv while a Python thread mutates os.environ (putenv can
// realloc environ) is a data race.  Seeded from the env at engine start;
// the Python bindings re-sync it through bof_set_span_disable whenever
// the BOF_NO_SPAN_COALESCE env value changes (io/native.py _submit).
static std::atomic<int> g_span_disable{0};
constexpr int64_t kSpanMaxRunLen = 256 << 10;  // big runs are fast already
constexpr int64_t kSpanMaxBytes = 64ll << 20;  // bounce-buffer ceiling

static bool span_eligible(const Op& op) {
  if (g_span_disable.load(std::memory_order_relaxed) || op.is_write
      || op.n_runs <= 1 || !op.o_direct)
    return false;
  if (op.stride <= 0 || op.len >= kSpanMaxRunLen) return false;
  int64_t span = (op.n_runs - 1) * op.stride + op.len;
  if (span > kSpanMaxBytes) return false;
  return op.n_runs * op.len * 4 >= span;  // fill >= 25%
}

static int span_read(const Op& op) {
  int64_t lo = round_down(op.off, kSector);
  int64_t hi =
      round_up(op.off + (op.n_runs - 1) * op.stride + op.len, kSector);
  char* bb = tl_bounce.ensure((size_t)(hi - lo));
  if (!bb) return ENOMEM;
  int e = full_pread(op.fd, bb, hi - lo, lo);  // zero-fills past EOF
  if (e) return e;
  for (int64_t r = 0; r < op.n_runs; ++r)
    memcpy(op.buf + r * op.len, bb + (op.off + r * op.stride - lo),
           (size_t)op.len);
  g_span_ops.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

// O_DIRECT read with bounce for unaligned offset/len/pointer
// (reference: flash_file_handle.cpp:247-312).
static int direct_read(int fd, char* buf, int64_t len, int64_t off) {
  if ((off % kSector) == 0 && (len % kSector) == 0 && ptr_aligned(buf))
    return full_pread(fd, buf, len, off);
  int64_t lo = round_down(off, kSector), hi = round_up(off + len, kSector);
  char* bb = tl_bounce.ensure((size_t)(hi - lo));
  if (!bb) return ENOMEM;
  int e = full_pread(fd, bb, hi - lo, lo);
  if (e) return e;
  memcpy(buf, bb + (off - lo), (size_t)len);
  return 0;
}

// O_DIRECT write; unaligned paths read-modify-write the sector extent under
// a per-file interval lock (reference: flash_file_handle.cpp:314-407 + the
// io_executor overlap machinery).
static int direct_write(Engine* eng, int fd, const char* buf, int64_t len,
                        int64_t off) {
  if ((off % kSector) == 0 && (len % kSector) == 0 && ptr_aligned(buf))
    return full_pwrite(fd, buf, len, off);
  int64_t lo = round_down(off, kSector), hi = round_up(off + len, kSector);
  eng->wlocks.lock(fd, lo, hi);
  char* bb = tl_bounce.ensure((size_t)(hi - lo));
  int e = bb ? 0 : ENOMEM;
  if (!e) {
    // Preload the extent so untouched boundary bytes are preserved; bytes
    // past EOF are zeroed.  Extents are small (tile edges), so reading the
    // whole extent instead of just boundary sectors is cheap.
    memset(bb, 0, (size_t)(hi - lo));
    int64_t fsz = lseek(fd, 0, SEEK_END);
    if (fsz > lo) {
      int64_t rd = std::min(hi, round_up(fsz, kSector)) - lo;
      e = full_pread(fd, bb, rd, lo);
    }
    if (!e) {
      memcpy(bb + (off - lo), buf, (size_t)len);
      e = full_pwrite(fd, bb, hi - lo, lo);
    }
  }
  eng->wlocks.unlock(fd, lo, hi);
  return e;
}

// DEBUG write read-back verification (reference parity: DEBUG builds
// memcmp every write, flash_file_handle.cpp:394-402, 618-627, 701-709).
// Gated by FlashConfig.debug_checks via bof_set_verify_writes.
static std::atomic<int> g_verify_writes{0};
thread_local Bounce tl_verify;

static int verify_write_op(Engine* eng, const Op& op) {
  char* vb = tl_verify.ensure((size_t)op.len);
  if (!vb) return ENOMEM;
  for (int64_t r = 0; r < op.n_runs; ++r) {
    int64_t fo = op.off + r * op.stride;
    const char* bp = op.buf + r * op.len;
    // hold the sector-extent lock so a concurrent RMW on a shared boundary
    // sector can't tear the read mid-verify
    int64_t lo = round_down(fo, kSector), hi = round_up(fo + op.len, kSector);
    eng->wlocks.lock(op.fd, lo, hi);
    int e = op.o_direct ? direct_read(op.fd, vb, op.len, fo)
                        : full_pread(op.fd, vb, op.len, fo);
    eng->wlocks.unlock(op.fd, lo, hi);
    if (e) return e;
    if (memcmp(vb, bp, (size_t)op.len) != 0) {
      fprintf(stderr,
              "bof_io: write verify FAILED fd=%d off=%lld len=%lld run=%lld\n",
              op.fd, (long long)fo, (long long)op.len, (long long)r);
      return EIO;
    }
  }
  return 0;
}

void Engine::worker() {
  for (;;) {
    Op op;
    {
      std::unique_lock<std::mutex> lk(qmu);
      qcv.wait(lk, [&] { return stop.load() || !q.empty(); });
      if (q.empty()) return;  // stop && drained
      op = q.front();
      q.pop_front();
    }
    int e = 0;
    bool handled = false;
    if (span_eligible(op)) {
      e = span_read(op);
      if (e == 0) {
        handled = true;
      } else {
        // the covering span touches gap bytes the caller never asked
        // for — a bad sector in a gap (or bounce ENOMEM) must not fail
        // a read the per-run path would satisfy; fall through
        e = 0;
      }
    }
    if (handled) {
    } else if (op.n_runs > 1 && aio_eligible(op) && tl_aio.ready()) {
      e = aio_execute(tl_aio.ctx, op,
                      g_max_simul.load(std::memory_order_relaxed));
      if (e == kCtxPoisoned) {
        tl_aio.reset();
        e = EIO;
      }
      g_aio_ops.fetch_add(op.n_runs, std::memory_order_relaxed);
    } else {
      for (int64_t r = 0; r < op.n_runs && !e; ++r) {
        int64_t fo = op.off + r * op.stride;
        char* bp = op.buf + r * op.len;
        if (op.is_write)
          e = op.o_direct ? direct_write(this, op.fd, bp, op.len, fo)
                          : full_pwrite(op.fd, bp, op.len, fo);
        else
          e = op.o_direct ? direct_read(op.fd, bp, op.len, fo)
                          : full_pread(op.fd, bp, op.len, fo);
      }
    }
    if (!e && op.is_write
        && g_verify_writes.load(std::memory_order_relaxed)) {
      // test-only fault injection: corrupt the first written byte on disk
      // so the read-back verify demonstrably catches real corruption
      const char* cor = getenv("BOF_TEST_CORRUPT_WRITES");
      if (cor && *cor == '1') {
        char fb = (char)(op.buf[0] ^ 0xFF);
        if (op.o_direct)
          direct_write(this, op.fd, &fb, 1, op.off);
        else
          full_pwrite(op.fd, &fb, 1, op.off);
      }
      e = verify_write_op(this, op);
    }
    tickets.op_done(op.slot, e);
  }
}

// ---------- host prep kernels (transfer compression) ----------
// One-off thread fan-out, NOT the I/O worker pool: prep must not queue
// behind in-flight disk ops (and vice versa).  Thread spawn (~50 us)
// is noise next to the tens-of-ms passes being split.  fn(lo, hi, tid),
// tid < 16.
template <typename Fn>
static void prep_parallel(int64_t n, Fn fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = std::min<int64_t>(hw ? hw : 4, 8);
  constexpr int64_t kMinPerThread = 1 << 20;  // elements
  nt = std::min<int64_t>(nt, (n + kMinPerThread - 1) / kMinPerThread);
  if (nt <= 1) {
    fn((int64_t)0, n, (int64_t)0);
    return;
  }
  int64_t per = (n + nt - 1) / nt;
  std::vector<std::thread> ts;
  for (int64_t t = 1; t < nt; ++t) {
    int64_t lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi, t);
  }
  fn((int64_t)0, std::min(per, n), (int64_t)0);
  for (auto& th : ts) th.join();
}

// ---------- host phase-body kernels (sort / stable merge order) ----------
// The reference's block sort is __gnu_parallel::sort and its merge bodies
// are OpenMP (reference: include/tasks/sort_task.h:8,37,
// csrcsc_task.h:101-169); these are the engine's equivalents, on the same
// one-off fan-out discipline as the prep kernels (never the I/O pool).
// BOF_HOST_THREADS overrides the thread count (tests force >1 on a 1-core
// box so the sharded merge paths stay covered; read once per call on the
// calling thread — no per-op getenv from workers).

static int64_t host_fanout_threads(int64_t n, int64_t min_per) {
  int64_t nt;
  if (const char* e = getenv("BOF_HOST_THREADS")) {
    nt = atoll(e);
    if (nt < 1) nt = 1;
    if (nt > 16) nt = 16;
  } else {
    unsigned hw = std::thread::hardware_concurrency();
    nt = std::min<int64_t>(hw ? hw : 1, 8);
  }
  return std::max<int64_t>(1, std::min(nt, (n + min_per - 1) / min_per));
}

// numpy sort order for floats: all NaNs compare equivalent and land LAST
// (plain operator< on NaN is not a strict weak ordering — UB in std::sort)
template <typename T>
struct TotalLess {
  bool operator()(T a, T b) const { return a < b; }
};
template <>
struct TotalLess<float> {
  bool operator()(float a, float b) const {
    if (b != b) return a == a;
    if (a != a) return false;
    return a < b;
  }
};
template <>
struct TotalLess<double> {
  bool operator()(double a, double b) const {
    if (b != b) return a == a;
    if (a != a) return false;
    return a < b;
  }
};

// Merge-path co-rank: how many of the first t outputs of merge(A, B)
// come from A (the classic GPU merge-path partition).  Values only — a
// value sort's equal elements are interchangeable, so any diagonal
// intersection yields a correct merge.
template <typename T>
static int64_t merge_split(const T* A, int64_t la, const T* B, int64_t lb,
                           int64_t t, TotalLess<T> less) {
  int64_t lo = std::max<int64_t>(0, t - lb);
  int64_t hi = std::min<int64_t>(t, la);
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (less(B[t - mid - 1], A[mid]))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// Merge n_runs ADJACENT pre-sorted runs in place: log2(n_runs) passes of
// pairwise merges, each pair PARTITIONED into balanced chunks by
// merge-path co-ranks so every pass keeps the whole thread team busy —
// a naive per-pair fan-out leaves the final full-array merge on one
// thread, which alone costs more than numpy's SIMD sort.  The runs are
// sorted by the CALLER: numpy's np.sort per shard (GIL released) beats
// scalar std::sort ~20x, so the fast parallel sort is numpy shards +
// this native merge, not an all-native sort.  Runs must use np.sort's
// order (floats: NaNs last), which TotalLess reproduces.
template <typename T>
static void merge_runs_impl(T* d, const int64_t* b, int64_t nr) {
  TotalLess<T> less;
  const int64_t n = b[nr];
  const int64_t nt = host_fanout_threads(n, 1 << 14);
  std::vector<T> tmp(n);
  std::vector<int64_t> cur(b, b + nr + 1);
  T* src = d;
  T* dst = tmp.data();
  while ((int64_t)cur.size() > 2) {
    const int64_t runs = (int64_t)cur.size() - 1;
    struct Chunk { const T* a; int64_t la; const T* bb; int64_t lb; T* out; };
    std::vector<Chunk> chunks;
    std::vector<int64_t> nxt{0};
    const int64_t target =
        std::max<int64_t>((n + 2 * nt - 1) / (2 * nt), 1 << 14);
    for (int64_t i = 0; i < runs; i += 2) {
      const int64_t lo = cur[i];
      const int64_t mid = cur[std::min(i + 1, runs)];
      const int64_t hi = cur[std::min(i + 2, runs)];
      nxt.push_back(hi);
      const T* A = src + lo;
      const T* B = src + mid;
      const int64_t la = mid - lo, lb = hi - mid, total = la + lb;
      if (total == 0) continue;
      const int64_t nc =
          std::max<int64_t>(1, std::min<int64_t>(
              (total + target - 1) / target, 2 * nt));
      int64_t prev_a = 0, prev_t = 0;
      for (int64_t c = 1; c <= nc; ++c) {
        const int64_t t_c = (c == nc) ? total : c * total / nc;
        const int64_t ai = (c == nc) ? la
                                     : merge_split(A, la, B, lb, t_c, less);
        chunks.push_back({A + prev_a, ai - prev_a,
                          B + (prev_t - prev_a),
                          (t_c - ai) - (prev_t - prev_a),
                          dst + lo + prev_t});
        prev_a = ai;
        prev_t = t_c;
      }
    }
    std::atomic<int64_t> next{0};
    auto work = [&] {
      for (;;) {
        const int64_t c = next.fetch_add(1, std::memory_order_relaxed);
        if (c >= (int64_t)chunks.size()) return;
        const Chunk& ck = chunks[c];
        if (ck.lb == 0)
          std::copy(ck.a, ck.a + ck.la, ck.out);
        else if (ck.la == 0)
          std::copy(ck.bb, ck.bb + ck.lb, ck.out);
        else
          std::merge(ck.a, ck.a + ck.la, ck.bb, ck.bb + ck.lb, ck.out,
                     less);
      }
    };
    {
      std::vector<std::thread> ts;
      const int64_t team = std::min<int64_t>(nt, (int64_t)chunks.size());
      for (int64_t t = 1; t < team; ++t) ts.emplace_back(work);
      work();
      for (auto& th : ts) th.join();
    }
    cur = std::move(nxt);
    std::swap(src, dst);
  }
  if (src != d) std::copy(src, src + n, d);
}

}  // namespace

extern "C" {

// Per-tile max-abs int8 quantization (transfer_dtype='int8' host prep,
// ops/gemm.py): dst[i] = rint(src[i]/scale) clamped to [-127,127] with
// scale = maxabs/127 (maxabs 0 -> 1, matching the python fallback).
// Two parallel passes; lrintf under the default FE_TONEAREST mode is
// round-half-even like np.rint.  Returns scale.
double bof_quantize_i8(const float* src, signed char* dst, long long n) {
  float part[16] = {0};
  prep_parallel(n, [&](int64_t lo, int64_t hi, int64_t tid) {
    float m = 0.0f;
    for (int64_t i = lo; i < hi; ++i) {
      float a = std::fabs(src[i]);
      if (a > m) m = a;
    }
    part[tid] = m;
  });
  float amax = 0.0f;
  for (float p : part) amax = std::max(amax, p);
  if (amax == 0.0f) amax = 1.0f;
  const float scale = amax / 127.0f;
  const float inv = 1.0f / scale;
  prep_parallel(n, [&](int64_t lo, int64_t hi, int64_t) {
    for (int64_t i = lo; i < hi; ++i) {
      long v = lrintf(src[i] * inv);
      if (v > 127) v = 127;
      if (v < -127) v = -127;
      dst[i] = (signed char)v;
    }
  });
  return (double)scale;
}

// float32 -> bfloat16 (round-to-nearest-even, NaN kept quiet): the
// native twin of ml_dtypes' astype for transfer_dtype='bfloat16' prep.
void bof_cast_bf16(const float* src, unsigned short* dst, long long n) {
  prep_parallel(n, [&](int64_t lo, int64_t hi, int64_t) {
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t u;
      std::memcpy(&u, &src[i], 4);
      if ((u & 0x7fffffffu) > 0x7f800000u) {  // NaN: force the quiet bit
        dst[i] = (unsigned short)((u >> 16) | 0x0040u);
      } else {
        uint32_t r = u + 0x7fffu + ((u >> 16) & 1u);
        dst[i] = (unsigned short)(r >> 16);
      }
    }
  });
}

// fp64 -> s int8 mantissa slices (ops/gemm64.py host prep): one fused
// parallel pass replacing the numpy round-and-subtract chain (s passes
// with full-size temporaries).  r = ldexp(x, -exp) is the EXACT division
// by the per-row/column power-of-two scale (exps = frexp exponents of the
// amax vector, per line when per_line else per column of the row-major
// (n_lines, width) tile); then s error-free extract steps
// (q = nearbyint(r*mult), r = r*mult - q; mult 64 then 128), nearbyint
// under the default FE_TONEAREST mode matching np.rint.  dst holds s
// contiguous planes of n_lines*width int8.
void bof_split_f64_i8(const double* src, long long n_lines, long long width,
                      const int* exps, int per_line, int s,
                      signed char* dst) {
  const int64_t n = (int64_t)n_lines * width;
  prep_parallel(n, [&](int64_t lo, int64_t hi, int64_t) {
    for (int64_t i = lo; i < hi; ++i) {
      const int e = per_line ? exps[i / width] : exps[i % width];
      double r = std::ldexp(src[i], -e);
      double mult = 64.0;
      for (int p = 0; p < s; ++p) {
        const double t = r * mult;
        const double q = nearbyint(t);
        dst[(int64_t)p * n + i] = (signed char)q;
        r = t - q;
        mult = 128.0;
      }
    }
  });
}

// Padded-ELL row gather (the sparse planners' host prep,
// sparse/spmm_device.py _ell_fill): for each selected row, copy
// counts[r] column indices (int64 -> int32|uint16) and values
// (f32 copy | f32 -> bf16 round-to-nearest-even | f64 copy) from the CSR
// block into an (rows_pad, rmax) ELL pair and zero the padding.  One
// sequential pass per output element, replacing the numpy formulation's
// ~6 full-size temporaries (int64 idx matrix + mask + two fancy gathers
// + astype), which the csrgemv/csrmm stage partitions exposed as the
// dominant 'N'-path prep term; parallel over rows on multi-core hosts.
// ja_kind: 0 int32, 1 uint16.  va_kind: 0 f32 copy, 1 f32->bf16,
// 2 f64 copy.  The bf16 rounding is bit-identical to bof_cast_bf16.
// nnz bounds the ja/va allocations: inconsistent CSR metadata (a
// truncated ia making starts[r]+counts[r] exceed the block's nnz — the
// case the numpy fallback clamps) must produce clamped output, not an
// out-of-bounds heap read.
void bof_ell_fill(const long long* starts, const long long* counts,
                  long long rows, long long rows_pad, long long rmax,
                  long long nnz,
                  const long long* ja, void* ja_out, int ja_kind,
                  const void* va, void* va_out, int va_kind) {
  prep_parallel(rows_pad, [&](int64_t lo, int64_t hi, int64_t) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t c = 0, s0 = 0;
      if (r < rows) {
        c = counts[r];
        if (c > rmax) c = rmax;
        if (c < 0) c = 0;
        s0 = starts[r];
        if (s0 < 0) s0 = 0;
        if (s0 > nnz) s0 = nnz;
        if (c > nnz - s0) c = nnz - s0;
      }
      if (ja_kind == 0) {
        int32_t* out = (int32_t*)ja_out + r * rmax;
        for (int64_t j = 0; j < c; ++j) out[j] = (int32_t)ja[s0 + j];
        std::memset(out + c, 0, (size_t)(rmax - c) * 4);
      } else {
        uint16_t* out = (uint16_t*)ja_out + r * rmax;
        for (int64_t j = 0; j < c; ++j) out[j] = (uint16_t)ja[s0 + j];
        std::memset(out + c, 0, (size_t)(rmax - c) * 2);
      }
      if (va_kind == 0) {
        float* out = (float*)va_out + r * rmax;
        std::memcpy(out, (const float*)va + s0, (size_t)c * 4);
        std::memset(out + c, 0, (size_t)(rmax - c) * 4);
      } else if (va_kind == 1) {
        const float* src = (const float*)va + s0;
        uint16_t* out = (uint16_t*)va_out + r * rmax;
        for (int64_t j = 0; j < c; ++j) {
          uint32_t u;
          std::memcpy(&u, &src[j], 4);
          if ((u & 0x7fffffffu) > 0x7f800000u) {  // NaN: quiet bit
            out[j] = (uint16_t)((u >> 16) | 0x0040u);
          } else {
            uint32_t x = u + 0x7fffu + ((u >> 16) & 1u);
            out[j] = (uint16_t)(x >> 16);
          }
        }
        std::memset(out + c, 0, (size_t)(rmax - c) * 2);
      } else {
        double* out = (double*)va_out + r * rmax;
        std::memcpy(out, (const double*)va + s0, (size_t)c * 8);
        std::memset(out + c, 0, (size_t)(rmax - c) * 8);
      }
    }
  });
}

// Merge adjacent pre-sorted runs (the parallel half of the reference's
// __gnu_parallel::sort role, sort_task.h:8,37 — the sorted runs come
// from numpy's SIMD np.sort on Python threads).  bounds has n_runs+1
// int64 entries; kind selects the element type; float kinds use the
// NaN-last total order matching np.sort.  Returns 0, or -1 for an
// unsupported kind (caller falls back to a whole-array np.sort).
int bof_merge_sorted_runs(void* data, const long long* bounds,
                          long long n_runs, int kind) {
  if (n_runs <= 1) return 0;
  const int64_t* b = (const int64_t*)bounds;
  switch (kind) {
    case 0: merge_runs_impl((float*)data, b, n_runs); return 0;
    case 1: merge_runs_impl((double*)data, b, n_runs); return 0;
    case 2: merge_runs_impl((int64_t*)data, b, n_runs); return 0;
    case 3: merge_runs_impl((uint64_t*)data, b, n_runs); return 0;
    case 4: merge_runs_impl((int32_t*)data, b, n_runs); return 0;
    case 5: merge_runs_impl((uint32_t*)data, b, n_runs); return 0;
    case 6: merge_runs_impl((int16_t*)data, b, n_runs); return 0;
    case 7: merge_runs_impl((uint16_t*)data, b, n_runs); return 0;
    case 8: merge_runs_impl((int8_t*)data, b, n_runs); return 0;
    case 9: merge_runs_impl((uint8_t*)data, b, n_runs); return 0;
  }
  return -1;
}

// Stable parallel counting argsort of int32 keys in [0, k): the ordering
// pass of csrcsc's phase-2 ragged merge (reference: BlockMergeTask's
// OpenMP row-parallel merge, csrcsc_task.h:101-169).  Per-thread
// histograms + cross-thread exclusive offsets keep the scatter stable.
// O(n + k*nt) beats comparison argsort even single-threaded.  Returns 0,
// or -1 when k is out of range (caller falls back to np.argsort).
int bof_counting_argsort_i32(const int* keys, long long n, long long k,
                             long long* out) {
  if (k <= 0 || k > (1 << 22)) return -1;
  if (n <= 0) return 0;
  int64_t nt = host_fanout_threads(n, 1 << 14);
  while (nt > 1 && nt * k > (int64_t)1 << 23) nt /= 2;  // histogram cap
  std::vector<int64_t> b(nt + 1), hist((size_t)nt * k, 0);
  for (int64_t i = 0; i <= nt; ++i) b[i] = i * n / nt;
  std::atomic<int> bad{0};
  {
    std::vector<std::thread> ts;
    auto count = [&](int64_t t) {
      int64_t* h = hist.data() + t * k;
      for (int64_t i = b[t]; i < b[t + 1]; ++i) {
        uint32_t key = (uint32_t)keys[i];
        if (key >= (uint64_t)k) {  // out-of-range key: abort, no UB write
          bad.store(1, std::memory_order_relaxed);
          return;
        }
        ++h[key];
      }
    };
    for (int64_t t = 1; t < nt; ++t) ts.emplace_back(count, t);
    count(0);
    for (auto& th : ts) th.join();
  }
  if (bad.load(std::memory_order_relaxed)) return -2;
  // exclusive scan: per-key base across all threads, then per-thread
  // starting offsets in stable (thread, position) order
  int64_t run = 0;
  std::vector<int64_t> start((size_t)nt * k);
  for (int64_t key = 0; key < k; ++key)
    for (int64_t t = 0; t < nt; ++t) {
      start[(size_t)t * k + key] = run;
      run += hist[(size_t)t * k + key];
    }
  {
    std::vector<std::thread> ts;
    auto scatter = [&](int64_t t) {
      int64_t* s = start.data() + t * k;
      for (int64_t i = b[t]; i < b[t + 1]; ++i)
        out[s[keys[i]]++] = i;
    };
    for (int64_t t = 1; t < nt; ++t) ts.emplace_back(scatter, t);
    scatter(0);
    for (auto& th : ts) th.join();
  }
  return 0;
}

// Fused int32-plane fold: acc[l, c] += sum_p w[p] * planes[p, l, c]
// (the sliced fp64 gemm's flush fold, ops/gemm64.py).  One parallel pass
// over the tile instead of numpy's s separate multiply-add sweeps (each
// re-reading acc and materializing an f64 temporary).  int32 -> f64
// conversion and the f64 multiply-adds are exact per element, identical
// to the numpy chain's operation order per element (w descends in p
// exactly as the caller supplies it).  acc may be a strided row view
// (acc_ld >= width) — the multihost shard regions.
void bof_fold_i32_f64(const int* planes, long long s, long long n_lines,
                      long long width, const double* w, double* acc,
                      long long acc_ld) {
  const int64_t n = (int64_t)n_lines * width;
  prep_parallel(n, [&](int64_t lo, int64_t hi, int64_t) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t line = i / width, col = i % width;
      double v = acc[line * acc_ld + col];
      for (int64_t p = 0; p < s; ++p)
        v += w[p] * (double)planes[p * n + i];
      acc[line * acc_ld + col] = v;
    }
  });
}

// Runtime toggle for span coalescing (replaces per-op getenv; see
// g_span_disable).  Exported so the Python side can mirror env changes.
void bof_set_span_disable(int disable) {
  g_span_disable.store(disable ? 1 : 0, std::memory_order_relaxed);
}

int bof_engine_start(int n_threads) {
  if (g_engine) return 0;
  // single-threaded here: seeding from the env is race-free
  g_span_disable.store(getenv("BOF_NO_SPAN_COALESCE") ? 1 : 0,
                       std::memory_order_relaxed);
  g_engine = new Engine();
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    g_engine->workers.emplace_back([] { g_engine->worker(); });
  return 0;
}

void bof_engine_stop() {
  if (!g_engine) return;
  g_engine->stop.store(true);
  g_engine->qcv.notify_all();
  for (auto& t : g_engine->workers) t.join();
  delete g_engine;
  g_engine = nullptr;
}

// mode: create? ; o_direct: open with O_DIRECT; truncate_to >0 sets size.
long long bof_open(const char* path, int create, int o_direct,
                   long long truncate_to) {
  int flags = O_RDWR | (create ? O_CREAT : 0);
#ifdef O_DIRECT
  if (o_direct) flags |= O_DIRECT;
#endif
  int fd = open(path, flags, 0644);
  if (fd < 0) return -errno;
  if (truncate_to > 0 && ftruncate(fd, truncate_to) != 0) {
    int e = errno;
    close(fd);
    return -e;
  }
  if (g_engine) {
    std::lock_guard<std::mutex> g(g_engine->fdmu);
    g_engine->fd_direct[fd] = (o_direct != 0);
  }
  return fd;
}

int bof_close(long long fd) {
  if (g_engine) {
    std::lock_guard<std::mutex> g(g_engine->fdmu);
    g_engine->fd_direct.erase((int)fd);
  }
  return close((int)fd) == 0 ? 0 : -errno;
}

long long bof_file_size(long long fd) {
  struct stat st;
  if (fstat((int)fd, &st) != 0) return -errno;
  return st.st_size;
}

int bof_truncate(long long fd, long long size) {
  return ftruncate((int)fd, size) == 0 ? 0 : -errno;
}

int bof_fsync(long long fd) { return fsync((int)fd) == 0 ? 0 : -errno; }

// Submit one strided access; returns ticket id (>=0) or -errno.
long long bof_submit(long long fd, long long offset, long long stride,
                     long long n_strides, long long len_per_stride, void* buf,
                     int is_write, long long max_chunk) {
  if (!g_engine) return -EINVAL;
  if (max_chunk <= 0) max_chunk = 32ll << 20;
  bool o_direct = false;
  {
    std::lock_guard<std::mutex> g(g_engine->fdmu);
    auto it = g_engine->fd_direct.find((int)fd);
    if (it != g_engine->fd_direct.end()) o_direct = it->second;
  }
  // Batch small runs: group consecutive strides into one worker op of
  // >= kMinOpBytes so tiny-stride panels (e.g. column blocks of row-major
  // matrices) don't flood the queue with microscopic ops.  Large runs are
  // split at max_chunk as before.
  constexpr int64_t kMinOpBytes = 1 << 20;
  // empty access: complete immediately (must precede the grouping math —
  // len_per_stride divides below, and 0 would SIGFPE the whole process)
  if (n_strides == 0 || len_per_stride == 0) {
    int64_t id = g_engine->tickets.acquire(1);
    g_engine->tickets.op_done(g_engine->tickets.get(id), 0);
    return id;
  }
  int64_t group = 1;
  // grouping only applies to runs that fit one chunk — a grouped op is
  // executed run-by-run and never chunk-split, so len > max_chunk runs
  // must stay group==1 (they take the splitting branch below)
  if (n_strides > 1 && len_per_stride < kMinOpBytes
      && len_per_stride <= max_chunk)
    group = std::min<int64_t>(n_strides,
                              (kMinOpBytes + len_per_stride - 1)
                                  / len_per_stride);
  int64_t per_group_ops =
      (len_per_stride <= max_chunk)
          ? 1
          : (len_per_stride + max_chunk - 1) / max_chunk;
  int64_t n_ops = ((n_strides + group - 1) / group) * per_group_ops;
  int64_t id = g_engine->tickets.acquire(n_ops);
  TicketSlot* slot = g_engine->tickets.get(id);
  char* base = (char*)buf;
  for (int64_t i = 0; i < n_strides; i += group) {
    int64_t runs = std::min<int64_t>(group, n_strides - i);
    int64_t fo = offset + i * stride;
    char* bp = base + i * len_per_stride;
    if (len_per_stride <= max_chunk) {
      g_engine->push(Op{(int)fd, fo, len_per_stride, bp, is_write != 0,
                        o_direct, slot, stride, runs});
    } else {
      // big run: split it (group==1 here since len >= kMinOpBytes)
      int64_t ln = len_per_stride;
      int64_t co = 0;
      while (ln > 0) {
        int64_t c = ln < max_chunk ? ln : max_chunk;
        g_engine->push(Op{(int)fd, fo + co, c, bp + co, is_write != 0,
                          o_direct, slot, 0, 1});
        co += c;
        ln -= c;
      }
    }
  }
  return id;
}

// observability: number of span-coalesced strided reads serviced
long long bof_span_ops() {
  return g_span_ops.load(std::memory_order_relaxed);
}

// observability: number of runs serviced via kernel AIO
long long bof_aio_ops() {
  return g_aio_ops.load(std::memory_order_relaxed);
}

// Runtime AIO depth (reference: MAX_SIMUL_REQS / MAX_EVENTS -D flags).
// max_events applies to aio contexts created after the call (contexts are
// lazily set up per worker thread on first eligible op).
void bof_set_aio_depth(int max_simul, int max_events) {
  if (max_simul > 0) g_max_simul.store(max_simul, std::memory_order_relaxed);
  if (max_events > 0)
    g_max_events.store((unsigned)max_events, std::memory_order_relaxed);
}

// DEBUG write read-back verification toggle (reference parity:
// flash_file_handle.cpp:394-402).
void bof_set_verify_writes(int enable) {
  g_verify_writes.store(enable ? 1 : 0, std::memory_order_relaxed);
}

int bof_poll(long long ticket) {
  if (!g_engine) return -EINVAL;
  return g_engine->tickets.poll(ticket);
}

int bof_wait(long long ticket) {
  if (!g_engine) return -EINVAL;
  return g_engine->tickets.wait_free(ticket);
}

}  // extern "C"

#include "bof_cache.inc"
