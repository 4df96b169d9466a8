// The cuda_ipc transport's control mailbox: host code, no kernel.
//
// Replaces no TPU kernel.  A cuda_ipc hop (core/dist.py, IpcChannel) tells
// its peer that a payload is in the peer's slot, and the peer answers once
// it has read it.  Those two messages travel through a mailbox in shared
// host memory, one per ordered pair of ranks, mapped once when the channel
// opens.  A cell is four int64: (gen, seq, slot, bytes).  Only one rank
// writes a cell: it stores seq, slot and bytes, then publishes gen + 1
// with release ordering and wakes a waiter.  The reader waits until gen
// reaches the count it expects, with acquire ordering, and then reads the
// three values.
//
// The wait runs here, called through ctypes, which releases the Python
// interpreter lock for the call: a rank's backward keeps running on its
// other threads while the overlap channel waits for a peer.  It spins for
// a few microseconds, then sleeps in the kernel on a futex over gen's low
// 32 bits (the mapping is shared between processes, so the futex is not
// private), which the writer wakes: a waiting rank takes no core from the
// ranks that share the host.  It returns 1 when `timeout_s` passes (the
// caller raises, naming the peer).
//
// Built by nvcc like the kernels (kernels/backend.py), with a plain C
// interface: nvcc hands host code to the host compiler.
#include <limits.h>
#include <linux/futex.h>
#include <stdint.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

namespace {

inline double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<double>(ts.tv_sec) + 1e-9 * static_cast<double>(ts.tv_nsec);
}

inline void cpu_relax() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_ia32_pause();
#elif defined(__aarch64__)
  asm volatile("yield" ::: "memory");
#endif
}

// gen's low 32 bits (little-endian: the word at gen's address).
inline int* gen_word(const int64_t* cell) {
  return reinterpret_cast<int*>(const_cast<int64_t*>(cell));
}

constexpr double kSpinS = 20e-6;    // spin this long before sleeping
constexpr long kSliceNs = 10000000;  // a sleep lasts at most this long

}  // namespace

// Publish (seq, slot, bytes) in `cell`: the values first, then gen + 1
// with release ordering, then wake the waiter.  Returns the new gen.
extern "C" int64_t mailbox_post(int64_t* cell, int64_t seq, int64_t slot,
                                int64_t nbytes) {
  __atomic_store_n(&cell[1], seq, __ATOMIC_RELAXED);
  __atomic_store_n(&cell[2], slot, __ATOMIC_RELAXED);
  __atomic_store_n(&cell[3], nbytes, __ATOMIC_RELAXED);
  const int64_t gen = __atomic_load_n(&cell[0], __ATOMIC_RELAXED) + 1;
  __atomic_store_n(&cell[0], gen, __ATOMIC_RELEASE);
  syscall(SYS_futex, gen_word(cell), FUTEX_WAKE, INT_MAX, nullptr, nullptr,
          0);
  return gen;
}

// Wait until `cell`'s gen is at least `want`, then copy (gen, seq, slot,
// bytes) into `out`.  Returns 0, or 1 after `timeout_s` with `out[0]` the
// gen last read.
extern "C" int mailbox_wait(const int64_t* cell, int64_t want,
                            double timeout_s, int64_t* out) {
  const double t0 = now_s();
  int64_t gen;
  unsigned n = 0;
  while ((gen = __atomic_load_n(&cell[0], __ATOMIC_ACQUIRE)) < want) {
    const double t = (++n & 15u) == 0 ? now_s() - t0 : 0.0;
    if (t > timeout_s) {
      out[0] = gen;
      return 1;
    }
    if (t < kSpinS) {
      cpu_relax();
      continue;
    }
    // Sleep while the word still holds what was read; a post in between
    // changes it, and the futex then returns at once.
    double left = timeout_s - t;
    long ns = left * 1e9 < kSliceNs ? static_cast<long>(left * 1e9) : kSliceNs;
    timespec slice = {0, ns > 0 ? ns : 1};
    syscall(SYS_futex, gen_word(cell), FUTEX_WAIT, static_cast<int>(gen),
            &slice, nullptr, 0);
    n |= 15u;                          // read the clock after every sleep
  }
  out[0] = gen;
  out[1] = __atomic_load_n(&cell[1], __ATOMIC_RELAXED);
  out[2] = __atomic_load_n(&cell[2], __ATOMIC_RELAXED);
  out[3] = __atomic_load_n(&cell[3], __ATOMIC_RELAXED);
  return 0;
}
