// The cuda_ipc transport's control path on the card: no host wait.
//
// Replaces no TPU kernel.  A cuda_ipc hop (core/dist.py, IpcChannel) tells
// its peer that a payload is in the peer's slot, and the peer answers once
// it has read it.  Both messages are 64-bit counters in device memory, on
// 128-byte lines of their own, which only the writing peer writes; each
// rank's counters are mapped once by its peers when the channel opens.  A
// message is a write of the counter's next value on the writer's stream,
// ordered after the work before it (the copy into the slot, the consumer
// that read it) by the write's memory barrier; the reader's stream waits
// on the card until the counter reaches the value it expects.  The host
// only enqueues: a hop returns without waiting for a peer.
//
// The waits are cuStreamWaitValue64 (CU_STREAM_WAIT_VALUE_GEQ), the
// writes cuStreamWriteValue64: the driver's stream memory operations,
// which come through cudaGetDriverEntryPoint, so the build needs no
// -lcuda.
//
// ipc_signal also stores (seq, bytes) of a payload into the receiver's
// byte-count log, in shared host memory, before it enqueues the notify:
// the receiver's host checks the byte counts when it next synchronises
// with its channel stream (the host store precedes the enqueue, which
// precedes the receiver's wait on the card).
//
// Built by nvcc like the kernels (kernels/backend.py), with a plain C
// interface.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using WaitValue64 = CUresult (*)(CUstream, CUdeviceptr, cuuint64_t,
                                 unsigned int);
using WriteValue64 = CUresult (*)(CUstream, CUdeviceptr, cuuint64_t,
                                  unsigned int);
using DeviceGet = CUresult (*)(CUdevice*, int);
using DeviceGetAttribute = CUresult (*)(int*, CUdevice_attribute, CUdevice);

WaitValue64 wait_value = nullptr;
WriteValue64 write_value = nullptr;

// Returned when the driver has no entry point of that name (then
// kNoEntry + the query's result).
constexpr int kNoEntry = 1000;

template <class F>
int entry(const char* name, F* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaError_t rc = cudaGetDriverEntryPointByVersion(name, &p, 12000,
                                                    cudaEnableDefault, &found);
#else
  cudaError_t rc = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault,
                                           &found);
#endif
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (found != cudaDriverEntryPointSuccess || p == nullptr)
    return kNoEntry + static_cast<int>(found);
  *fn = reinterpret_cast<F>(p);
  return 0;
}

}  // namespace

// Resolve the driver's functions and read, for `device`, the attribute
// CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS into `*support`.
// Returns 0, a cudaError_t, kNoEntry + a query result, or a CUresult.
extern "C" int ipc_open(int device, int* support) {
  DeviceGet get = nullptr;
  DeviceGetAttribute attribute = nullptr;
  int rc;
  if ((rc = entry("cuDeviceGet", &get)) != 0) return rc;
  if ((rc = entry("cuDeviceGetAttribute", &attribute)) != 0) return rc;
  if ((rc = entry("cuStreamWaitValue64", &wait_value)) != 0) return rc;
  if ((rc = entry("cuStreamWriteValue64", &write_value)) != 0) return rc;
  CUdevice dev;
  if ((rc = static_cast<int>(get(&dev, device))) != 0) return rc;
  return static_cast<int>(attribute(
      support, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, dev));
}

// `stream` waits on the card until the counter at `addr` is >= `value`,
// then writes `count` into `done` (mapped host memory: the host reads
// which of its waits have passed without a call into CUDA, which could
// queue behind the blocked stream).
extern "C" int ipc_wait(void* stream, uint64_t addr, uint64_t value,
                        uint64_t done, uint64_t count) {
  const CUstream s = static_cast<CUstream>(stream);
  CUresult rc = wait_value(s, static_cast<CUdeviceptr>(addr), value,
                           CU_STREAM_WAIT_VALUE_GEQ);
  if (rc != CUDA_SUCCESS) return static_cast<int>(rc);
  return static_cast<int>(write_value(s, static_cast<CUdeviceptr>(done),
                                      count,
                                      CU_STREAM_WRITE_VALUE_DEFAULT));
}

// `n` int64 cells of pinned host memory mapped for the card, zeroed: the
// host's address in `*host`, the card's in `*dev` (the stream memory
// operations write host memory allocated mapped).
extern "C" int ipc_host_cells(int n, uint64_t* host, uint64_t* dev) {
  void* p = nullptr;
  cudaError_t rc = cudaHostAlloc(&p, n * sizeof(int64_t),
                                 cudaHostAllocMapped | cudaHostAllocPortable);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  memset(p, 0, n * sizeof(int64_t));
  void* d = nullptr;
  rc = cudaHostGetDevicePointer(&d, p, 0);
  *host = reinterpret_cast<uint64_t>(p);
  *dev = reinterpret_cast<uint64_t>(d);
  return static_cast<int>(rc);
}

// Store (seq, bytes) into `log` (two int64 in shared host memory; none
// when null) with release ordering, then enqueue on `stream` the write of
// `value` into the counter at `addr`, after a memory barrier.
extern "C" int ipc_signal(void* stream, int64_t* log, int64_t seq,
                          int64_t nbytes, uint64_t addr, uint64_t value) {
  if (log != nullptr) {
    __atomic_store_n(&log[1], nbytes, __ATOMIC_RELAXED);
    __atomic_store_n(&log[0], seq, __ATOMIC_RELEASE);
  }
  return static_cast<int>(write_value(static_cast<CUstream>(stream),
                                      static_cast<CUdeviceptr>(addr), value,
                                      CU_STREAM_WRITE_VALUE_DEFAULT));
}
