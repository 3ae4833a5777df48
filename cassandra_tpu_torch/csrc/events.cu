// Timing events for the profiling registry (service/profiling.py): each
// kernel wrapper's call is bracketed by two events recorded on the
// current stream, and their interval is read once both have completed.
// Plain C over the CUDA runtime, so that creating, recording and reading
// an event each cost one ctypes call; the registry keeps the events in a
// pool per device and reuses them.
#include <cuda_runtime.h>

extern "C" void* ctpu_event_create() {
  cudaEvent_t e = nullptr;
  if (cudaEventCreate(&e) != cudaSuccess) {
    cudaGetLastError();
    return nullptr;
  }
  return (void*)e;
}

extern "C" int ctpu_event_record(void* e, void* stream) {
  return (int)cudaEventRecord((cudaEvent_t)e, (cudaStream_t)stream);
}

// The milliseconds of event pairs in order, into ms[0, n): returns how
// many have completed (it stops at the first pair still pending; wait:
// wait for the first pair's end first), or -1 - the error on another
// failure. The pending case leaves no error behind for the next
// launch's cudaGetLastError.
extern "C" int ctpu_events_ms(void* const* starts, void* const* ends, int n,
                              int wait, float* ms) {
  if (wait && n > 0) {
    const cudaError_t e = cudaEventSynchronize((cudaEvent_t)ends[0]);
    if (e != cudaSuccess) return -1 - (int)e;
  }
  for (int i = 0; i < n; ++i) {
    const cudaError_t e = cudaEventElapsedTime(
        ms + i, (cudaEvent_t)starts[i], (cudaEvent_t)ends[i]);
    if (e == cudaErrorNotReady) {
      cudaGetLastError();
      return i;
    }
    if (e != cudaSuccess) return -1 - (int)e;
  }
  return n;
}
