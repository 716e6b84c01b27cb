// Empty marker kernels, one per name, that split a step in a device trace.
// Plain C interface, loaded from Python with ctypes
// (ptts_torch/ops/cuda/markers.py).
//
// The serving frame body (runtime/streaming.fused_stream_step(s)) launches
// ptts_mark_flowlm before its FlowLM frames, ptts_mark_mimi before the
// streaming Mimi decode and ptts_mark_end at its end. Captured into a CUDA
// graph they are nodes of it, so every replay of the step shows in a
// profiler trace as a FlowLM stretch and a Mimi stretch between them. Each
// is one block of one thread that does nothing.

#include <cuda_runtime.h>

extern "C" __global__ void ptts_mark_flowlm() {}
extern "C" __global__ void ptts_mark_mimi() {}
extern "C" __global__ void ptts_mark_end() {}

extern "C" {

// which: 0 flowlm, 1 mimi, 2 end. Returns a cudaError_t (0 on success).
int ptts_mark(int which, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (which) {
    case 0: ptts_mark_flowlm<<<1, 1, 0, s>>>(); break;
    case 1: ptts_mark_mimi<<<1, 1, 0, s>>>(); break;
    case 2: ptts_mark_end<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
