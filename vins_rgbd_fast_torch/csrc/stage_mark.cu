// The tracer's stage mark (utils/timing.py ``Tracer.mark``): one thread
// reads the card's nanosecond clock and adds the time since the previous
// mark to one stage's sum and count.
//
// Replaces no TPU kernel.  It exists because a CUDA graph replays no host
// range: the frame program's step (parallel/batched_pipeline.py
// ``_FrameProgram``) launches it at its stage boundaries while the tracer
// is on, the capture records those launches, and every replay then times
// its stages on the card in stream order.  Its plain version is the host
// stamp ``Tracer.mark`` takes on the CPU.
//
// Bound: one 8-byte read and at most three 8-byte writes, nothing a
// roofline can see; its cost is one more node of the graph (a launch, about
// a microsecond) that waits for the kernels before it, as the stage's end
// does anyway.
//
// buf (int64, on the card): [last, sum_0 .. sum_4, count_0 .. count_4];
// stage -1 only sets ``last`` (the step's first mark).

#include <cuda_runtime.h>

#include "current_device.cuh"

namespace {

constexpr int N_STAGES = 5;

__global__ void stage_mark_kernel(unsigned long long* buf, int stage) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (stage >= 0) {
    buf[1 + stage] += now - buf[0];
    buf[1 + N_STAGES + stage] += 1;
  }
  buf[0] = now;
}

}  // namespace

extern "C" int stage_mark_launch(unsigned long long* buf, int stage, int device,
                                 cudaStream_t stream) {
  if (stage < -1 || stage >= N_STAGES) return (int)cudaErrorInvalidValue;
  const cudaError_t st = check_current_device(device);
  if (st != cudaSuccess) return (int)st;
  stage_mark_kernel<<<1, 1, 0, stream>>>(buf, stage);
  return (int)cudaGetLastError();
}
