// Frame trace marks (tpurast_torch/tracing.py). Replaces no TPU kernel: the
// reference has no trace of its own. A mark lives in the frame's CUDA graph,
// so it runs on every replay where a range opened from Python would run
// once, at capture.
//
// A frame's record is kSlot int64 words:
//   0 sequence number, 1..7 the times of marks 0..6 (%globaltimer, ns),
//   8 bin_overflow, 9 window_miss_px, 10 the sequence number again once the
//   record is whole, 11 the cut faces that name a tile and 12 the huge
//   faces (the binner's face counts).
// While the frame is in flight its record is `frame`, kSlot words of device
// memory. Marks 0, 1 and 6 are this file's one-thread kernel, a node of the
// graph of their own. Marks 2 to 5 fall where a hand-written kernel starts
// or ends (raster, the first and the last shading kernel): that kernel
// stamps them itself (common.cuh stamp_start, stamp_end), so they add no
// node. Mark 0 advances the sequence counter *seq, starts the record and
// zeroes the words the kernels raise to their end; mark 6 copies the
// record, with the frame's four counters, into its slot seq % slots of
// `ring`, `slots` + 1 records of host memory mapped into the device, then,
// after a system-wide fence, writes word 10: a host that reads word 10
// equal to word 0 reads a whole record, without a copy or a synchronize.
// Mark -1 writes only the calibration word, word 0 of the ring's extra
// record, and leaves the counter alone.
//
// What bounds it: each node's launch on the frame's path, about 1.5 us on
// the H100 (PERF.md); one thread, no loop.

#include "common.cuh"

namespace {

constexpr int kSlot = 16;
constexpr int kMarks = 7;
constexpr int kOverflow = 8, kMiss = 9, kDone = 10, kCut = 11, kHuge = 12;

__global__ void mark_kernel(volatile long long* ring, long long* seq, long long* frame, int slots, int mark, int last,
                            const int* overflow, const int* miss, const int* cut, const int* huge) {
  const long long t = global_ns();
  if (mark < 0) {
    ring[(long long)slots * kSlot] = t;
    return;
  }
  if (mark == 0) {
    const long long s = *seq + 1;
    *seq = s;
    frame[0] = s;
    for (int i = 2; i <= kMarks; ++i) frame[i] = 0;
  }
  frame[1 + mark] = t;
  if (last) {
    const long long s = frame[0];
    volatile long long* rec = ring + (s % slots) * kSlot;
    rec[0] = s;
    for (int i = 1; i <= kMarks; ++i) rec[i] = frame[i];
    rec[kOverflow] = overflow ? *overflow : 0;
    rec[kMiss] = miss ? *miss : 0;
    rec[kCut] = cut ? *cut : 0;
    rec[kHuge] = huge ? *huge : 0;
    __threadfence_system();
    rec[kDone] = s;
  }
}

}  // namespace

// overflow, miss: the frame's bin_overflow and window_miss_px; cut, huge:
// the binner's face counts (geometry.py bin_pairs cut_faces, huge_faces).
// Each is read by the last mark only, and null for 0.
extern "C" int tr_trace_mark(long long* ring, long long* seq, long long* frame, int slots, int mark, int last,
                             const int* overflow, const int* miss, const int* cut, const int* huge, void* stream) {
  TR_LAUNCH(mark_kernel, 1, 1, stream, ring, seq, frame, slots, mark, last, overflow, miss, cut, huge);
  return (int)cudaGetLastError();
}

// Host memory the card writes and the host reads without a copy: pinned,
// mapped into the device's address space (portable to every device). *host
// is the host's address of it, *dev the kernels'; both zeroed. Never freed:
// the trace's rings live as long as the process.
extern "C" int tr_trace_alloc(long long bytes, void** host, void** dev) {
#ifdef TR_HOST_EMU
  *host = *dev = calloc(1, (size_t)bytes);
  return *host ? 0 : (int)cudaErrorMemoryAllocation;
#else
  cudaError_t err = cudaHostAlloc(host, (size_t)bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return (int)err;
  memset(*host, 0, (size_t)bytes);
  return (int)cudaHostGetDevicePointer(dev, *host, 0);
#endif
}
