// Ring-window gather for the prefix-commit engine (kernel K1).
//
// Replaces the TPU kernel dmclock_tpu/engine/fastpath.py:156
// (_rotate_kernel, called through _rotate_rows_pallas and ring_window),
// which barrel-shifted each client's int64 ring in VMEM as int32 lane
// pairs because that stack had neither a gridded pallas_call nor a fast
// per-row gather.  On Hopper the gather is direct:
//
//   out[w, i] = ring[i, (q_head[i] + w) mod Q]   for w < W, i < N
//
// for both tail rings (q_arrival, q_cost) in one launch.
//
// Bound: pure data movement.  It reads 2*N*W*8 bytes (each window
// element once; q_head adds 4*N) and writes the same, so at the serve
// shape (N=100000, Q=320, W=32) about 102 MB, which at the H100 SXM's
// 3.35 TB/s is about 31 us.
//
// Design (simple and right first): one thread per output element, the
// client index fastest inside a block, so the stores to out[w, i]
// coalesce.  Each thread loads its ring element directly; those loads
// are strided by Q*8 bytes between neighbouring threads, the cost this
// design accepts.  A faster version loads each block's window rows
// contiguously with 16-byte loads and transposes through shared memory.
// Q need not be a power of two (320 at the serve shape), so the wrap is
// a real modulo, floored like torch.remainder.
//
// Plain C interface, loaded with ctypes (dmclock_tpu_torch/engine/_ext.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void ring_window_kernel(const int64_t* __restrict__ arr,
                                   const int64_t* __restrict__ cost,
                                   const int32_t* __restrict__ q_head,
                                   int64_t* __restrict__ out_arr,
                                   int64_t* __restrict__ out_cost,
                                   int n, int q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y;
  if (i >= n) return;
  long long pos = ((long long)q_head[i] + w) % q;
  if (pos < 0) pos += q;
  const size_t src = (size_t)i * (size_t)q + (size_t)pos;
  const size_t dst = (size_t)w * (size_t)n + (size_t)i;
  out_arr[dst] = arr[src];
  out_cost[dst] = cost[src];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// Requires 0 < w <= q, w <= 65535 (grid y), n >= 0.
extern "C" int ring_window_launch(const void* arr, const void* cost,
                                  const void* q_head, void* out_arr,
                                  void* out_cost, int n, int q, int w,
                                  void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  dim3 grid((n + threads - 1) / threads, w);
  ring_window_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)arr, (const int64_t*)cost, (const int32_t*)q_head,
      (int64_t*)out_arr, (int64_t*)out_cost, n, q);
  return (int)cudaGetLastError();
}
