// Ring-window gather for the prefix-commit and calendar engines (kernel K1).
//
// Replaces the TPU kernel dmclock_tpu/engine/fastpath.py:156
// (_rotate_kernel, called through _rotate_rows_pallas and ring_window),
// which barrel-shifted each client's int64 ring in VMEM as int32 lane
// pairs because that stack had neither a gridded pallas_call nor a fast
// per-row gather.  On Hopper the gather is direct:
//
//   out[j, i] = ring[i, (q_head[i] + j) mod Q]   for j < W, i < N
//
// for both tail rings (q_arrival, q_cost) in one launch, with the
// floored modulo of torch.remainder for any int32 q_head.
//
// Bound: pure data movement.  It reads 2*N*W*8 bytes (each window
// element once; q_head adds 4*N) and writes the same: at the serve shape
// (N=100000, Q=320, W=32) about 102.8 MB, 30.7 us at the H100 SXM's
// 3.35 TB/s; at the cfg4 shape (Q=128, W=64) twice that.
//
// What holds a naive gather back, and what this design does about it:
// - Each client's window is a contiguous run of its ring row (split in
//   two at the wrap), but the output is transposed: out[j, i..i+31] are
//   32 different ring rows.  One thread per output element makes
//   neighbouring threads load addresses Q*8 bytes apart, 32 sectors per
//   warp load for 256 useful bytes.  Here one block owns a tile of 32
//   consecutive clients and both rings.  Load phase: each warp reads one
//   client's chunk of window rows as a contiguous run (32 lanes x 8 B =
//   256 B per instruction) into shared memory s[ring][client][row].
//   Store phase: each warp writes one output row for the tile's 32
//   clients, 256 contiguous bytes of out[j, i0:i0+32].  The shared row
//   stride is kChunk + 1 words, so the transposed read (lane = client)
//   hits 32 distinct banks.
// - The window is walked in chunks of kChunk rows (W = 320 takes 5), so
//   the shared tile stays at 2 x 32 x 65 x 8 B = 33,280 B, under the
//   48 KB static limit.
// - Each warp's loads are unrolled into registers before any is stored
//   (a client's offset serves both rings), so a warp keeps up to 16
//   independent 8-byte loads in flight, and the launch bounds hold the
//   registers to what lets three or more blocks share an SM: enough bytes
//   in flight to cover the memory latency, and one block's stores
//   overlap another's loads.  (Left to itself the compiler takes over
//   100 registers, and with one block per SM the kernel runs well
//   slower.)
// - No 64-bit modulo: base = floor_mod(q_head[i], Q) once per client in
//   32-bit arithmetic, then pos = base + j with one conditional
//   subtraction of Q, exact because W <= Q.
// - TMA does not fit: a client's window starts at an arbitrary 8-byte
//   offset, and a bulk copy needs 16-byte-aligned addresses and sizes.
//
// Plain C interface, loaded with ctypes (dmclock_tpu_torch/engine/_ext.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // clients per block
constexpr int kChunk = 64;                // window rows per chunk
constexpr int kStride = kChunk + 1;       // padded shared row (words)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;             // per SM: caps registers at 80
constexpr int kClientsPerWarp = kTile / kWarps;
constexpr int kLanesPerRun = kChunk / 32;             // loads per lane per run
constexpr int kRowsPerWarp = 2 * kChunk / kWarps;     // output rows per chunk

__global__ void __launch_bounds__(kThreads, kMinBlocks)
ring_window_kernel(const long long* __restrict__ arr,
                   const long long* __restrict__ cost,
                   const int32_t* __restrict__ q_head,
                   long long* __restrict__ out_arr,
                   long long* __restrict__ out_cost, int n, int q, int w) {
  __shared__ long long s[2][kTile][kStride];
  __shared__ int s_base[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i0 = blockIdx.x * kTile;
  const int tile = min(kTile, n - i0);

  if (warp == 0 && lane < tile) {
    int b = q_head[i0 + lane] % q;        // truncated: in (-q, q)
    s_base[lane] = b < 0 ? b + q : b;     // floored, as torch.remainder
  }
  __syncthreads();

  // the tile's rows of both rings; client c's run starts c * q words in
  // (32-bit: the tile spans 32 * q < 2^31 words)
  const long long* arr_t = arr + (size_t)i0 * q;
  const long long* cost_t = cost + (size_t)i0 * q;
  for (int j0 = 0; j0 < w; j0 += kChunk) {
    const int rows = min(kChunk, w - j0);

    // load: warp `warp` reads clients c = warp + k * kWarps, both rings,
    // lane reading window rows lane and lane + 32 of the chunk
    long long va[kClientsPerWarp][kLanesPerRun];
    long long vc[kClientsPerWarp][kLanesPerRun];
#pragma unroll
    for (int k = 0; k < kClientsPerWarp; ++k) {
      const int c = warp + k * kWarps;
#pragma unroll
      for (int h = 0; h < kLanesPerRun; ++h) {
        const int r = lane + 32 * h;
        if (c < tile && r < rows) {
          int pos = s_base[c] + j0 + r;   // < 2q: base < q, j0 + r < w <= q
          if (pos >= q) pos -= q;
          const int off = c * q + pos;
          va[k][h] = __ldg(arr_t + off);
          vc[k][h] = __ldg(cost_t + off);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kClientsPerWarp; ++k) {
      const int c = warp + k * kWarps;
#pragma unroll
      for (int h = 0; h < kLanesPerRun; ++h) {
        const int r = lane + 32 * h;
        if (c < tile && r < rows) {
          s[0][c][r] = va[k][h];
          s[1][c][r] = vc[k][h];
        }
      }
    }
    __syncthreads();

    // store: warp `warp` writes output rows p = warp + k * kWarps, ring
    // p % 2, window row p / 2; lane = client
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int p = warp + k * kWarps;
      const int ring = p & 1;
      const int r = p >> 1;
      if (r < rows && lane < tile) {
        long long* dst = ring ? out_cost : out_arr;
        dst[(size_t)(j0 + r) * n + i0 + lane] = s[ring][lane][r];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a window outside (0, q], a ring wider than
// 2^26 (the tile's 32-bit offsets) or a negative n.
extern "C" int ring_window_launch(const void* arr, const void* cost,
                                  const void* q_head, void* out_arr,
                                  void* out_cost, int n, int q, int w,
                                  void* stream) {
  if (n < 0 || w <= 0 || w > q || q > (1 << 26))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int blocks = (n + kTile - 1) / kTile;
  ring_window_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)arr, (const long long*)cost, (const int32_t*)q_head,
      (long long*)out_arr, (long long*)out_cost, n, q, w);
  return (int)cudaGetLastError();
}
