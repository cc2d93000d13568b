// Warp scans over the horizon, shared by the kernels that put one sample's
// horizon steps across the 32 lanes of a warp (lane = step within a chunk
// of 32 steps).  Each scan is Kogge-Stone: WARP_SCAN shuffle steps in a
// fixed order, so a rerun gives the same bits.  A lane's input holds its
// own step's term; lane 0's input also holds the carry-in from the previous
// chunk, so the scan's result is the recurrence's value at every step.

#pragma once

#define WARP_LANES 32
#define WARP_SCAN 5  // log2(WARP_LANES)
#define FULL_MASK 0xffffffffu

// Inclusive prefix sum: x_t = x_{t-1} + y_t.
__device__ __forceinline__ float scan_add(float y, int lane) {
#pragma unroll
  for (int i = 0; i < WARP_SCAN; ++i) {
    const float o = __shfl_up_sync(FULL_MASK, y, 1 << i);
    if (lane >= (1 << i)) y += o;
  }
  return y;
}

// x_t = c x_{t-1} + y_t for a constant c, with cp[i] = c^(2^i): after the
// step of offset d = 2^i a lane holds the sum over its last 2d steps, so
// the window below it enters scaled by c^d.
__device__ __forceinline__ float scan_affine(float y, const float* cp, int lane) {
#pragma unroll
  for (int i = 0; i < WARP_SCAN; ++i) {
    const float o = __shfl_up_sync(FULL_MASK, y, 1 << i);
    if (lane >= (1 << i)) y += cp[i] * o;
  }
  return y;
}

// The fixed-order butterfly sum over the lanes: every lane gets the same
// bits (each step adds the same pair in either lane).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = WARP_LANES / 2; off > 0; off >>= 1) x += __shfl_xor_sync(FULL_MASK, x, off);
  return x;
}

// The value of the chunk's last lane, the next chunk's carry-in.
__device__ __forceinline__ float from_last(float x) {
  return __shfl_sync(FULL_MASK, x, WARP_LANES - 1);
}
