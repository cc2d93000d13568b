// Drone point-mass MPPI solve kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of
// quadrotor_manipulator_mppi_tpu/ops/pallas/drone_kernel.py:
//   drone_cost<DRAW>, pass 1: per sample k, a = u_prev + eps, the point-mass
//     double integration and the weighted squared position error
//     S_k = sum_t w_t |q_t - target|^2 (w_t = stage_w for t < H-1, term_w
//     at H-1).
//       DRAW   <- _cost_kernel (in-kernel normals)
//       !DRAW  <- _cost_kernel_noise (explicit sigma-scaled noise)
//   drone_update<DRAW>, pass 2: du(t, a) = sum_k w_k eps_k(t, a) for the
//     softmin weights w that PyTorch forms between the passes.
//       DRAW   <- _update_kernel (draws the same normals again)
//       !DRAW  <- _update_kernel_noise (reads the explicit noise)
//
// The noise is the port's Philox stream (philox.cuh), key = the solve's
// 64-bit seed (a (1,) device tensor), counter = (0, sample k, a*H + t, 0):
// ops/sampling.philox_normals(seed, 0, K, H, A) word for word, not the
// TPU's Box-Muller bits.  Explicit noise is (K, H, A) contiguous, the JAX
// argument's layout.  The softmin and the tail (SavGol, u_prev + du) stay
// PyTorch ops, as they stay XLA ops around the TPU kernels.
//
// What bounds them on this card.  Per element (k, t, a) pass 1 does one
// Philox draw (~100 integer operations), the erfinv normal (~35) and the
// integration and cost (~10): 14 M operations at the preset K=1000, H=32,
// 0.2 us at the float32 rate, and it moves only u_prev, three 3-vectors and
// S.  Pass 2 on the drawn noise is the same draw again plus a multiply-add.
// On explicit noise both read 12 B per sample and step (0.38 MB at the
// preset, 0.1 us).  So both are operation bound on paper; in practice
// launch and dependent latency dominate at the preset.  At K=16384,
// H=100 pass 2 on explicit noise moves 19.7 MB (5.9 us) and on drawn noise
// does 0.67 G operations (10 us at the float32 rate).
//
// What the design does about it (simple first).  The Pallas layout is
// Mosaic's workaround and is not carried over: no 128-lane tiles (any
// K >= 1 runs; a warp past K exits), no Kronecker (H*A, H*A) triangular
// matmuls, no per-tile du partials summed on the host, no 24-bit masking.
//   drone_cost: one warp per sample, DRONE_COST_WARPS samples a block, the
//   horizon across the lanes in chunks of 32 steps (the TPU kernel's time
//   parallelism: its triangular matmuls become warp scans).  Per action a
//   lane draws (or reads) its step's noise, two prefix sums (warp_scan.cuh)
//   give the velocity and the position, the chunk's last lane carries both
//   into the next chunk; the lanes' squared errors meet in a fixed-order
//   warp sum.  The chain per lane is A draws per chunk, not H*A.  On
//   explicit noise a warp reads its sample's contiguous H*A floats.
//   drone_update: column blocks.  The noise is a row-major (K, C) matrix,
//   C = H*A, column c = t*A + a.  Where K is large a block takes a tile of
//   DRONE_UPDATE_TILE = 32 consecutive columns (lane = column) and one
//   chunk of samples (warp w takes the chunk's samples w, w + 8, ...), so
//   each warp reads 128 contiguous bytes per sample; the tiles alone would
//   leave the card idle, so K is split into chunks across blocks, each
//   block writes its 32 column partials, and the last block of a tile to
//   finish (an integer ticket per tile, reset by that block) sums the
//   chunks' partials: its warp w a fixed range of chunks in order, then
//   the warps in order.  Where K is small (the preset's K=1000) the
//   fence, the ticket and the read-back of that cross-block sum cost more
//   than the whole reduction, so a block takes one column and all K (the
//   32 lanes of a warp on 32 samples, met in a fixed butterfly) and C
//   blocks fill the card.  The tile width and the chunks are one rule of
//   (K, H, A) (update_split in ops/cuda/drone_kernel.py), measured on the
//   H100.  Every sum runs in a fixed order (a thread's samples in order,
//   the butterfly, the warps in order, the chunk ranges in order), with no
//   float atomics: du is bit-equal on reruns.  The draw variant shares the
//   body, the rule and the order, drawing element (k, c) at counter
//   (0, k, a*H + t, 0), so its du is bit-equal to the read variant's on
//   the noise it draws.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "warp_scan.cuh"

#define DRONE_COST_WARPS 4     // samples (one warp each) per drone_cost block
#define DRONE_UPDATE_TILE 32   // columns of a wide drone_update block, one per lane
#define DRONE_UPDATE_WARPS 8   // warps per drone_update block
#define DRONE_UPDATE_LOADS 8   // partials a warp of a tile's last block loads at once

// Pass 1.  u_prev (H, A); x0, v0, target (A,); noise (K, H, A) (!DRAW);
// seeds (1,) (DRAW); s (K,) out.  Warp w of block g takes sample
// k = g * DRONE_COST_WARPS + w; lane = horizon step within a chunk.
template <bool DRAW>
__global__ void __launch_bounds__(DRONE_COST_WARPS * WARP_LANES)
drone_cost_kernel(const float* __restrict__ u_prev, const float* __restrict__ x0,
                  const float* __restrict__ v0, const float* __restrict__ target,
                  const float* __restrict__ noise, const unsigned long long* __restrict__ seeds,
                  int K, int H, int A, float dt, float sigma, float stage_w, float term_w,
                  float* __restrict__ s) {
  extern __shared__ float smem[];  // [H * A warm start | x0 | v0 | target]
  float* u_sm = smem;
  float* x0_sm = smem + H * A;
  float* v0_sm = x0_sm + A;
  float* tg_sm = v0_sm + A;
  for (int i = threadIdx.x; i < H * A; i += blockDim.x) u_sm[i] = u_prev[i];
  for (int i = threadIdx.x; i < A; i += blockDim.x) {
    x0_sm[i] = x0[i];
    v0_sm[i] = v0[i];
    tg_sm[i] = target[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & (WARP_LANES - 1);
  const int k = blockIdx.x * DRONE_COST_WARPS + threadIdx.x / WARP_LANES;
  if (k >= K) return;  // the whole warp

  uint32_t key0 = 0u, key1 = 0u;
  if (DRAW) philox_key(seeds, 0, key0, key1);
  float stage = 0.0f, term = 0.0f;  // this lane's squared errors
  for (int a = 0; a < A; ++a) {
    const float q0 = x0_sm[a], vel0 = v0_sm[a], tg = tg_sm[a];
    float cvc = 0.0f;  // carry-in: sum of acc * dt
    float cqc = 0.0f;  // carry-in: sum of v_prev * dt + 0.5 * acc * dt * dt
    for (int t0 = 0; t0 < H; t0 += WARP_LANES) {
      const int t = t0 + lane;
      const bool active = t < H;
      float e = 0.0f;
      if (active)
        e = DRAW ? draw_eps(0u, (uint32_t)k, (uint32_t)(a * H + t), sigma, key0, key1)
                 : noise[((size_t)k * H + t) * A + a];
      const float acc = u_sm[(active ? t : H - 1) * A + a] + e;
      const float cv = scan_add(lane == 0 ? cvc + acc * dt : acc * dt, lane);
      float cv_prev = __shfl_up_sync(FULL_MASK, cv, 1);
      if (lane == 0) cv_prev = cvc;
      const float inc = (cv_prev + vel0) * dt + 0.5f * acc * dt * dt;
      const float cq = scan_add(lane == 0 ? cqc + inc : inc, lane);
      const float err = (cq + q0) - tg;
      if (active) {
        if (t < H - 1)
          stage += err * err;
        else
          term += err * err;
      }
      if (t0 + WARP_LANES < H) {
        cvc = from_last(cv);
        cqc = from_last(cq);
      }
    }
  }
  stage = warp_sum(stage);
  term = warp_sum(term);
  if (lane == 0) s[k] = stage_w * stage + term_w * term;
}

// Pass 2.  w (K,); noise (K, H, A) (!DRAW); seeds (1,) (DRAW); du (H, A)
// out.  Block (b, chunk) sums columns b*tile .. b*tile + tile - 1 over the
// samples chunk*k_chunk .. chunk*k_chunk + k_chunk - 1; tile is 1 or
// DRONE_UPDATE_TILE.  Lane l takes column l % tile and, of the 32 / tile
// samples its warp reads at once, sample l / tile.  With more than one
// chunk, partials (n_chunks, C) and tickets (one per column block, zero on
// entry and left zero) carry the cross-block sum.
template <bool DRAW>
__global__ void __launch_bounds__(DRONE_UPDATE_WARPS * WARP_LANES)
drone_update_kernel(const float* __restrict__ w, const float* __restrict__ noise,
                    const unsigned long long* __restrict__ seeds, int K, int H, int A,
                    float sigma, int tile, int k_chunk, float* __restrict__ partials,
                    unsigned int* __restrict__ tickets, float* __restrict__ du) {
  __shared__ float red[DRONE_UPDATE_WARPS][WARP_LANES];
  __shared__ bool last;
  const int lane = threadIdx.x & (WARP_LANES - 1), warp = threadIdx.x / WARP_LANES;
  const int C = H * A;
  const int rows = WARP_LANES / tile;  // samples a warp reads at once
  const int c = blockIdx.x * tile + (lane & (tile - 1));
  const bool live = c < C;
  const bool writer = live && lane < tile;  // the column's first lane
  const int t = c / A, a = c - t * A;
  const uint32_t row = (uint32_t)(a * H + t);
  const int chunk = blockIdx.y, n_chunks = gridDim.y;
  const int k_end = min(K, (chunk + 1) * k_chunk);
  uint32_t key0 = 0u, key1 = 0u;
  if (DRAW) philox_key(seeds, 0, key0, key1);

  // A thread's samples in order.  Reads are unrolled (loads in flight);
  // draws are not: with a few draws a thread, an unrolled body and its
  // remainder loop would split a warp and run both, one after the other.
  float acc = 0.0f;
  const int k0 = chunk * k_chunk + warp * rows + lane / tile, dk = DRONE_UPDATE_WARPS * rows;
  if (DRAW) {
#pragma unroll 1
    for (int k = k0; k < k_end; k += dk)
      acc += w[k] * (live ? draw_eps(0u, (uint32_t)k, row, sigma, key0, key1) : 0.0f);
  } else {
#pragma unroll 4
    for (int k = k0; k < k_end; k += dk) acc += w[k] * (live ? noise[(size_t)k * C + c] : 0.0f);
  }
  // A column's lanes meet in a fixed butterfly (every lane gets the same
  // bits), then warp 0 sums the warps in order.
  for (int off = WARP_LANES / 2; off >= tile; off >>= 1)
    acc += __shfl_xor_sync(FULL_MASK, acc, off);
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float sum = red[0][lane];
#pragma unroll
    for (int i = 1; i < DRONE_UPDATE_WARPS; ++i) sum += red[i][lane];
    if (n_chunks == 1) {
      if (writer) du[c] = sum;
    } else {
      if (writer) partials[(size_t)chunk * C + c] = sum;
      __threadfence();  // this block's partials reach the device before its ticket
      __syncwarp();
      if (lane == 0) last = atomicAdd(&tickets[blockIdx.x], 1u) == (unsigned int)(n_chunks - 1);
    }
  }
  if (n_chunks == 1) return;
  __syncthreads();
  if (!last) return;

  // The column block's last block: warp w sums its fixed range of chunks in
  // order, DRONE_UPDATE_LOADS loads in flight, then warp 0 sums the warps in
  // order.
  __threadfence();
  const int per = (n_chunks + DRONE_UPDATE_WARPS - 1) / DRONE_UPDATE_WARPS;
  const int i_end = min(n_chunks, (warp + 1) * per);
  float part = 0.0f;
  for (int i0 = warp * per; i0 < i_end; i0 += DRONE_UPDATE_LOADS) {
    float v[DRONE_UPDATE_LOADS];
#pragma unroll
    for (int j = 0; j < DRONE_UPDATE_LOADS; ++j)
      v[j] = (writer && i0 + j < i_end) ? __ldcg(partials + (size_t)(i0 + j) * C + c) : 0.0f;
#pragma unroll
    for (int j = 0; j < DRONE_UPDATE_LOADS; ++j)
      if (i0 + j < i_end) part += v[j];
  }
  red[warp][lane] = part;
  __syncthreads();
  if (warp != 0) return;
  float total = red[0][lane];
#pragma unroll
  for (int i = 1; i < DRONE_UPDATE_WARPS; ++i) total += red[i][lane];
  if (writer) du[c] = total;
  if (lane == 0) tickets[blockIdx.x] = 0u;  // every block of this column block has arrived
}

extern "C" {

// Pass 1 over k samples.  noise == NULL: draw the noise (Philox key
// seeds[0], scaled by sigma); else read it.  Returns cudaGetLastError()
// after the launch.
int drone_cost_launch(const float* u_prev, const float* x0, const float* v0,
                      const float* target, const float* noise,
                      const unsigned long long* seeds, int k, int h, int a, float dt,
                      float sigma, float stage_w, float term_w, float* s, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)(h * a + 3 * a) * sizeof(float);
  const int blocks = (k + DRONE_COST_WARPS - 1) / DRONE_COST_WARPS;
  const int threads = DRONE_COST_WARPS * WARP_LANES;
  if (noise)
    drone_cost_kernel<false><<<blocks, threads, smem, st>>>(
        u_prev, x0, v0, target, noise, seeds, k, h, a, dt, sigma, stage_w, term_w, s);
  else
    drone_cost_kernel<true><<<blocks, threads, smem, st>>>(
        u_prev, x0, v0, target, noise, seeds, k, h, a, dt, sigma, stage_w, term_w, s);
  return (int)cudaGetLastError();
}

// Pass 2 over ceil(h*a / tile) column blocks x ceil(k / k_chunk) sample
// chunks; tile is 1 or DRONE_UPDATE_TILE.  noise == NULL: draw the noise
// again as pass 1 did; else read it.  With more than one chunk, partials
// holds (chunks, h*a) floats and tickets one zeroed unsigned int per
// column block (the kernel leaves them zero).
int drone_update_launch(const float* w, const float* noise, const unsigned long long* seeds,
                        int k, int h, int a, float sigma, int tile, int k_chunk, float* partials,
                        unsigned int* tickets, float* du, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 0 || k_chunk <= 0 || (tile != 1 && tile != DRONE_UPDATE_TILE))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((h * a + tile - 1) / tile, (k + k_chunk - 1) / k_chunk);
  const int threads = DRONE_UPDATE_WARPS * WARP_LANES;
  if (noise)
    drone_update_kernel<false><<<grid, threads, 0, st>>>(w, noise, seeds, k, h, a, sigma, tile,
                                                         k_chunk, partials, tickets, du);
  else
    drone_update_kernel<true><<<grid, threads, 0, st>>>(w, noise, seeds, k, h, a, sigma, tile,
                                                        k_chunk, partials, tickets, du);
  return (int)cudaGetLastError();
}

}  // extern "C"
