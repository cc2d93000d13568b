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
// launch and dependent latency dominate: one thread walking a sample's
// horizon is a chain of H*A = 96 draws (~19 us at any K up to 16384).
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
//   drone_update: one block per (t, a) row, H*A blocks; threads stride over
//   k and reduce in a fixed order (warp shuffles, then the warps' partials
//   in order): deterministic, no atomics, du (H, A) written directly.
//   The explicit-noise read of pass 2 strides H*A floats between
//   neighbouring threads (uncoalesced; kept for now).

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "warp_scan.cuh"

#define DRONE_COST_WARPS 4   // samples (one warp each) per drone_cost block
#define DRONE_UPDATE_THREADS 256

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

// Pass 2, one block per row = a*H + t.  w (K,); noise (K, H, A) (!DRAW);
// seeds (1,) (DRAW); du (H, A) out.
template <bool DRAW>
__global__ void __launch_bounds__(DRONE_UPDATE_THREADS)
drone_update_kernel(const float* __restrict__ w, const float* __restrict__ noise,
                    const unsigned long long* __restrict__ seeds, int K, int H, int A,
                    float sigma, float* __restrict__ du) {
  __shared__ float red[DRONE_UPDATE_THREADS / 32];
  const int row = blockIdx.x;
  const int a = row / H, t = row - a * H;
  uint32_t key0 = 0u, key1 = 0u;
  if (DRAW) philox_key(seeds, 0, key0, key1);
  float acc = 0.0f;
  for (int k = threadIdx.x; k < K; k += DRONE_UPDATE_THREADS) {
    const float e = DRAW ? draw_eps(0u, (uint32_t)k, (uint32_t)row, sigma, key0, key1)
                         : noise[((size_t)k * H + t) * A + a];
    acc += w[k] * e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int i = 0; i < DRONE_UPDATE_THREADS / 32; ++i) sum += red[i];
    du[t * A + a] = sum;
  }
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

// Pass 2, H*A blocks.  noise == NULL: draw the noise again as pass 1 did;
// else read it.
int drone_update_launch(const float* w, const float* noise, const unsigned long long* seeds,
                        int k, int h, int a, float sigma, float* du, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (noise)
    drone_update_kernel<false><<<h * a, DRONE_UPDATE_THREADS, 0, st>>>(w, noise, seeds, k, h,
                                                                         a, sigma, du);
  else
    drone_update_kernel<true><<<h * a, DRONE_UPDATE_THREADS, 0, st>>>(w, noise, seeds, k, h,
                                                                        a, sigma, du);
  return (int)cudaGetLastError();
}

}  // extern "C"
