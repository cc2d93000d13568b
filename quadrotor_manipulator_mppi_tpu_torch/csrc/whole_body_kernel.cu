// Whole-body MPPI solve kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of
// quadrotor_manipulator_mppi_tpu/ops/pallas/whole_body_kernel.py:
//   wb_cost<MODE, DRAW, STORE>, pass 1: noise draw, rollout, 7-joint FK,
//     the whole cost stack, per-group softmin partials (_softmin_partials).
//       DRAW, STORE   <- _cost_kernel_store (in-kernel PRNG, noise spilled)
//       DRAW, !STORE  <- _cost_kernel (in-kernel PRNG, no spill)
//       !DRAW         <- _cost_kernel_noise (explicit noise)
//   wb_prologue, before pass 1: the solve's scalar pack from the
//     observation, the live sigma and the sigma schedule's 7-joint FK.  It
//     replaces no TPU kernel: under jit, XLA fuses the JAX step's prologue;
//     the port's eager PyTorch ran it as ~640 small kernels.
//   wb_update<REGEN, GIVEN>, pass 2: softmin weights, the weighted noise
//     sum du and the weighted second moment for adaptive sigma, per row.
//       !REGEN, !GIVEN <- _update_kernel_fused_noise / _fused_update_body
//       REGEN,  !GIVEN <- _update_kernel_fused (draws the noise again)
//       REGEN,  GIVEN  <- _update_kernel (sharded; draws the noise again)
//       !REGEN, GIVEN  <- _update_kernel_noise (sharded; reads the noise)
//     GIVEN: the global (rho, eta) arrive from the host's collectives (the
//     sample-sharded solve); otherwise they are combined from this solve's
//     per-group partials.  The per-tile du/m2 partials of the sharded TPU
//     kernels exist only for Mosaic; here each rank writes one row per
//     (a, t) and the host all-reduces it.
//
// Every variant takes a second grid dimension over independent scenarios
// (blockIdx.y): per-scenario scalars, warm start, noise, costs and partials
// are contiguous slabs, and each scenario has its own Philox key, so one
// launch solves a batch of B problems.  Slab offsets are size_t (the noise
// of 256 scenarios at K=4096, H=50 is 577 M floats).
//
// What bounds them on this card.
//   wb_cost is bound by arithmetic, not by bytes: per sample and step ~11
//   Philox draws + erfinv, a 7-joint quaternion FK (7 sincos), an atan2 and
//   the cost terms, about 2.4 k operations (~0.5 GFLOP per solve at K=4096,
//   H=50), while it moves only the noise (K*H*11*4 B = 9.0 MB).  Each
//   horizon recurrence (double integration, rotor lag, axis response, drag,
//   position, rate damping, the wrench attitude) chains step t to t - 1, so
//   a thread that walks one sample's horizon is a long dependent chain, and
//   one scenario's 4096 samples are too few threads to hide it.  Across
//   the lanes, the recurrences cost scan work and a partial last chunk
//   idles lanes: overhead that shows once a batch of scenarios fills the
//   card (a thread per sample is 1.9x faster at 256 scenarios, but sums
//   in another order, and a batched solve must equal unbatched solves).
//   wb_update reading the noise is bound by bytes: it must read the 9.0 MB
//   once (2.7 us at 3.35 TB/s; 0.69 ms for 256 scenarios), against 4
//   operations per element (two multiply-adds) and ~20 per sample for the
//   softmin weight.  The REGEN variants read no noise and are bound by the
//   ~135 operations per element of the second draw (Philox ~100, the
//   normal ~35).  Batching B scenarios multiplies both bounds by B.
//
// What the design does about it.
//   wb_cost puts the horizon across the lanes, as the TPU kernel is
//   parallel in time: one warp per sample walks the horizon in chunks of 32
//   steps, one step per lane.  A lane draws its step's 11 normals and runs
//   the step's nonlinear work (attitude quaternion, 7-joint FK, atan2,
//   costs).  Every linear recurrence is a warp scan (warp_scan.cuh): prefix
//   sums for the double integrations and the position, and for the
//   constant-coefficient maps (rotor lag, the 2x2 axis responses, drag,
//   rate damping) the step map's powers c^(2^i), A^(2^i), computed on the
//   host (the O(log H) form of the TPU kernel's (H, H) operators,
//   _host_matrices).  The wrench attitude is a Hillis-Steele quaternion
//   prefix product, earlier factors on the left (_quat_prefix_scan).  Each
//   recurrence's value at a chunk's last lane enters the next chunk through
//   lane 0's input: any H runs, and registers do not grow with H.  S_k is a
//   fixed-order warp sum.  A block is WB_BLOCK warps, one softmin partial
//   group.  The noise keeps its (A, H, K) layout, sample fastest (wb_update
//   reads it as 16-byte vectors): the block stages a chunk's 11 x 32 x
//   WB_BLOCK values in shared memory (rows padded to WB_BLOCK + 1 floats:
//   no bank conflicts) and moves them as runs of WB_BLOCK consecutive
//   samples (64 B), the spill and the explicit-noise read alike.  One body
//   serves every batch size, so a scenario's costs do not depend on the
//   batch it is solved in.  Per-config constants arrive by value in a POD
//   struct (kernel parameter space, < 4 KB): one build serves every
//   configuration; the mode is a template parameter.
//   wb_update: one block per R consecutive (a, t) rows of the noise (R =
//   1, 2, 4 or 8, the launcher's choice, measured: 8 reading the noise; 4
//   drawing it for a batch, 2 for one scenario, whose 550 rows must still
//   give two blocks per SM).
//   Each warp combines the softmin normalizers (rho, eta) from wb_cost's
//   per-group partials with shuffle trees, so no K-wide op runs between
//   the two kernels and no thread waits on a serial prologue.  A thread
//   takes the same samples in each of its block's R rows, so it forms each
//   of its samples' weights exp((rho - S_k)/lambda)/eta once, in
//   registers, for R rows: one exp and one divide per R elements, any K,
//   no shared memory, no barrier before the reduction.  The read variants
//   start up to 16 loads of 16 bytes per thread before the prologue and
//   stream the noise past L2; the draw variants spend per element only the
//   draw and two multiply-adds.  Each row reduces over K in a fixed order
//   (warp shuffles, then per-warp partials in a fixed order):
//   deterministic, no float atomics, no cross-block step, and the same
//   sums for any R.
//
// Randomness: Philox4x32-10 (Random123), key = the scenario's 64-bit seed,
// counter = (solve index, global sample index, a*H + t, 0), output word 0;
// normal z = sqrt(2) erfinv(((bits >> 8) - (2^23 - 0.5)) 2^-23), exact in
// float32 and finite.  The global sample index is k_off + k, so a shard of
// the sample axis draws exactly its slice of the one-rank noise set.  Pass 2
// draws again through the same draw_eps as pass 1, so regenerated noise is
// bit-identical to the spilled noise.  ops/sampling.py holds the same
// stream in plain PyTorch; philox.cuh holds the draw, shared with
// drone_kernel.cu.  The solve index is read from device memory (one int64
// per scenario, or one shared by the batch), like the keys: a captured CUDA
// graph replays with the counter its own last node advanced, so each replay
// draws the next solve's noise.
//
// Sphere obstacles are read from a device buffer of n_obs (x, y, z, radius)
// rows, any number of them (the TPU kernel bakes its list into the trace).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"
#include "warp_scan.cuh"

#define WB_A 11              // 4 base + 7 arm actions
#define WB_J 7               // arm joints
#define WB_BLOCK 16          // samples per softmin partial = warps per wb_cost block
#define WB_SCAN 5            // scan powers per step map in the parameter struct
#define WB_UPDATE_THREADS 256
#define WB_PROLOGUE_THREADS 128  // threads per wb_prologue block, one scenario each

static_assert(WB_SCAN == WARP_SCAN, "one power per warp-scan step");

// Scalar-pack layout — must match ops/cuda/whole_body_kernel.py (SC_*).
#define SC_Q0 0
#define SC_QD0 7
#define SC_POS0 14
#define SC_VEL0 17
#define SC_TPOS 20
#define SC_TQUAT 23
#define SC_BTGT 27
#define SC_SIGMA 30
#define SC_RPY0 41
#define SC_OM0 44
#define SC_BQ0 47
#define SC_GB 51
#define SC_LEN 54

enum { MODE_ATTITUDE = 0, MODE_POSITION = 1, MODE_WRENCH = 2 };

// Per-configuration constants.  Field order and types must match the
// ctypes Structure WbParams in ops/cuda/whole_body_kernel.py; every field
// is 4 bytes, so both sides lay it out without padding.
struct WbParams {
  int mode, h, k, rotor_lag, couple, jl_soft, n_obs, pad_;
  float dt, inv_lam, mass, lag_alpha, drag_alpha, rate_alpha;
  float inertia[3];
  float ax_a[3][4];   // per axis: x' = A x + B u, A row-major 2x2
  float ax_b[3][2];
  float ax_kp[3], ax_kd[3];
  float q_lo[WB_J], q_hi[WB_J];
  float oq[WB_J][4];  // joint-origin quaternions (wxyz)
  float ot[WB_J][3];  // joint-origin translations
  float com[WB_J][3];
  float link_mass[WB_J];
  float w_pos_stage, w_pos_term, w_ori_stage, w_ori_term;
  float w_base, w_att, w_omega, w_vel, w_action, w_jl, gamma;
  float w_obs, w_stop, stop_horizon;
  // wb_cost's scans: the step maps raised to 2^i, i < WB_SCAN.
  float ax_pow[3][WB_SCAN][4];  // per axis, A^(2^i) row-major
  float lag_pow[WB_SCAN], drag_pow[WB_SCAN], rate_pow[WB_SCAN];
};

struct Quat {
  float w, x, y, z;
};

__device__ __forceinline__ Quat qmul(const Quat& a, const Quat& b) {
  return Quat{a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
              a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
              a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
              a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

// v + 2*(w*(u x v) + u x (u x v))
__device__ __forceinline__ void qrot(const Quat& q, const float* v, float* out) {
  const float cx = q.y * v[2] - q.z * v[1];
  const float cy = q.z * v[0] - q.x * v[2];
  const float cz = q.x * v[1] - q.y * v[0];
  const float dx = q.y * cz - q.z * cy;
  const float dy = q.z * cx - q.x * cz;
  const float dz = q.x * cy - q.y * cx;
  out[0] = v[0] + 2.0f * (q.w * cx + dx);
  out[1] = v[1] + 2.0f * (q.w * cy + dy);
  out[2] = v[2] + 2.0f * (q.w * cz + dz);
}

// origin quaternion times the rotation about local +z by angle qj
__device__ __forceinline__ Quat joint_quat(const float* oq, float qj) {
  float s, c;
  sincosf(0.5f * qj, &s, &c);
  return Quat{oq[0] * c - oq[3] * s, oq[1] * c + oq[2] * s,
              oq[2] * c - oq[1] * s, oq[3] * c + oq[0] * s};
}

// qz(yaw) qy(pitch) qx(roll)
__device__ __forceinline__ Quat quat_from_rpy(float r, float p, float y) {
  float sr, cr, sp, cp, sy, cy;
  sincosf(0.5f * r, &sr, &cr);
  sincosf(0.5f * p, &sp, &cp);
  sincosf(0.5f * y, &sy, &cy);
  return Quat{cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
              cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr};
}

// Rotation vector -> quaternion, series branch below 1e-6 rad.
__device__ __forceinline__ Quat quat_from_rotvec(float rx, float ry, float rz) {
  const float th = sqrtf(rx * rx + ry * ry + rz * rz);
  const float half = 0.5f * th;
  const float k = th > 1e-6f ? sinf(half) / th : 0.5f - th * th / 48.0f;
  return Quat{cosf(half), rx * k, ry * k, rz * k};
}

// Wrench mode: the arm's gravity moment about the base origin (base frame)
// at the initial attitude's gravity g_b, sum_j m_j (com_j(q) x g_b), added
// to tau.
__device__ __forceinline__ void add_arm_moment(const WbParams& p, const float* sc,
                                               const float* qfk, float* tau) {
  const float gx = sc[SC_GB], gy = sc[SC_GB + 1], gz = sc[SC_GB + 2];
  Quat tq{1.f, 0.f, 0.f, 0.f};
  float tp[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < WB_J; ++j) {
    float r[3];
    qrot(tq, p.ot[j], r);
    tp[0] += r[0];
    tp[1] += r[1];
    tp[2] += r[2];
    tq = qmul(tq, joint_quat(p.oq[j], qfk[j]));
    float c[3];
    qrot(tq, p.com[j], c);
    const float px = tp[0] + c[0], py = tp[1] + c[1], pz = tp[2] + c[2];
    const float m = p.link_mass[j];
    tau[0] += m * (py * gz - pz * gy);
    tau[1] += m * (pz * gx - px * gz);
    tau[2] += m * (px * gy - py * gx);
  }
}

// One step's 7-joint FK from the base pose (bq, pos) and its cost: the
// stage terms, or the terminal ones at the last step.  v: the step's
// actions; q: the raw joint angles (limit costs); qfk: the clamped ones;
// gam: gamma^t; inv_h: 1 / H, formed once by the caller; obs: p.n_obs
// sphere rows (x, y, z, radius) in device memory.
__device__ __forceinline__ float step_cost(const WbParams& p, const float* sc, const float* v,
                                           const float* q, const float* qfk, const Quat& bq,
                                           const float* pos, const float* vel, const float* om,
                                           float gam, bool last, float inv_h,
                                           const float* __restrict__ obs) {
  Quat tq = bq;
  float tp[3] = {pos[0], pos[1], pos[2]};
#pragma unroll
  for (int j = 0; j < WB_J; ++j) {
    float r[3];
    qrot(tq, p.ot[j], r);
    tp[0] += r[0];
    tp[1] += r[1];
    tp[2] += r[2];
    tq = qmul(tq, joint_quat(p.oq[j], qfk[j]));
  }

  const float ex = tp[0] - sc[SC_TPOS], ey = tp[1] - sc[SC_TPOS + 1],
              ez = tp[2] - sc[SC_TPOS + 2];
  const float dp = sqrtf(ex * ex + ey * ey + ez * ez);
  // err = conj(tq) * target; geodesic angle 2 atan2(|vec|, |w|)
  const float gw = sc[SC_TQUAT], gx = sc[SC_TQUAT + 1], gy = sc[SC_TQUAT + 2],
              gz = sc[SC_TQUAT + 3];
  const float ew = tq.w * gw + tq.x * gx + tq.y * gy + tq.z * gz;
  const float evx = tq.w * gx - tq.x * gw - tq.y * gz + tq.z * gy;
  const float evy = tq.w * gy + tq.x * gz - tq.y * gw - tq.z * gx;
  const float evz = tq.w * gz - tq.x * gy + tq.y * gx - tq.z * gw;
  const float dori = 2.0f * atan2f(sqrtf(evx * evx + evy * evy + evz * evz), fabsf(ew));
  float c = (last ? p.w_pos_term : p.w_pos_stage) * dp +
            (last ? p.w_ori_term : p.w_ori_stage) * dori;

  if (p.w_base != 0.0f && !last) {
    const float bx = pos[0] - sc[SC_BTGT], by = pos[1] - sc[SC_BTGT + 1],
                bz = pos[2] - sc[SC_BTGT + 2];
    c += p.w_base * inv_h * (bx * bx + by * by + bz * bz);
  }
  if (p.w_att != 0.0f) {
    const float r02 = 2.0f * (bq.x * bq.z + bq.w * bq.y);
    const float r12 = 2.0f * (bq.y * bq.z - bq.w * bq.x);
    c += p.w_att * inv_h * (r02 * r02 + r12 * r12);
  }
  if (p.w_omega != 0.0f)
    c += p.w_omega * inv_h * (om[0] * om[0] + om[1] * om[1] + om[2] * om[2]);
  if (p.w_vel != 0.0f)
    c += p.w_vel * inv_h * (vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2]);
  if (p.w_action != 0.0f) {
    float act = 0.0f;
#pragma unroll
    for (int a = 0; a < WB_A; ++a) act += v[a] * v[a];
    c += p.w_action * gam * act;
  }
  if (p.w_jl != 0.0f) {
    if (p.jl_soft) {
      float vsq = 0.0f;
#pragma unroll
      for (int j = 0; j < WB_J; ++j) {
        const float vj = fmaxf(p.q_lo[j] - q[j], 0.0f) + fmaxf(q[j] - p.q_hi[j], 0.0f);
        vsq += vj * vj;
      }
      c += p.w_jl * 1e3f * gam * vsq;
    } else {
      bool out = false;
#pragma unroll
      for (int j = 0; j < WB_J; ++j) out = out || (q[j] < p.q_lo[j]) || (q[j] > p.q_hi[j]);
      if (out) c += p.w_jl * 1e10f * gam;
    }
  }
  for (int o = 0; o < p.n_obs; ++o) {
    const float dx = tp[0] - __ldg(obs + 4 * o), dy = tp[1] - __ldg(obs + 4 * o + 1),
                dz = tp[2] - __ldg(obs + 4 * o + 2);
    const float pen = fmaxf(__ldg(obs + 4 * o + 3) - sqrtf(dx * dx + dy * dy + dz * dz), 0.0f);
    c += p.w_obs * pen * pen;
  }
  return c;
}

// The terminal stopping-distance term on the final base position and
// velocity.
__device__ __forceinline__ float stop_cost(const WbParams& p, const float* sc, const float* pos,
                                           const float* vel) {
  if (p.w_stop == 0.0f) return 0.0f;
  const float sx = pos[0] + p.stop_horizon * vel[0] - sc[SC_BTGT];
  const float sy = pos[1] + p.stop_horizon * vel[1] - sc[SC_BTGT + 1];
  const float sz = pos[2] + p.stop_horizon * vel[2] - sc[SC_BTGT + 2];
  return p.w_stop * (sx * sx + sy * sy + sz * sz);
}

// Softmin partials of one group of WB_BLOCK consecutive samples' costs sg:
// m = min S, e = sum exp((m - S) / lambda), in sample order.
__device__ __forceinline__ void group_partials(const float* sg, float inv_lam, float* m_out,
                                               float* e_out) {
  float m = sg[0];
  for (int i = 1; i < WB_BLOCK; ++i) m = fminf(m, sg[i]);
  float e = 0.0f;
  for (int i = 0; i < WB_BLOCK; ++i) e += expf((m - sg[i]) * inv_lam);
  *m_out = m;
  *e_out = e;
}

// ---------------------------------------------------------------------------
// wb_cost: one warp per sample, the horizon across its lanes
// ---------------------------------------------------------------------------

// x_t = A x_{t-1} + y_t for a 2-state linear system, ap[i] = A^(2^i): the
// 2x2 form of scan_affine.
__device__ __forceinline__ void scan_affine2(float& y0, float& y1, const float (*ap)[4],
                                             int lane) {
#pragma unroll
  for (int i = 0; i < WARP_SCAN; ++i) {
    const float o0 = __shfl_up_sync(FULL_MASK, y0, 1 << i);
    const float o1 = __shfl_up_sync(FULL_MASK, y1, 1 << i);
    if (lane >= (1 << i)) {
      y0 += ap[i][0] * o0 + ap[i][1] * o1;
      y1 += ap[i][2] * o0 + ap[i][3] * o1;
    }
  }
}

// The prefix product q_0 q_1 ... q_t over the lanes, earlier factors on
// the left (Hillis-Steele, the TPU kernel's _quat_prefix_scan).
__device__ __forceinline__ Quat scan_qmul(Quat q, int lane) {
#pragma unroll
  for (int i = 0; i < WARP_SCAN; ++i) {
    const Quat o{__shfl_up_sync(FULL_MASK, q.w, 1 << i), __shfl_up_sync(FULL_MASK, q.x, 1 << i),
                 __shfl_up_sync(FULL_MASK, q.y, 1 << i), __shfl_up_sync(FULL_MASK, q.z, 1 << i)};
    if (lane >= (1 << i)) q = qmul(o, q);
  }
  return q;
}

// One 2-state axis response over a chunk: y = B u per lane, the carry-in
// A x entering at lane 0; x = (xa, xb) becomes the chunk's last state.
__device__ __forceinline__ void axis_scan(const WbParams& p, int i, float u, int lane,
                                          float& xa, float& xb, float& ya, float& yb) {
  ya = p.ax_b[i][0] * u;
  yb = p.ax_b[i][1] * u;
  if (lane == 0) {
    ya += p.ax_a[i][0] * xa + p.ax_a[i][1] * xb;
    yb += p.ax_a[i][2] * xa + p.ax_a[i][3] * xb;
  }
  scan_affine2(ya, yb, p.ax_pow[i], lane);
  xa = from_last(ya);
  xb = from_last(yb);
}

// Rotor lag x_t = alpha x_{t-1} + (1 - alpha) u_t over a chunk, the lag
// starting at the first command (carry = u_0 before the first chunk).
__device__ __forceinline__ float lag_scan(const WbParams& p, float u, int lane, int t0,
                                          float& carry) {
  if (t0 == 0) carry = __shfl_sync(FULL_MASK, u, 0);
  float y = (1.0f - p.lag_alpha) * u;
  if (lane == 0) y += p.lag_alpha * carry;
  y = scan_affine(y, p.lag_pow, lane);
  carry = from_last(y);
  return y;
}

// Pass 1 with one warp per sample: block = WB_BLOCK warps = WB_BLOCK
// consecutive samples = one softmin partial group.  Warp w of block g
// takes sample k = g * WB_BLOCK + w (global index k_off + k) and walks its
// horizon in chunks of WARP_LANES steps, lane = step within the chunk.
// Two blocks per SM (64 registers, a few spills) hide the shuffles' and
// draws' latency better than one block at ~105-120 registers (faster on
// the H100 at one scenario in every variant).
template <int MODE, bool DRAW, bool STORE>
__global__ void __launch_bounds__(WB_BLOCK * WARP_LANES, 2)
wb_cost_kernel(const WbParams p, const float* __restrict__ sc,
               const float* __restrict__ u_prev, float* __restrict__ eps,
               float* __restrict__ s, float* __restrict__ m_part,
               float* __restrict__ e_part, const unsigned long long* __restrict__ seeds,
               const long long* __restrict__ steps, int step_stride, int k_off,
               const float* __restrict__ obs) {
  constexpr int LD = WB_BLOCK + 1;  // stage row pitch (a column read is conflict-free)
  const int b = blockIdx.y, n_groups = gridDim.x;
  const int H = p.h, K = p.k;
  sc += (size_t)b * SC_LEN;
  u_prev += (size_t)b * H * WB_A;
  if (eps) eps += (size_t)b * WB_A * H * K;
  s += (size_t)b * K;
  m_part += (size_t)b * n_groups;
  e_part += (size_t)b * n_groups;

  // [SC_LEN scalars | H * A warm start | the chunk's noise, A * 32 rows of
  // LD (spill or explicit noise only)]
  extern __shared__ float smem[];
  float* sc_sm = smem;
  float* u_sm = smem + SC_LEN;
  float* stage = u_sm + H * WB_A;
  __shared__ float s_grp[WB_BLOCK];
  for (int i = threadIdx.x; i < SC_LEN; i += blockDim.x) sc_sm[i] = sc[i];
  for (int i = threadIdx.x; i < H * WB_A; i += blockDim.x) u_sm[i] = u_prev[i];
  __syncthreads();

  const int lane = threadIdx.x & (WARP_LANES - 1), w = threadIdx.x / WARP_LANES;
  const int k0 = blockIdx.x * WB_BLOCK, k = k0 + w;
  uint32_t key0 = 0u, key1 = 0u, step = 0u;
  if (DRAW) {
    philox_key(seeds, b, key0, key1);
    step = (uint32_t)steps[(size_t)step_stride * b];
  }
  const float dt = p.dt, inv_h = 1.0f / (float)H;

  // Each recurrence's state at the end of the previous chunk (the same in
  // every lane; lane 0 takes it in).
  float qc[WB_J], qdc[WB_J];
#pragma unroll
  for (int j = 0; j < WB_J; ++j) {
    qc[j] = sc_sm[SC_Q0 + j];
    qdc[j] = sc_sm[SC_QD0 + j];
  }
  float xa[3], xb[3];  // axis responses: (rpy, omega) / (p, v); wrench: xb = rates
  float wv[3], pc[3];  // velocity / dt (the drag-decayed acceleration sum), position
  float prev_rpy[3];   // position mode: the previous step's rpy
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pc[i] = sc_sm[SC_POS0 + i];
    wv[i] = sc_sm[SC_VEL0 + i] / dt;
    prev_rpy[i] = 0.0f;
    xa[i] = MODE == MODE_ATTITUDE ? sc_sm[SC_RPY0 + i] : sc_sm[SC_POS0 + i];
    xb[i] = MODE == MODE_POSITION ? sc_sm[SC_VEL0 + i] : sc_sm[SC_OM0 + i];
  }
  Quat bqc{sc_sm[SC_BQ0], sc_sm[SC_BQ0 + 1], sc_sm[SC_BQ0 + 2], sc_sm[SC_BQ0 + 3]};
  float lagc[4] = {0.f, 0.f, 0.f, 0.f};
  float gl = 1.0f;  // gamma^lane, by repeated product
  for (int i = 0; i < lane; ++i) gl *= p.gamma;
  const float g32 = from_last(gl) * p.gamma;
  float gamc = 1.0f;  // gamma^t0
  float total = 0.0f;

  for (int t0 = 0; t0 < H; t0 += WARP_LANES) {
    const int t = t0 + lane, nt = min(WARP_LANES, H - t0);
    const bool active = t < H;
    // The idle lanes of a partial chunk run step H - 1 again: no branch
    // splits the lanes' draws or scans (the 11 draws interleave), and what
    // they compute reaches no busy lane.
    const int tt = active ? t : H - 1;

    if (!DRAW) {  // the block's explicit noise for this chunk, as runs of WB_BLOCK samples
      for (int i = threadIdx.x; i < WB_A * nt * WB_BLOCK; i += blockDim.x) {
        const int g = i % WB_BLOCK, r = i / WB_BLOCK, a = r / nt, tl = r - a * nt;
        stage[(a * WARP_LANES + tl) * LD + g] = eps[(size_t)(a * H + t0 + tl) * K + k0 + g];
      }
      __syncthreads();
    }
    float v[WB_A];
#pragma unroll
    for (int a = 0; a < WB_A; ++a) {
      float e;
      if (DRAW) {
        e = draw_eps(step, (uint32_t)(k_off + k), (uint32_t)(a * H + tt), sc_sm[SC_SIGMA + a],
                     key0, key1);
        if (STORE && active) stage[(a * WARP_LANES + lane) * LD + w] = e;
      } else {
        e = active ? stage[(a * WARP_LANES + lane) * LD + w] : 0.0f;
      }
      v[a] = u_sm[tt * WB_A + a] + e;
    }
    if (STORE || !DRAW) __syncthreads();  // stage full (spill) or read (explicit noise)
    if (STORE) {  // the chunk's spill, as runs of WB_BLOCK samples
      for (int i = threadIdx.x; i < WB_A * nt * WB_BLOCK; i += blockDim.x) {
        const int g = i % WB_BLOCK, r = i / WB_BLOCK, a = r / nt, tl = r - a * nt;
        eps[(size_t)(a * H + t0 + tl) * K + k0 + g] = stage[(a * WARP_LANES + tl) * LD + g];
      }
      __syncthreads();  // the next chunk rewrites stage
    }

    // Arm: double integration of qddot (two prefix sums), clamped copy.
    float q[WB_J], qfk[WB_J];
#pragma unroll
    for (int j = 0; j < WB_J; ++j) {
      const float acc = v[4 + j];
      const float qd = scan_add(lane == 0 ? qdc[j] + acc * dt : acc * dt, lane);
      float qd_prev = __shfl_up_sync(FULL_MASK, qd, 1);
      if (lane == 0) qd_prev = qdc[j];
      const float inc = qd_prev * dt + 0.5f * acc * dt * dt;
      q[j] = scan_add(lane == 0 ? qc[j] + inc : inc, lane);
      qfk[j] = fminf(fmaxf(q[j], p.q_lo[j]), p.q_hi[j]);
      qdc[j] = from_last(qd);
      qc[j] = from_last(q[j]);
    }

    float om[3], pos[3], vel[3], thrust = 0.0f;
    Quat bq;
    if (MODE == MODE_POSITION) {
      float acc[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float sp = sc_sm[SC_POS0 + i] + v[i];  // absolute setpoint
        axis_scan(p, i, sp, lane, xa[i], xb[i], pos[i], vel[i]);
        acc[i] = p.ax_kp[i] * (sp - pos[i]) - p.ax_kd[i] * vel[i];
      }
      const float inv_g = 0.1019367991845056f;  // 1 / 9.81
      const float rpy[3] = {-acc[1] * inv_g, acc[0] * inv_g, v[3]};
      bq = quat_from_rpy(rpy[0], rpy[1], rpy[2]);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float pr = __shfl_up_sync(FULL_MASK, rpy[i], 1);
        if (lane == 0) pr = prev_rpy[i];
        om[i] = t == 0 ? 0.0f : (rpy[i] - pr) / dt;
        prev_rpy[i] = from_last(rpy[i]);
      }
    } else {
      if (MODE == MODE_ATTITUDE) {
        thrust = p.rotor_lag ? lag_scan(p, v[0], lane, t0, lagc[0]) : v[0];
        float rpy[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) axis_scan(p, i, v[1 + i], lane, xa[i], xb[i], rpy[i], om[i]);
        bq = quat_from_rpy(rpy[0], rpy[1], rpy[2]);
      } else {  // MODE_WRENCH
        float w4[4] = {v[0], v[1], v[2], v[3]};
        if (p.rotor_lag) {
#pragma unroll
          for (int i = 0; i < 4; ++i) w4[i] = lag_scan(p, v[i], lane, t0, lagc[i]);
        }
        thrust = w4[0];
        float tau[3] = {w4[1], w4[2], w4[3]};
        if (p.couple) add_arm_moment(p, sc_sm, qfk, tau);
#pragma unroll
        for (int i = 0; i < 3; ++i) {  // rate damping
          float y = dt * tau[i] / p.inertia[i];
          if (lane == 0) y += p.rate_alpha * xb[i];
          om[i] = scan_affine(y, p.rate_pow, lane);
          xb[i] = from_last(om[i]);
        }
        Quat r = quat_from_rotvec(om[0] * dt, om[1] * dt, om[2] * dt);
        if (lane == 0) r = qmul(bqc, r);
        bq = scan_qmul(r, lane);
        bqc = Quat{from_last(bq.w), from_last(bq.x), from_last(bq.y), from_last(bq.z)};
      }
      // Thrust along body z -> acceleration -> drag-decayed velocity
      // vel_t = dt w_t, w_t = drag w_{t-1} + acc_t (w = v0 / dt before the
      // first step) -> position, a prefix sum of dt vel.
      const float zx = 2.0f * (bq.x * bq.z + bq.w * bq.y);
      const float zy = 2.0f * (bq.y * bq.z - bq.w * bq.x);
      const float zz = 1.0f - 2.0f * (bq.x * bq.x + bq.y * bq.y);
      const float acc[3] = {zx * thrust / p.mass, zy * thrust / p.mass,
                            zz * thrust / p.mass - 9.81f};
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float wi = scan_affine(lane == 0 ? acc[i] + p.drag_alpha * wv[i] : acc[i],
                                     p.drag_pow, lane);
        vel[i] = dt * wi;
        pos[i] = scan_add(lane == 0 ? pc[i] + dt * vel[i] : dt * vel[i], lane);
        wv[i] = from_last(wi);
        pc[i] = from_last(pos[i]);
      }
    }

    const bool last = t == H - 1;
    float c = step_cost(p, sc_sm, v, q, qfk, bq, pos, vel, om, gamc * gl, last, inv_h, obs);
    if (last) c += stop_cost(p, sc_sm, pos, vel);
    if (active) total += c;
    gamc *= g32;
  }

  total = warp_sum(total);
  if (lane == 0) {
    s[k] = total;
    s_grp[w] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) group_partials(s_grp, p.inv_lam, m_part + blockIdx.x, e_part + blockIdx.x);
}

// The softmin normalizers of scenario b, computed by each warp on its own
// (every warp gets the same bits: the lanes' shares are combined by xor
// butterflies, whose two operands at each step are the same pair in either
// lane).  GIVEN: (rho, eta) = se[b] (global, from the host's collectives);
// else rho = min_i m_i and eta = sum_i e_i exp((rho - m_i) / lambda) over
// the scenario's n_part block partials.
template <bool GIVEN>
__device__ __forceinline__ void softmin_normalizers(const float* __restrict__ m_part,
                                                    const float* __restrict__ e_part,
                                                    const float* __restrict__ se, int b,
                                                    int n_part, float inv_lam, float& rho,
                                                    float& eta) {
  if (GIVEN) {
    rho = se[2 * b];
    eta = se[2 * b + 1];
    return;
  }
  const float* mp = m_part + (size_t)b * n_part;
  const float* ep = e_part + (size_t)b * n_part;
  const int lane = threadIdx.x & 31;
  float m = CUDART_INF_F;
  for (int i = lane; i < n_part; i += 32) m = fminf(m, mp[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float e = 0.0f;
  for (int i = lane; i < n_part; i += 32) e += ep[i] * expf((m - mp[i]) * inv_lam);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
  rho = m;
  eta = e;
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The next U groups of a thread's samples in the read variant: for j =
// j0, j0 + WB_UPDATE_THREADS, ... (U of them), the costs S[4j..4j+3] and
// the R rows' noise there, 16 bytes a load; zeros past n4.  The noise is
// read once: it streams past L2.
template <int U, int R>
__device__ __forceinline__ void load_group(float4 (&s4)[U], float4 (&e4)[U][R],
                                           const float4* __restrict__ sb4,
                                           const float4* const (&rowp)[R], int j0, int n4) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + u * WB_UPDATE_THREADS;
    s4[u] = j < n4 ? sb4[j] : zero;
#pragma unroll
    for (int r = 0; r < R; ++r) e4[u][r] = j < n4 ? __ldcs(rowp[r] + j) : zero;
  }
}

// Pass 2, one block per (R consecutive rows a*H + t, scenario b); the last
// block of a scenario repeats its last row in the places past the end and
// writes only its own rows.  Thread i takes the samples 4j..4j+3 of every
// row of its block for j = i, i + WB_UPDATE_THREADS, ..., in that order,
// in both variants, so the read and the regenerating variant add the same
// terms in the same order.  It forms the softmin weight of each of its
// samples once, in registers, and uses it for all R rows: no other thread
// needs it, so the weights need no shared memory and no barrier.  REGEN:
// draw the rows' noise again (no eps read).  Else read it as 16-byte
// vectors, the first U groups requested before the normalizers are formed,
// so the prologue runs under the loads' latency.
template <bool REGEN, bool GIVEN, int R>
__global__ void __launch_bounds__(WB_UPDATE_THREADS)
wb_update_kernel(const float* __restrict__ eps, const float* __restrict__ s,
                 const float* __restrict__ m_part, const float* __restrict__ e_part,
                 const float* __restrict__ se, const float* __restrict__ sc,
                 const unsigned long long* __restrict__ seeds,
                 const long long* __restrict__ steps, int step_stride, int k_off,
                 int n_part, int K, int H, int rows, float inv_lam,
                 float* __restrict__ du, float* __restrict__ m2) {
  constexpr int U = R >= 4 ? 16 / R : 4;  // read variant: groups per load step
  __shared__ float red[2][R][WB_UPDATE_THREADS / 32];
  const int b = blockIdx.y, row0 = blockIdx.x * R, n4 = K / 4;
  const float4* sb4 = reinterpret_cast<const float4*>(s + (size_t)b * K);

  int row[R];
  const float4* rowp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = min(row0 + r, rows - 1);
    rowp[r] = REGEN ? nullptr
                    : reinterpret_cast<const float4*>(eps + ((size_t)b * rows + row[r]) * K);
  }
  float4 s4[U], e4[U][R];
  if (!REGEN) load_group<U, R>(s4, e4, sb4, rowp, threadIdx.x, n4);

  float rho, eta;
  softmin_normalizers<GIVEN>(m_part, e_part, se, b, n_part, inv_lam, rho, eta);
  float acc[R], acc2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = acc2[r] = 0.0f;

  if (REGEN) {
    uint32_t key0, key1;
    philox_key(seeds, b, key0, key1);
    const uint32_t step = (uint32_t)steps[(size_t)step_stride * b];
    float sigma[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sigma[r] = sc[(size_t)b * SC_LEN + SC_SIGMA + row[r] / H];
    for (int j = threadIdx.x; j < n4; j += WB_UPDATE_THREADS) {
      const float4 sv = sb4[j];
      const uint32_t kg = (uint32_t)(k_off + 4 * j);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w = expf((rho - lane_of(sv, q)) * inv_lam) / eta;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float e = draw_eps(step, kg + q, (uint32_t)row[r], sigma[r], key0, key1);
          acc[r] += w * e;
          acc2[r] += w * e * e;
        }
      }
    }
  } else {
    for (int j0 = threadIdx.x; j0 < n4; j0 += U * WB_UPDATE_THREADS) {
      if (j0 != (int)threadIdx.x) load_group<U, R>(s4, e4, sb4, rowp, j0, n4);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u * WB_UPDATE_THREADS < n4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float w = expf((rho - lane_of(s4[u], q)) * inv_lam) / eta;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float e = lane_of(e4[u][r], q);
              acc[r] += w * e;
              acc2[r] += w * e * e;
            }
          }
        }
      }
    }
  }

  // Per row: a shuffle tree within each warp, then the warps' partials in
  // a fixed order (deterministic, no atomics).
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[r] += __shfl_down_sync(0xffffffffu, acc[r], off);
      acc2[r] += __shfl_down_sync(0xffffffffu, acc2[r], off);
    }
    if (lane == 0) {
      red[0][r][warp] = acc[r];
      red[1][r][warp] = acc2[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < R && row0 + threadIdx.x < rows) {
    const int r = threadIdx.x;
    float a = 0.0f, c = 0.0f;
    for (int i = 0; i < WB_UPDATE_THREADS / 32; ++i) {
      a += red[0][r][i];
      c += red[1][r][i];
    }
    du[(size_t)b * rows + row0 + r] = a;
    m2[(size_t)b * rows + row0 + r] = c;
  }
}

// ---------------------------------------------------------------------------
// wb_prologue: the scalar pack, the sigma schedule's FK included
// ---------------------------------------------------------------------------
//
// What bounds it: one scenario is one dependent chain (the base attitude,
// then seven joints of FK, each a sincos, a rotation and a quaternion
// product, then a norm), ~600 float operations and 20 sincos; it reads 47
// floats and writes 54.  Neither bytes nor operations bound it at any
// batch: the chain's latency does, a few microseconds.  What the design
// does about it: one thread per scenario, so B=1 and B=256 run one body
// and the kernel is one graph node where the PyTorch prologue was ~640.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn, no
// FMA contraction), in the order of the PyTorch code it replaces
// (models/whole_body._quat_from_rpy, models/chain.forward_kinematics_posquat,
// solver/whole_body.ee_error_sigma_schedule, pack_scalars), each op as that
// code's CUDA kernel rounds it: a scalar divisor is a multiply by its
// reciprocal, torch.linalg.cross contracts one product into an FMA, and
// torch.linalg.norm sums its squares in the reduction's tree order (each
// pattern read off PyTorch's own results on the H100).  So the
// pack equals the PyTorch prologue's on the card, and a solve does not
// change with the path that packed its scalars.

// The observation fields wb_prologue reads (WbPrologueArgs.field), in
// this order.
enum { PRO_Q, PRO_QD, PRO_POS, PRO_VEL, PRO_TPOS, PRO_TQUAT, PRO_BTGT, PRO_SIGMA, PRO_RPY,
       PRO_OM, PRO_N };

// Must match the ctypes Structure WbPrologueArgs: each field's rows and
// the floats between two scenarios' rows (0: one row for every scenario).
struct WbPrologueArgs {
  const float* field[PRO_N];
  long long stride[PRO_N];
};

// Must match the ctypes Structure WbSchedule (every field 4 bytes).
// kind 0: no schedule (sigma as given); 1: clip(|p_ee - p*| / r0, floor,
// 1), the base channels clipped at base_floor instead where base_floor_set.
struct WbSchedule {
  int kind, base_floor_set;
  float inv_r0, floor, base_floor;
  float oq[WB_J][4];  // the schedule chain's joint-origin quaternions (wxyz)
  float ot[WB_J][3];  // and translations
};

__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_(float a, float b) { return __fsub_rn(a, b); }

// One component of torch.linalg.cross: a*b - c*d with c*d rounded first
// and a*b fused into the subtraction.
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -mul_(c, d));
}

__device__ __forceinline__ void cross_rn(const float* u, const float* v, float* out) {
  out[0] = cross_term(u[1], v[2], u[2], v[1]);
  out[1] = cross_term(u[2], v[0], u[0], v[2]);
  out[2] = cross_term(u[0], v[1], u[1], v[0]);
}

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp_(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__global__ void __launch_bounds__(WB_PROLOGUE_THREADS)
wb_prologue_kernel(const WbSchedule s, const WbPrologueArgs a, float* __restrict__ sc,
                   int n_scen) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_scen) return;
  const float* f[PRO_N];
#pragma unroll
  for (int i = 0; i < PRO_N; ++i) f[i] = a.field[i] + a.stride[i] * b;
  float* out = sc + (size_t)b * SC_LEN;

  // The base attitude qz(yaw) qy(pitch) qx(roll).
  float cs[3], sn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float half = mul_(0.5f, f[PRO_RPY][i]);
    cs[i] = cosf(half);
    sn[i] = sinf(half);
  }
  const float cr = cs[0], sr = sn[0], cp = cs[1], sp = sn[1], cy = cs[2], sy = sn[2];
  const Quat bq{add_(mul_(mul_(cy, cp), cr), mul_(mul_(sy, sp), sr)),
                sub_(mul_(mul_(cy, cp), sr), mul_(mul_(sy, sp), cr)),
                add_(mul_(mul_(cy, sp), cr), mul_(mul_(sy, cp), sr)),
                sub_(mul_(mul_(sy, cp), cr), mul_(mul_(cy, sp), sr))};

  // Base-frame gravity: -9.81 times the last row of the normalized
  // attitude's rotation matrix.  The norm's tree: (w^2 + y^2) + (x^2 + z^2).
  const float n4 = sqrtf(add_(add_(mul_(bq.w, bq.w), mul_(bq.y, bq.y)),
                              add_(mul_(bq.x, bq.x), mul_(bq.z, bq.z))));
  const float nrm = clamp_(n4, 1e-12f, CUDART_INF_F);
  const float qw = __fdiv_rn(bq.w, nrm), qx = __fdiv_rn(bq.x, nrm), qy = __fdiv_rn(bq.y, nrm),
              qz = __fdiv_rn(bq.z, nrm);
  const float g_b[3] = {
      mul_(-9.81f, mul_(2.0f, sub_(mul_(qx, qz), mul_(qw, qy)))),
      mul_(-9.81f, mul_(2.0f, add_(mul_(qy, qz), mul_(qw, qx)))),
      mul_(-9.81f, sub_(1.0f, mul_(2.0f, add_(mul_(qx, qx), mul_(qy, qy)))))};

  float sigma[WB_A];
#pragma unroll
  for (int i = 0; i < WB_A; ++i) sigma[i] = f[PRO_SIGMA][i];
  if (s.kind == 1) {
    // The tip of the schedule's chain, composed from the base pose.
    Quat tq = bq;
    float tp[3] = {f[PRO_POS][0], f[PRO_POS][1], f[PRO_POS][2]};
#pragma unroll
    for (int j = 0; j < WB_J; ++j) {
      // t_pos += rotate(t_quat, ot_j) = ot_j + 2 (w (u x ot_j) + u x (u x ot_j))
      const float u[3] = {tq.x, tq.y, tq.z};
      float uv[3], uuv[3];
      cross_rn(u, s.ot[j], uv);
      cross_rn(u, uv, uuv);
#pragma unroll
      for (int i = 0; i < 3; ++i)
        tp[i] = add_(tp[i], add_(s.ot[j][i], mul_(2.0f, add_(mul_(tq.w, uv[i]), uuv[i]))));
      // t_quat = t_quat oq_j (cos(q/2), 0, 0, sin(q/2))
      const float half = mul_(0.5f, f[PRO_Q][j]);
      const float c = cosf(half), sh = sinf(half);
      const float* o = s.oq[j];
      const Quat jq{sub_(mul_(o[0], c), mul_(o[3], sh)), add_(mul_(o[1], c), mul_(o[2], sh)),
                    sub_(mul_(o[2], c), mul_(o[1], sh)), add_(mul_(o[0], sh), mul_(o[3], c))};
      tq = Quat{sub_(sub_(sub_(mul_(tq.w, jq.w), mul_(tq.x, jq.x)), mul_(tq.y, jq.y)),
                     mul_(tq.z, jq.z)),
                sub_(add_(add_(mul_(tq.w, jq.x), mul_(tq.x, jq.w)), mul_(tq.y, jq.z)),
                     mul_(tq.z, jq.y)),
                add_(add_(sub_(mul_(tq.w, jq.y), mul_(tq.x, jq.z)), mul_(tq.y, jq.w)),
                     mul_(tq.z, jq.x)),
                add_(sub_(add_(mul_(tq.w, jq.z), mul_(tq.x, jq.y)), mul_(tq.y, jq.x)),
                     mul_(tq.z, jq.w))};
    }
    float e[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) e[i] = sub_(tp[i], f[PRO_TPOS][i]);
    // torch.linalg.norm's tree over two threads: (e0^2 + e2^2) + e1^2.
    const float d = sqrtf(add_(add_(mul_(e[0], e[0]), mul_(e[2], e[2])), mul_(e[1], e[1])));
    const float x = mul_(d, s.inv_r0);
    const float s_arm = clamp_(x, s.floor, 1.0f);
    const float s_base = s.base_floor_set ? clamp_(x, s.base_floor, 1.0f) : s_arm;
#pragma unroll
    for (int i = 0; i < WB_A; ++i) sigma[i] = mul_(sigma[i], i < 4 ? s_base : s_arm);
  }

  // The pack, in SC_* order.
#pragma unroll
  for (int i = 0; i < WB_J; ++i) {
    out[SC_Q0 + i] = f[PRO_Q][i];
    out[SC_QD0 + i] = f[PRO_QD][i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[SC_POS0 + i] = f[PRO_POS][i];
    out[SC_VEL0 + i] = f[PRO_VEL][i];
    out[SC_TPOS + i] = f[PRO_TPOS][i];
    out[SC_BTGT + i] = f[PRO_BTGT][i];
    out[SC_RPY0 + i] = f[PRO_RPY][i];
    out[SC_OM0 + i] = f[PRO_OM][i];
    out[SC_GB + i] = g_b[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[SC_TQUAT + i] = f[PRO_TQUAT][i];
  out[SC_BQ0] = bq.w;
  out[SC_BQ0 + 1] = bq.x;
  out[SC_BQ0 + 2] = bq.y;
  out[SC_BQ0 + 3] = bq.z;
#pragma unroll
  for (int i = 0; i < WB_A; ++i) out[SC_SIGMA + i] = sigma[i];
}

// Dynamic shared memory above the default 48 KB must be opted into, per
// kernel: a long horizon's warm start (up to 227 KB a block on the H100,
// less the kernel's static share).  A failure shows in the launch's error.
template <typename Kernel>
static void allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int MODE, bool DRAW, bool STORE>
static void launch_cost(const WbParams& p, int n_scen, const float* sc, const float* u_prev,
                        float* eps, float* s, float* m_part, float* e_part,
                        const unsigned long long* seeds, const long long* steps,
                        int step_stride, int k_off, const float* obs, cudaStream_t stream) {
  const size_t warm = (size_t)(SC_LEN + p.h * WB_A) * sizeof(float);
  const size_t stage =
      STORE || !DRAW ? (size_t)WB_A * WARP_LANES * (WB_BLOCK + 1) * sizeof(float) : 0;
  const dim3 grid(p.k / WB_BLOCK, n_scen);
  allow_smem(wb_cost_kernel<MODE, DRAW, STORE>, warm + stage);
  wb_cost_kernel<MODE, DRAW, STORE><<<grid, WB_BLOCK * WARP_LANES, warm + stage, stream>>>(
      p, sc, u_prev, eps, s, m_part, e_part, seeds, steps, step_stride, k_off, obs);
}

extern "C" {

// Pass 1 over n_scen scenarios (K a multiple of WB_BLOCK).  variant 0: eps
// is read (explicit noise); 1: Philox noise, spilled to eps (out); 2:
// Philox noise, not stored (eps may be NULL).  seeds: the n_scen
// scenarios' keys; steps: their solve indices, scenario b's at
// steps[step_stride * b] (stride 0: one shared; both unused by variant 0).
// obs: p->n_obs sphere rows (x, y, z, radius), NULL when there are none.
// Returns cudaGetLastError() after the launch.
int wb_cost_launch(const WbParams* p, const float* sc, const float* u_prev, float* eps,
                   float* s, float* m_part, float* e_part,
                   const unsigned long long* seeds, const long long* steps, int step_stride,
                   int k_off, int variant, int n_scen, const float* obs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define WB_COST_CASE(M, V, D, S)                                                            \
  case (M) * 3 + (V):                                                                       \
    launch_cost<M, D, S>(*p, n_scen, sc, u_prev, eps, s, m_part, e_part, seeds, steps,     \
                         step_stride, k_off, obs, st);                                      \
    break;
  switch (p->mode * 3 + variant) {
    WB_COST_CASE(MODE_ATTITUDE, 0, false, false)
    WB_COST_CASE(MODE_ATTITUDE, 1, true, true)
    WB_COST_CASE(MODE_ATTITUDE, 2, true, false)
    WB_COST_CASE(MODE_POSITION, 0, false, false)
    WB_COST_CASE(MODE_POSITION, 1, true, true)
    WB_COST_CASE(MODE_POSITION, 2, true, false)
    WB_COST_CASE(MODE_WRENCH, 0, false, false)
    WB_COST_CASE(MODE_WRENCH, 1, true, true)
    WB_COST_CASE(MODE_WRENCH, 2, true, false)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WB_COST_CASE
  return (int)cudaGetLastError();
}


// Pass 2 over n_scen scenarios, rows = A*H, rows_per_block (R) of them per
// block: ceil(rows / R) blocks per scenario.  regen != 0: draw the noise
// again from (seeds, steps, k_off) and the sigma in sc (steps as in
// wb_cost_launch); else read eps (16-byte aligned).  se != NULL: the given (rho, eta) per scenario; else
// combine the n_part partials per scenario.  R is 1, 2, 4 or 8.
int wb_update_launch(const float* eps, const float* s, const float* m_part,
                     const float* e_part, const float* se, const float* sc,
                     const unsigned long long* seeds, const long long* steps, int step_stride,
                     int k_off, int n_part, int k, int h, int n_scen, float inv_lam, int regen,
                     int rows_per_block, float* du, float* m2, void* stream) {
  const int rows = WB_A * h;
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block, n_scen);
  cudaStream_t st = (cudaStream_t)stream;
#define WB_UPDATE_CASE(RG, GV, R)                                                             \
  case R:                                                                                     \
    wb_update_kernel<RG, GV, R><<<grid, WB_UPDATE_THREADS, 0, st>>>(                          \
        eps, s, m_part, e_part, se, sc, seeds, steps, step_stride, k_off, n_part, k, h, rows, \
        inv_lam, du, m2);                                                                     \
    break;
#define WB_UPDATE_VARIANT(RG, GV)                   \
  switch (rows_per_block) {                         \
    WB_UPDATE_CASE(RG, GV, 1)                       \
    WB_UPDATE_CASE(RG, GV, 2)                       \
    WB_UPDATE_CASE(RG, GV, 4)                       \
    WB_UPDATE_CASE(RG, GV, 8)                       \
    default: return (int)cudaErrorInvalidValue;     \
  }
  if (regen && se) {
    WB_UPDATE_VARIANT(true, true)
  } else if (regen) {
    WB_UPDATE_VARIANT(true, false)
  } else if (se) {
    WB_UPDATE_VARIANT(false, true)
  } else {
    WB_UPDATE_VARIANT(false, false)
  }
#undef WB_UPDATE_VARIANT
#undef WB_UPDATE_CASE
  return (int)cudaGetLastError();
}

// The scalar packs sc (n_scen x SC_LEN) of n_scen scenarios, one thread
// each.  Returns cudaGetLastError() after the launch.
int wb_prologue_launch(const WbSchedule* s, const WbPrologueArgs* a, float* sc, int n_scen,
                       void* stream) {
  const int blocks = (n_scen + WB_PROLOGUE_THREADS - 1) / WB_PROLOGUE_THREADS;
  wb_prologue_kernel<<<blocks, WB_PROLOGUE_THREADS, 0, (cudaStream_t)stream>>>(
      *s, *a, sc, n_scen);
  return (int)cudaGetLastError();
}

}  // extern "C"
