// Whole-body MPPI solve kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of
// quadrotor_manipulator_mppi_tpu/ops/pallas/whole_body_kernel.py:
//   wb_cost<MODE, DRAW, STORE>, pass 1: noise draw, rollout, 7-joint FK,
//     the whole cost stack, per-block softmin partials (_softmin_partials).
//       DRAW, STORE   <- _cost_kernel_store (in-kernel PRNG, noise spilled)
//       DRAW, !STORE  <- _cost_kernel (in-kernel PRNG, no spill)
//       !DRAW         <- _cost_kernel_noise (explicit noise)
//   wb_update<REGEN, GIVEN>, pass 2: softmin weights, the weighted noise
//     sum du and the weighted second moment for adaptive sigma, per row.
//       !REGEN, !GIVEN <- _update_kernel_fused_noise / _fused_update_body
//       REGEN,  !GIVEN <- _update_kernel_fused (draws the noise again)
//       REGEN,  GIVEN  <- _update_kernel (sharded; draws the noise again)
//       !REGEN, GIVEN  <- _update_kernel_noise (sharded; reads the noise)
//     GIVEN: the global (rho, eta) arrive from the host's collectives (the
//     sample-sharded solve); otherwise they are combined from this solve's
//     per-block partials.  The per-tile du/m2 partials of the sharded TPU
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
//   wb_cost is bound by dependent arithmetic, not by bytes: per sample it
//   runs H sequential steps, each ~11 Philox draws + erfinv, a 7-joint
//   quaternion FK (7 sincos), an atan2 and the cost terms — about 2-3
//   kFLOP per step, ~0.5 GFLOP per solve at K=4096, H=50 — while it moves
//   only the spilled noise (K*H*11*4 B = 9.0 MB) out.  Its limit is
//   parallelism: K=4096 samples give only 4096 threads, ~1/16 of what the
//   H100's 132 SMs can hold, so the kernel is latency bound.
//   wb_update reading the noise is bound by bytes: it must read the 9.0 MB
//   once (2.7 us at 3.35 TB/s; 0.69 ms for 256 scenarios), against 4
//   operations per element (two multiply-adds) and ~20 per sample for the
//   softmin weight.  The REGEN variants read no noise and are bound by the
//   ~135 operations per element of the second draw (Philox ~100, the
//   normal ~35).  Batching B scenarios multiplies both bounds by B and
//   gives wb_cost B * 4096 threads, enough to fill the card.
//
// What the design does about it.
//   wb_cost: one thread per sample; every horizon operator of the TPU
//   kernel (the (H, H) MXU matmuls: double integration, rotor lag, PD or
//   identified axis response, drag-decay and rate-damping recurrences, the
//   Hillis-Steele quaternion scan) becomes its linear recurrence, carried
//   in registers step by step — O(H) instead of O(H^2) work, no matrices.
//   Small blocks (WB_BLOCK = 64 threads) spread 4096 samples over 64 SMs.
//   Noise is stored (A, H, K), sample index fastest, so the spill and the
//   update's loads are coalesced.  Per-config constants arrive by value in
//   a POD struct (kernel parameter space, < 4 KB) — one build serves every
//   configuration; the mode is a template parameter.
//   wb_update: one block per R consecutive (a, t) rows of the noise (R =
//   1, 2, 4 or 8, the launcher's choice, measured: 8 reading the noise; 4
//   drawing it for a batch, 2 for one scenario, whose 550 rows must still
//   give two blocks per SM).
//   Each warp combines the softmin normalizers (rho, eta) from wb_cost's
//   per-block partials with shuffle trees, so no K-wide op runs between
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
// drone_kernel.cu.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"

#define WB_A 11          // 4 base + 7 arm actions
#define WB_J 7           // arm joints
#define WB_BLOCK 64      // samples per block of wb_cost
#define WB_MAX_OBS 16    // sphere obstacles carried in the parameter struct
#define WB_UPDATE_THREADS 256

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
  float obs[WB_MAX_OBS][4];  // (x, y, z, radius)
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

// Per-sample rollout + cost: the whole of pass 1 for sample k (global index
// k_off + k).  With DRAW the sample's noise is drawn from Philox, and with
// STORE also spilled to eps; without DRAW it is read from eps.  eps is
// (A, H, K).
template <int MODE, bool DRAW, bool STORE>
__device__ __forceinline__ float sample_cost(const WbParams& p, const float* sc,
                             const float* u_prev, float* eps, int k, int k_off,
                             uint32_t key0, uint32_t key1, uint32_t step) {
  const int H = p.h, K = p.k;
  const float dt = p.dt;
  const float inv_h = 1.0f / (float)H;

  float q[WB_J], qd[WB_J];
#pragma unroll
  for (int j = 0; j < WB_J; ++j) {
    q[j] = sc[SC_Q0 + j];
    qd[j] = sc[SC_QD0 + j];
  }
  float pos[3], vel[3], cv[3] = {0.f, 0.f, 0.f}, v0[3];
  float xa[3], xb[3];  // per-axis response state (phi, omega) / (p, v)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pos[i] = sc[SC_POS0 + i];
    vel[i] = v0[i] = sc[SC_VEL0 + i];
    if (MODE == MODE_ATTITUDE) {
      xa[i] = sc[SC_RPY0 + i];
      xb[i] = sc[SC_OM0 + i];
    } else if (MODE == MODE_POSITION) {
      xa[i] = pos[i];
      xb[i] = v0[i];
    } else {
      xb[i] = sc[SC_OM0 + i];  // body rates
    }
  }
  Quat bq{sc[SC_BQ0], sc[SC_BQ0 + 1], sc[SC_BQ0 + 2], sc[SC_BQ0 + 3]};
  float lag[4] = {0.f, 0.f, 0.f, 0.f};
  float prev_rpy[3] = {0.f, 0.f, 0.f};
  float vdecay = 1.0f;  // drag_alpha^(t+1)
  float gam = 1.0f;     // gamma^t
  float total = 0.0f;

  for (int t = 0; t < H; ++t) {
    float v[WB_A];
#pragma unroll
    for (int a = 0; a < WB_A; ++a) {
      const size_t idx = ((size_t)(a * H + t)) * K + k;
      float e;
      if (DRAW) {
        e = draw_eps(step, (uint32_t)(k_off + k), (uint32_t)(a * H + t), sc[SC_SIGMA + a],
                     key0, key1);
        if (STORE) eps[idx] = e;
      } else {
        e = eps[idx];
      }
      v[a] = u_prev[t * WB_A + a] + e;
    }

    // Arm: raw double integration (limit costs), clamped copy (FK).
    float qfk[WB_J];
#pragma unroll
    for (int j = 0; j < WB_J; ++j) {
      const float acc = v[4 + j];
      const float qd_prev = qd[j];
      qd[j] = qd[j] + acc * dt;
      q[j] = q[j] + qd_prev * dt + 0.5f * acc * dt * dt;
      qfk[j] = fminf(fmaxf(q[j], p.q_lo[j]), p.q_hi[j]);
    }

    float om[3], thrust = 0.0f;
    if (MODE == MODE_POSITION) {
      float acc[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float sp = sc[SC_POS0 + i] + v[i];  // absolute setpoint
        const float na = p.ax_a[i][0] * xa[i] + p.ax_a[i][1] * xb[i] + p.ax_b[i][0] * sp;
        const float nb = p.ax_a[i][2] * xa[i] + p.ax_a[i][3] * xb[i] + p.ax_b[i][1] * sp;
        xa[i] = na;
        xb[i] = nb;
        pos[i] = na;
        vel[i] = nb;
        acc[i] = p.ax_kp[i] * (sp - na) - p.ax_kd[i] * nb;
      }
      const float inv_g = 0.1019367991845056f;  // 1 / 9.81
      const float rpy[3] = {-acc[1] * inv_g, acc[0] * inv_g, v[3]};
      bq = quat_from_rpy(rpy[0], rpy[1], rpy[2]);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        om[i] = t == 0 ? 0.0f : (rpy[i] - prev_rpy[i]) / dt;
        prev_rpy[i] = rpy[i];
      }
    } else {
      if (MODE == MODE_ATTITUDE) {
        thrust = v[0];
        if (p.rotor_lag) {
          if (t == 0) lag[0] = v[0];
          lag[0] = p.lag_alpha * lag[0] + (1.0f - p.lag_alpha) * v[0];
          thrust = lag[0];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float u = v[1 + i];
          const float na = p.ax_a[i][0] * xa[i] + p.ax_a[i][1] * xb[i] + p.ax_b[i][0] * u;
          const float nb = p.ax_a[i][2] * xa[i] + p.ax_a[i][3] * xb[i] + p.ax_b[i][1] * u;
          xa[i] = na;
          xb[i] = nb;
          om[i] = nb;
        }
        bq = quat_from_rpy(xa[0], xa[1], xa[2]);
      } else {  // MODE_WRENCH
        float w4[4] = {v[0], v[1], v[2], v[3]};
        if (p.rotor_lag) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (t == 0) lag[i] = v[i];
            lag[i] = p.lag_alpha * lag[i] + (1.0f - p.lag_alpha) * v[i];
            w4[i] = lag[i];
          }
        }
        thrust = w4[0];
        float tau[3] = {w4[1], w4[2], w4[3]};
        if (p.couple) {
          // Arm gravity moment about the base origin (base frame) at the
          // initial attitude's gravity g_b: sum_j m_j (com_j(q) x g_b).
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
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          xb[i] = p.rate_alpha * xb[i] + dt * tau[i] / p.inertia[i];
          om[i] = xb[i];
        }
        bq = qmul(bq, quat_from_rotvec(om[0] * dt, om[1] * dt, om[2] * dt));
      }
      // Thrust along body z -> acceleration -> drag-decayed velocity -> pos.
      const float zx = 2.0f * (bq.x * bq.z + bq.w * bq.y);
      const float zy = 2.0f * (bq.y * bq.z - bq.w * bq.x);
      const float zz = 1.0f - 2.0f * (bq.x * bq.x + bq.y * bq.y);
      const float acc[3] = {zx * thrust / p.mass, zy * thrust / p.mass,
                            zz * thrust / p.mass - 9.81f};
      vdecay *= p.drag_alpha;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        cv[i] = p.drag_alpha * cv[i] + acc[i];
        vel[i] = vdecay * v0[i] + dt * cv[i];
        pos[i] += dt * vel[i];
      }
    }

    // 7-joint quaternion FK from the base pose.
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

    // ----- cost stack -----
    const bool last = (t == H - 1);
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
#pragma unroll
    for (int o = 0; o < WB_MAX_OBS; ++o) {
      if (o >= p.n_obs) break;
      const float dx = tp[0] - p.obs[o][0], dy = tp[1] - p.obs[o][1],
                  dz = tp[2] - p.obs[o][2];
      const float pen = fmaxf(p.obs[o][3] - sqrtf(dx * dx + dy * dy + dz * dz), 0.0f);
      c += p.w_obs * pen * pen;
    }
    total += c;
    gam *= p.gamma;
  }
  if (p.w_stop != 0.0f) {
    const float sx = pos[0] + p.stop_horizon * vel[0] - sc[SC_BTGT];
    const float sy = pos[1] + p.stop_horizon * vel[1] - sc[SC_BTGT + 1];
    const float sz = pos[2] + p.stop_horizon * vel[2] - sc[SC_BTGT + 2];
    total += p.w_stop * (sx * sx + sy * sy + sz * sz);
  }
  return total;
}

template <int MODE, bool DRAW, bool STORE>
__global__ void __launch_bounds__(WB_BLOCK)
wb_cost_kernel(const WbParams p, const float* __restrict__ sc,
               const float* __restrict__ u_prev, float* __restrict__ eps,
               float* __restrict__ s, float* __restrict__ m_part,
               float* __restrict__ e_part, const unsigned long long* __restrict__ seeds,
               uint32_t step, int k_off) {
  // Scenario b's slabs: sc (SC_LEN), u_prev (H, A), eps (A, H, K), s (K),
  // partials (n_blocks).
  const int b = blockIdx.y;
  const int n_blocks = gridDim.x;
  sc += (size_t)b * SC_LEN;
  u_prev += (size_t)b * p.h * WB_A;
  if (eps) eps += (size_t)b * WB_A * p.h * p.k;
  s += (size_t)b * p.k;
  m_part += (size_t)b * n_blocks;
  e_part += (size_t)b * n_blocks;

  extern __shared__ float smem[];  // [SC_LEN scalars | H * A warm start]
  float* sc_sm = smem;
  float* u_sm = smem + SC_LEN;
  for (int i = threadIdx.x; i < SC_LEN; i += blockDim.x) sc_sm[i] = sc[i];
  for (int i = threadIdx.x; i < p.h * WB_A; i += blockDim.x) u_sm[i] = u_prev[i];
  __syncthreads();

  uint32_t key0 = 0u, key1 = 0u;
  if (DRAW) philox_key(seeds, b, key0, key1);
  const int k = blockIdx.x * WB_BLOCK + threadIdx.x;
  const float cost =
      sample_cost<MODE, DRAW, STORE>(p, sc_sm, u_sm, eps, k, k_off, key0, key1, step);
  s[k] = cost;

  // Per-block softmin partials: m = min S, e = sum exp((m - S) / lambda),
  // reduced in a fixed order (deterministic).
  __shared__ float s_blk[WB_BLOCK];
  s_blk[threadIdx.x] = cost;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = s_blk[0];
    for (int i = 1; i < WB_BLOCK; ++i) m = fminf(m, s_blk[i]);
    float e = 0.0f;
    for (int i = 0; i < WB_BLOCK; ++i) e += expf((m - s_blk[i]) * p.inv_lam);
    m_part[blockIdx.x] = m;
    e_part[blockIdx.x] = e;
  }
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
                 const unsigned long long* __restrict__ seeds, uint32_t step, int k_off,
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

template <int MODE, bool DRAW, bool STORE>
static void launch_cost(const WbParams& p, int n_scen, const float* sc, const float* u_prev,
                        float* eps, float* s, float* m_part, float* e_part,
                        const unsigned long long* seeds, uint32_t step, int k_off,
                        cudaStream_t stream) {
  const size_t smem = (size_t)(SC_LEN + p.h * WB_A) * sizeof(float);
  const dim3 grid(p.k / WB_BLOCK, n_scen);
  wb_cost_kernel<MODE, DRAW, STORE><<<grid, WB_BLOCK, smem, stream>>>(
      p, sc, u_prev, eps, s, m_part, e_part, seeds, step, k_off);
}

extern "C" {

// Pass 1 over n_scen scenarios.  variant 0: eps is read (explicit noise);
// 1: Philox noise, spilled to eps (out); 2: Philox noise, not stored (eps
// may be NULL).  seeds: the n_scen scenarios' keys (unused by variant 0).
// Returns cudaGetLastError() after the launch.
int wb_cost_launch(const WbParams* p, const float* sc, const float* u_prev, float* eps,
                   float* s, float* m_part, float* e_part,
                   const unsigned long long* seeds, unsigned int step, int k_off,
                   int variant, int n_scen, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define WB_COST_CASE(M, V, D, S)                                                      \
  case (M) * 3 + (V):                                                                 \
    launch_cost<M, D, S>(*p, n_scen, sc, u_prev, eps, s, m_part, e_part, seeds, step, \
                         k_off, st);                                                  \
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
// again from (seeds, step, k_off) and the sigma in sc; else read eps (16-
// byte aligned).  se != NULL: the given (rho, eta) per scenario; else
// combine the n_part partials per scenario.  R is 1, 2, 4 or 8.
int wb_update_launch(const float* eps, const float* s, const float* m_part,
                     const float* e_part, const float* se, const float* sc,
                     const unsigned long long* seeds, unsigned int step, int k_off,
                     int n_part, int k, int h, int n_scen, float inv_lam, int regen,
                     int rows_per_block, float* du, float* m2, void* stream) {
  const int rows = WB_A * h;
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block, n_scen);
  cudaStream_t st = (cudaStream_t)stream;
#define WB_UPDATE_CASE(RG, GV, R)                                                             \
  case R:                                                                                     \
    wb_update_kernel<RG, GV, R><<<grid, WB_UPDATE_THREADS, 0, st>>>(                          \
        eps, s, m_part, e_part, se, sc, seeds, step, k_off, n_part, k, h, rows, inv_lam, du, \
        m2);                                                                                  \
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

}  // extern "C"
