// Whole-body MPPI solve kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of
// quadrotor_manipulator_mppi_tpu/ops/pallas/whole_body_kernel.py:
//   wb_cost   <- _cost_kernel_store (in-kernel PRNG, noise spilled to HBM)
//                and _cost_kernel_noise (explicit noise): noise draw,
//                rollout, 7-joint FK, the whole cost stack, per-block
//                softmin partials (_softmin_partials).
//   wb_update <- _update_kernel_fused_noise / _fused_update_body: softmin
//                weights, the weighted noise sum du and the weighted second
//                moment for adaptive sigma.
//
// What bounds them on this card.
//   wb_cost is bound by dependent arithmetic, not by bytes: per sample it
//   runs H sequential steps, each ~11 Philox draws + erfinv, a 7-joint
//   quaternion FK (7 sincos), an atan2 and the cost terms — about 2-3
//   kFLOP per step, ~0.5 GFLOP per solve at K=4096, H=50 — while it moves
//   only the spilled noise (K*H*11*4 B = 9.0 MB) out.  Its limit is
//   parallelism: K=4096 samples give only 4096 threads, ~1/16 of what the
//   H100's 132 SMs can hold, so the kernel is latency bound.
//   wb_update reads the 9.0 MB of noise once (2.7 us at 3.35 TB/s) and is
//   bound by bytes.
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
//   wb_update: one block per (a, t) row of the noise, reducing over K in a
//   fixed order (warp shuffles, then per-warp partials in a fixed order):
//   deterministic, no float atomics, no cross-block step.  The softmin
//   normalizers (rho, eta) are combined from wb_cost's per-block partials
//   inside each block, so no K-wide op runs between the two kernels.
//
// Randomness: Philox4x32-10 (Random123), key = the solver state's 64-bit
// seed, counter = (solve index, sample, a*H + t, 0), output word 0; normal
// z = sqrt(2) erfinv(((bits >> 8) - (2^23 - 0.5)) 2^-23), exact in float32
// and finite.  ops/sampling.py holds the same stream in plain PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return c0;
}

__device__ __forceinline__ float bits_to_normal(uint32_t bits) {
  const float x = ((float)(bits >> 8) - 8388607.5f) * (1.0f / 8388608.0f);
  return erfinvf(x) * 1.41421356f;
}

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

// Per-sample rollout + cost: the whole of pass 1 for sample k.  With DRAW
// the sample's noise is drawn from Philox and spilled to eps; otherwise it
// is read from eps.  eps is (A, H, K).
template <int MODE, bool DRAW>
__device__ __forceinline__ float sample_cost(const WbParams& p, const float* sc,
                             const float* u_prev, float* eps, int k,
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
        e = bits_to_normal(philox_word0(step, (uint32_t)k, (uint32_t)(a * H + t),
                                        0u, key0, key1)) * sc[SC_SIGMA + a];
        eps[idx] = e;
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

template <int MODE, bool DRAW>
__global__ void __launch_bounds__(WB_BLOCK)
wb_cost_kernel(const WbParams p, const float* __restrict__ sc,
               const float* __restrict__ u_prev, float* __restrict__ eps,
               float* __restrict__ s, float* __restrict__ m_part,
               float* __restrict__ e_part, uint32_t key0, uint32_t key1,
               uint32_t step) {
  extern __shared__ float smem[];  // [SC_LEN scalars | H * A warm start]
  float* sc_sm = smem;
  float* u_sm = smem + SC_LEN;
  for (int i = threadIdx.x; i < SC_LEN; i += blockDim.x) sc_sm[i] = sc[i];
  for (int i = threadIdx.x; i < p.h * WB_A; i += blockDim.x) u_sm[i] = u_prev[i];
  __syncthreads();

  const int k = blockIdx.x * WB_BLOCK + threadIdx.x;
  const float cost = sample_cost<MODE, DRAW>(p, sc_sm, u_sm, eps, k, key0, key1, step);
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

__global__ void __launch_bounds__(WB_UPDATE_THREADS)
wb_update_kernel(const float* __restrict__ eps, const float* __restrict__ s,
                 const float* __restrict__ m_part, const float* __restrict__ e_part,
                 int n_part, int K, float inv_lam, float* __restrict__ du,
                 float* __restrict__ m2) {
  __shared__ float rho_eta[2];
  __shared__ float red[2][WB_UPDATE_THREADS / 32];
  if (threadIdx.x == 0) {
    // rho = min_i m_i; eta = sum_i e_i exp((rho - m_i) / lambda)
    float rho = m_part[0];
    for (int i = 1; i < n_part; ++i) rho = fminf(rho, m_part[i]);
    float eta = 0.0f;
    for (int i = 0; i < n_part; ++i) eta += e_part[i] * expf((rho - m_part[i]) * inv_lam);
    rho_eta[0] = rho;
    rho_eta[1] = eta;
  }
  __syncthreads();
  const float rho = rho_eta[0], eta = rho_eta[1];
  const float* row = eps + (size_t)blockIdx.x * K;
  float acc = 0.0f, acc2 = 0.0f;
  for (int k = threadIdx.x; k < K; k += WB_UPDATE_THREADS) {
    const float w = expf((rho - s[k]) * inv_lam) / eta;
    const float e = row[k];
    acc += w * e;
    acc2 += w * e * e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    acc2 += __shfl_down_sync(0xffffffffu, acc2, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = acc;
    red[1][warp] = acc2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f, b = 0.0f;
    for (int i = 0; i < WB_UPDATE_THREADS / 32; ++i) {
      a += red[0][i];
      b += red[1][i];
    }
    du[blockIdx.x] = a;
    m2[blockIdx.x] = b;
  }
}

template <int MODE, bool DRAW>
static void launch_cost(const WbParams& p, const float* sc, const float* u_prev,
                        float* eps, float* s, float* m_part, float* e_part,
                        uint32_t key0, uint32_t key1, uint32_t step,
                        cudaStream_t stream) {
  const size_t smem = (size_t)(SC_LEN + p.h * WB_A) * sizeof(float);
  wb_cost_kernel<MODE, DRAW><<<p.k / WB_BLOCK, WB_BLOCK, smem, stream>>>(
      p, sc, u_prev, eps, s, m_part, e_part, key0, key1, step);
}

extern "C" {

// Pass 1.  draw != 0: Philox noise, spilled to eps (out); else eps is read.
// Returns cudaGetLastError() after the launch.
int wb_cost_launch(const WbParams* p, const float* sc, const float* u_prev,
                   float* eps, float* s, float* m_part, float* e_part,
                   unsigned long long seed, unsigned int step, int draw,
                   void* stream) {
  const uint32_t key0 = (uint32_t)(seed & 0xffffffffull);
  const uint32_t key1 = (uint32_t)(seed >> 32);
  cudaStream_t st = (cudaStream_t)stream;
  switch (p->mode * 2 + (draw ? 1 : 0)) {
    case 0: launch_cost<MODE_ATTITUDE, false>(*p, sc, u_prev, eps, s, m_part, e_part, key0, key1, step, st); break;
    case 1: launch_cost<MODE_ATTITUDE, true>(*p, sc, u_prev, eps, s, m_part, e_part, key0, key1, step, st); break;
    case 2: launch_cost<MODE_POSITION, false>(*p, sc, u_prev, eps, s, m_part, e_part, key0, key1, step, st); break;
    case 3: launch_cost<MODE_POSITION, true>(*p, sc, u_prev, eps, s, m_part, e_part, key0, key1, step, st); break;
    case 4: launch_cost<MODE_WRENCH, false>(*p, sc, u_prev, eps, s, m_part, e_part, key0, key1, step, st); break;
    case 5: launch_cost<MODE_WRENCH, true>(*p, sc, u_prev, eps, s, m_part, e_part, key0, key1, step, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Pass 2: one block per (a, t) row of eps (rows = A * H).
int wb_update_launch(const float* eps, const float* s, const float* m_part,
                     const float* e_part, int n_part, int k, int rows,
                     float inv_lam, float* du, float* m2, void* stream) {
  wb_update_kernel<<<rows, WB_UPDATE_THREADS, 0, (cudaStream_t)stream>>>(
      eps, s, m_part, e_part, n_part, k, inv_lam, du, m2);
  return (int)cudaGetLastError();
}

}  // extern "C"
