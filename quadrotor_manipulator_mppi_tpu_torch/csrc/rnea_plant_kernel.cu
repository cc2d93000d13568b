// RNEA-plant kernel for NVIDIA Hopper (sm_90a): one control period of the
// exact whole-body plant at 1 kHz.
//
// It replaces no TPU kernel: the JAX package leaves this plant to XLA's
// substep scan (quadrotor_manipulator_mppi_tpu/sim/whole_body_loop.py,
// physics_tick under lax.scan), which fuses it; the port's eager PyTorch
// ran each substep as ~1,650 small kernels.  rnea_plant_kernel<MODE, MM_ONCE>
// runs `substeps` steps of sim/whole_body_loop.physics_tick's per-substep
// RNEA branch (arm_coeffs_per_control off) in one launch:
//   the arm's forward dynamics under the tilted gravity field -- M(q) by
//     the unit-acceleration RNEA columns, its Cholesky factor, nle(q, qd),
//     qdd = M^-1 (tau - nle) -- and the hard joint stops;
//   the arm's gravity moment on the base (arm_gravity_torque_fast);
//   the mode's base law: attitude PD on the ZYX angles minus the gravity
//     moment (MODE 0), adaptive backstepping with its controller state
//     (MODE 1), or the direct wrench with the gravity-moment feed-forward
//     and the body-rate damping (MODE 2);
//   the pseudo-inverse allocation, the asymmetric rotor lag, the rotor
//     wrench and drag, the external body wrench held over the period, the
//     integration with the inelastic ground clamp and the quaternion update
//     (models/multirotor.step).
// MM_ONCE (mass_matrix_per_control) factors M once, at substep 0, from the
// period's starting q, and reuses the factor in every substep.
//
// What bounds it on this card.  Per vehicle row it reads 63 floats (state
// 46, command 4, torque 7, external wrench 6) and writes 46, and a substep
// is ~7.6 k float32 operations (eight RNEA passes of ~850, the FK of the
// gravity moment, a 7x7 Cholesky factor and two triangular solves, the
// base step).  The reach loops run ONE row: the work is a few nanoseconds
// of the card's peak, and the kernel's time is its launch plus the chain of
// dependent instructions a warp issues over the substeps (one RNEA pass
// forward and back, then the factor, the solves and the base step).
//
// What the design does about it.  Eight lanes per vehicle row (RP_LANES),
// four rows per warp, RP_BLOCK threads a block; shuffles have width 8, as
// plant_tick's.  Every lane holds the whole row (base, q, qd, controller
// state, command, torque) and computes the joint rotations, the attitude,
// the gravity moment, the factor, the solves, the joint stops and the base
// step alike, so no value has to be broadcast and no branch diverges.  The
// RNEA passes run side by side, one per lane, as one body with lane inputs:
// lane c < 7 forms column c of M (qd = 0, qdd = e_c, gravity off), lane 7
// forms nle (qd, qdd = 0, the tilted gravity).  Then 28 shuffles give every
// lane the lower triangle of M and 7 give it nle.  Lane r runs rotor r's
// allocation row and lag, and the rotor sums run in rotor order r = 0..7
// over the shuffled speeds on every lane.  The chain's and the vehicle's
// constants arrive by value in a __grid_constant__ POD struct
// (RneaPlantParams), read uniformly across the warp.  A row past the batch
// (the rest of the last warp) repeats the last row's work and writes
// nothing, so every lane reaches every shuffle.  One body for every batch
// size; no atomics, no fast-math.  The float32 operations follow PyTorch's
// order where it is plain (the RNEA's sums, the rotor sums); the factor and
// solves are textbook forward order, so the kernel agrees with its plain
// version to rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define RP_STATE 46   // plant state vector (ops/cuda/plant_kernel's layout)
#define RP_J 7        // arm joints
#define RP_R 8        // rotors
#define RP_EXT 6      // external body wrench: force 3 | torque 3
#define RP_LANES 8    // lanes per vehicle row (shuffle width)
#define RP_BLOCK 64   // threads per block: 8 rows
#define RP_FULL 0xffffffffu

// Per-configuration constants.  Field order and types must match the
// ctypes Structure RneaPlantParams in ops/cuda/rnea_plant_kernel.py; every
// field is 4 bytes, so both sides lay it out without padding.
struct RneaPlantParams {
  int substeps, ff_gravity;
  float dt, mass, ixx, iyy, izz, xlen, ylen;
  float alloc[4][RP_R];  // rotor speed^2 -> [tau_roll, tau_pitch, tau_yaw, T]
  float pinv[RP_R][4];   // its right pseudo-inverse
  float a_up, a_dn, w_max, c_drag, c_roll, ground_z;
  float oa[RP_J][9], ob[RP_J][9], oc[RP_J][9];  // R_j(q) = cos q OA + sin q OB + OC
  float org[RP_J][3], axis[RP_J][3];            // joint origins and axes
  float q_lo[RP_J], q_hi[RP_J];
  float link_mass[RP_J], com[RP_J][3], inertia[RP_J][9];  // payload on link 7 included
  float att_kp[3], att_kd[3];                   // attitude PD (MODE 0)
  float kp_x, kp_y, kp_z, kd_x, kd_y, kd_z, ki_x, ki_y, ki_z;  // backstepping (MODE 1)
  float kp_roll, kp_pitch, kp_yaw, kd_roll, kd_pitch, kd_yaw;
  float rate_damping;                           // direct wrench (MODE 2)
};

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// R_j(q) from its cos and sin.
__device__ __forceinline__ void joint_rot(const RneaPlantParams& p, int j, float c, float s,
                                          float* r) {
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = c * p.oa[j][k] + s * p.ob[j][k] + p.oc[j][k];
}

template <int MODE, bool MM_ONCE>
__global__ void __launch_bounds__(RP_BLOCK)
rnea_plant_kernel(const __grid_constant__ RneaPlantParams p, const float* __restrict__ state,
                  const float* __restrict__ cmd, const float* __restrict__ tau,
                  const float* __restrict__ ext, float* __restrict__ out, int n) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = gid & (RP_LANES - 1);  // M column c = lane (< 7), nle on lane 7; rotor r = lane
  const int row = gid / RP_LANES;
  const int b = row < n ? row : n - 1;    // a row past the batch repeats the last
  const float* s0 = state + (size_t)b * RP_STATE;
  const float dt = p.dt;
  const bool nle_lane = lane == RP_J;

  float px = s0[0], py = s0[1], pz = s0[2];
  float qw = s0[3], qx = s0[4], qy = s0[5], qz = s0[6];
  float vx = s0[7], vy = s0[8], vz = s0[9];
  float wr = s0[10], wp = s0[11], wy = s0[12];
  float rot = s0[13 + lane];  // rotor r = lane
  float q[RP_J], qd[RP_J], tq[RP_J];
#pragma unroll
  for (int j = 0; j < RP_J; ++j) {
    q[j] = s0[21 + j];
    qd[j] = s0[28 + j];
    tq[j] = __ldg(tau + RP_J * b + j);
  }
  float ie[3], pe[3], mh[3], nh[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ie[i] = s0[35 + i];
    pe[i] = s0[38 + i];
    mh[i] = s0[41 + i];
  }
  nh[0] = s0[44];
  nh[1] = s0[45];
  float u_in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u_in[i] = __ldg(cmd + 4 * b + i);
  float ef[3] = {0.0f, 0.0f, 0.0f}, et[3] = {0.0f, 0.0f, 0.0f};
  if (ext != nullptr) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ef[i] = __ldg(ext + RP_EXT * b + i);
      et[i] = __ldg(ext + RP_EXT * b + 3 + i);
    }
  }
  const float pinv0 = p.pinv[lane][0], pinv1 = p.pinv[lane][1];
  const float pinv2 = p.pinv[lane][2], pinv3 = p.pinv[lane][3];
  float alpha_y = 0.0f, beta_y = 0.0f;
  if (MODE == 1) {
    alpha_y = cosf(u_in[3]);
    beta_y = sinf(u_in[3]);
  }

  float L[RP_J][RP_J];  // lower Cholesky factor of M (MM_ONCE: of the period's first q)
#pragma unroll
  for (int i = 0; i < RP_J; ++i)
#pragma unroll
    for (int k = 0; k < RP_J; ++k) L[i][k] = 0.0f;

#pragma unroll 1
  for (int it = 0; it < p.substeps; ++it) {
    // --- the base rotation from the normalized quaternion -----------------
    const float qn = fmaxf(sqrtf(qw * qw + qx * qx + qy * qy + qz * qz), 1e-12f);
    const float nw = qw / qn, nx_ = qx / qn, ny_ = qy / qn, nz_ = qz / qn;
    const float xx = nx_ * nx_, yy = ny_ * ny_, zz = nz_ * nz_;
    const float wx = nw * nx_, wyq = nw * ny_, wz = nw * nz_;
    const float xy = nx_ * ny_, xz = nx_ * nz_, yz = ny_ * nz_;
    const float m00 = 1.0f - 2.0f * (yy + zz), m01 = 2.0f * (xy - wz), m02 = 2.0f * (xz + wyq);
    const float m10 = 2.0f * (xy + wz), m11 = 1.0f - 2.0f * (xx + zz), m12 = 2.0f * (yz - wx);
    const float m20 = 2.0f * (xz - wyq), m21 = 2.0f * (yz + wx), m22 = 1.0f - 2.0f * (xx + yy);

    float cj[RP_J], sj[RP_J];
#pragma unroll
    for (int j = 0; j < RP_J; ++j) sincosf(q[j], &sj[j], &cj[j]);

    // --- one RNEA pass per lane: column `lane` of M, or nle on lane 7 -----
    float tau_out[RP_J];
    {
      float w[3] = {0.0f, 0.0f, 0.0f}, dw[3] = {0.0f, 0.0f, 0.0f};
      float a[3] = {0.0f, 0.0f, 0.0f};
      if (nle_lane) {  // a0 = R^T (0, 0, g): the third row of R
        a[0] = 9.81f * m20;
        a[1] = 9.81f * m21;
        a[2] = 9.81f * m22;
      }
      float fl[RP_J][3], nl[RP_J][3];
#pragma unroll
      for (int j = 0; j < RP_J; ++j) {
        float r[9];
        joint_rot(p, j, cj[j], sj[j], r);
        const float* pj = p.org[j];
        const float* ax = p.axis[j];
        const float qdv = nle_lane ? qd[j] : 0.0f;
        const float qddv = lane == j ? 1.0f : 0.0f;
        float t1[3], t2[3], t3[3], t[3];
        cross3(dw, pj, t1);
        cross3(w, pj, t2);
        cross3(w, t2, t3);
#pragma unroll
        for (int k = 0; k < 3; ++k) t[k] = a[k] + t1[k] + t3[k];
        float rw[3], rdw[3], an[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {  // r^T v: column k of r
          an[k] = r[k] * t[0] + r[3 + k] * t[1] + r[6 + k] * t[2];
          rw[k] = r[k] * w[0] + r[3 + k] * w[1] + r[6 + k] * w[2];
          rdw[k] = r[k] * dw[0] + r[3 + k] * dw[1] + r[6 + k] * dw[2];
        }
        const float qdj[3] = {qdv * ax[0], qdv * ax[1], qdv * ax[2]};
        float rxq[3];
        cross3(rw, qdj, rxq);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          w[k] = rw[k] + qdj[k];
          dw[k] = rdw[k] + qddv * ax[k] + rxq[k];
          a[k] = an[k];
        }
        // link j's inertial force and moment about its centre of mass
        const float* cm = p.com[j];
        const float* ii = p.inertia[j];
        float u1[3], u2[3], u3[3];
        cross3(dw, cm, u1);
        cross3(w, cm, u2);
        cross3(w, u2, u3);
        const float mj = p.link_mass[j];
#pragma unroll
        for (int k = 0; k < 3; ++k) fl[j][k] = mj * (a[k] + u1[k] + u3[k]);
        float idw[3], iw[3], wiw[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          idw[k] = ii[3 * k] * dw[0] + ii[3 * k + 1] * dw[1] + ii[3 * k + 2] * dw[2];
          iw[k] = ii[3 * k] * w[0] + ii[3 * k + 1] * w[1] + ii[3 * k + 2] * w[2];
        }
        cross3(w, iw, wiw);
#pragma unroll
        for (int k = 0; k < 3; ++k) nl[j][k] = idw[k] + wiw[k];
      }
      float fc[3] = {0.0f, 0.0f, 0.0f}, nc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = RP_J - 1; j >= 0; --j) {
        float r[9];
        joint_rot(p, j, cj[j], sj[j], r);
        float cf[3], fj[3], nj[3];
        cross3(p.com[j], fl[j], cf);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          fj[k] = fl[j][k] + fc[k];
          nj[k] = nl[j][k] + cf[k] + nc[k];
        }
        tau_out[j] = nj[0] * p.axis[j][0] + nj[1] * p.axis[j][1] + nj[2] * p.axis[j][2];
        float fp[3], rn[3], pxf[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          fp[k] = r[3 * k] * fj[0] + r[3 * k + 1] * fj[1] + r[3 * k + 2] * fj[2];
          rn[k] = r[3 * k] * nj[0] + r[3 * k + 1] * nj[1] + r[3 * k + 2] * nj[2];
        }
        cross3(p.org[j], fp, pxf);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          nc[k] = rn[k] + pxf[k];
          fc[k] = fp[k];
        }
      }
    }

    // --- the arm's gravity moment on the base: sum_j m_j (c_j x g_b) ------
    float tg[3] = {0.0f, 0.0f, 0.0f};
    {
      const float gb[3] = {-9.81f * m20, -9.81f * m21, -9.81f * m22};
      float rc[9], pc[3];
#pragma unroll
      for (int j = 0; j < RP_J; ++j) {
        float r[9];
        joint_rot(p, j, cj[j], sj[j], r);
        if (j == 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) pc[k] = p.org[0][k];
#pragma unroll
          for (int k = 0; k < 9; ++k) rc[k] = r[k];
        } else {
          float nr[9];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            pc[k] += rc[3 * k] * p.org[j][0] + rc[3 * k + 1] * p.org[j][1] +
                     rc[3 * k + 2] * p.org[j][2];
#pragma unroll
            for (int m = 0; m < 3; ++m)
              nr[3 * k + m] =
                  rc[3 * k] * r[m] + rc[3 * k + 1] * r[3 + m] + rc[3 * k + 2] * r[6 + m];
          }
#pragma unroll
          for (int k = 0; k < 9; ++k) rc[k] = nr[k];
        }
        float cw[3], cxg[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          cw[k] = pc[k] + (rc[3 * k] * p.com[j][0] + rc[3 * k + 1] * p.com[j][1] +
                           rc[3 * k + 2] * p.com[j][2]);
        cross3(cw, gb, cxg);
#pragma unroll
        for (int k = 0; k < 3; ++k) tg[k] += cxg[k] * p.link_mass[j];
      }
    }

    // --- M's factor (every lane), nle from lane 7, qdd by two solves ------
    if (!MM_ONCE || it == 0) {
#pragma unroll
      for (int jc = 0; jc < RP_J; ++jc) {
        float mcol[RP_J];  // rows i >= jc of column jc, from lane jc
#pragma unroll
        for (int i = jc; i < RP_J; ++i) mcol[i] = __shfl_sync(RP_FULL, tau_out[i], jc, RP_LANES);
        float d = mcol[jc];
#pragma unroll
        for (int k = 0; k < jc; ++k) d -= L[jc][k] * L[jc][k];
        L[jc][jc] = sqrtf(d);
#pragma unroll
        for (int i = jc + 1; i < RP_J; ++i) {
          float s = mcol[i];
#pragma unroll
          for (int k = 0; k < jc; ++k) s -= L[i][k] * L[jc][k];
          L[i][jc] = s / L[jc][jc];
        }
      }
    }
    float y[RP_J], qdd[RP_J];
#pragma unroll
    for (int i = 0; i < RP_J; ++i) {
      float s = tq[i] - __shfl_sync(RP_FULL, tau_out[i], RP_J, RP_LANES);
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
      y[i] = s / L[i][i];
    }
#pragma unroll
    for (int i = RP_J - 1; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int k = i + 1; k < RP_J; ++k) s -= L[k][i] * qdd[k];
      qdd[i] = s / L[i][i];
    }

    // --- joint integration and hard stops (keyed on the unclamped q) ------
#pragma unroll
    for (int j = 0; j < RP_J; ++j) {
      const float qdj = qd[j] + qdd[j] * dt;
      const float qraw = q[j] + qdj * dt;
      const bool at_stop = qraw < p.q_lo[j] || qraw > p.q_hi[j];
      q[j] = fminf(fmaxf(qraw, p.q_lo[j]), p.q_hi[j]);
      qd[j] = at_stop ? 0.0f : qdj;
    }

    // --- the mode's base law -> U = [T, tau_x, tau_y, tau_z] -------------
    float u1, u2, u3, u4;
    if (MODE == 2) {
      float tc[3] = {u_in[1], u_in[2], u_in[3]};
      if (p.ff_gravity) {
#pragma unroll
        for (int k = 0; k < 3; ++k) tc[k] = tc[k] - tg[k];
      }
      if (p.rate_damping != 0.0f) {
        tc[0] = tc[0] - p.rate_damping * (p.ixx * wr);
        tc[1] = tc[1] - p.rate_damping * (p.iyy * wp);
        tc[2] = tc[2] - p.rate_damping * (p.izz * wy);
      }
      u1 = u_in[0];
      u2 = tc[0];
      u3 = tc[1];
      u4 = tc[2];
    } else {
      // ZYX angles of the rotation
      const float roll = atan2f(m21, m22);
      const float pitch = asinf(fminf(fmaxf(-m20, -1.0f), 1.0f));
      const float yaw = atan2f(m10, m00);
      if (MODE == 0) {
        u1 = u_in[0];
        u2 = p.ixx * (p.att_kp[0] * (u_in[1] - roll) - p.att_kd[0] * wr) - tg[0];
        u3 = p.iyy * (p.att_kp[1] * (u_in[2] - pitch) - p.att_kd[1] * wp) - tg[1];
        u4 = p.izz * (p.att_kp[2] * (u_in[3] - yaw) - p.att_kd[2] * wy) - tg[2];
      } else {
        // adaptive backstepping on the position setpoint (zero velocity
        // and yaw-rate feed-forward)
        const float err[3] = {u_in[0] - px, u_in[1] - py, u_in[2] - pz};
        float integ[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) integ[i] = ie[i] + 0.5f * (err[i] + pe[i]) * dt;
        const float e5 = err[2], p5 = integ[2];
        const float e6 = p.kp_z * e5 + p.ki_z * p5 - vz;
        const float az = 9.81f + p.ki_z * e5 + p.kp_z * (-p.kp_z * e5 - p.ki_z * p5 + e6) + e5 +
                         p.kd_z * e6;
        const float mz = mh[2] + 3.0f * e6 * az * dt;
        u1 = (mz / (cosf(roll) * cosf(pitch))) * az;

        const float ex2 = p.kp_x * err[0] + p.ki_x * integ[0] - vx;
        const float ax_ = p.ki_x * err[0] - p.kp_x * p.kp_x * err[0] -
                          p.ki_x * p.kp_x * integ[0] + p.kp_x * ex2 + err[0] + p.kd_x * ex2;
        const float mx = mh[0] + 2.0f * ex2 * ax_ * dt;
        const float ux = (mx / u1) * ax_;
        const float ey2 = p.kp_y * err[1] + p.ki_y * integ[1] - vy;
        const float ay_ = p.ki_y * err[1] - p.kp_y * p.kp_y * err[1] -
                          p.ki_y * p.kp_y * integ[1] + p.kp_y * ey2 + err[1] + p.kd_y * ey2;
        const float my = mh[1] + 2.0f * ey2 * ay_ * dt;
        const float uy = (my / u1) * ay_;

        float v1 = alpha_y * ux + beta_y * uy;
        const float v2 = beta_y * ux - alpha_y * uy;
        const float sphi = fminf(fmaxf(v2, -1.0f), 1.0f);
        const float roll_des = atan2f(sphi, sqrtf(1.0f - sphi * sphi));
        v1 = v1 / cosf(roll_des);
        const float stheta = fminf(fmaxf(v1, -1.0f), 1.0f);
        const float pitch_des = atan2f(stheta, sqrtf(1.0f - stheta * stheta));

        const float z1 = roll - roll_des;
        const float z2 = wr - (0.0f - p.kp_roll * z1);
        const float nxh = nh[0] + 3.0f * z2 * dt;
        u2 = (p.ixx / p.ylen) * (-p.kp_roll * (z2 - p.kp_roll * z1) - z1 - p.kd_roll * z2 - nxh -
                                 p.xlen * tg[0] / p.ixx) +
             (1.0f / p.ylen) * ((p.izz - p.iyy) * wp * wy);
        const float z3 = pitch - pitch_des;
        const float z4 = wp - (0.0f - p.kp_pitch * z3);
        const float nyh = nh[1] + 3.0f * z4 * dt;
        // The reference's pitch channel: -kp_pitch * (z4 - kd_pitch * z3).
        u3 = (p.iyy / p.xlen) * (-p.kp_pitch * (z4 - p.kd_pitch * z3) - z3 - p.kd_pitch * z4 -
                                 nyh - p.ylen * tg[1] / p.iyy) +
             (1.0f / p.xlen) * ((p.ixx - p.izz) * wr * wy);
        const float z5 = yaw - u_in[3];
        const float z6 = wy - (0.0f - p.kp_yaw * z5);
        u4 = p.izz * (-p.kp_yaw * (z6 - p.kd_yaw * z5) - z5 - p.kd_yaw * z6 - tg[2] / p.izz) +
             (p.iyy - p.ixx) * wr * wp;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          ie[i] = integ[i];
          pe[i] = err[i];
        }
        mh[0] = mx;
        mh[1] = my;
        mh[2] = mz;
        nh[0] = nxh;
        nh[1] = nyh;
      }
    }

    // --- allocation + asymmetric rotor lag: rotor r on lane r -----------
    {
      const float w2 = pinv0 * u2 + pinv1 * u3 + pinv2 * u4 + pinv3 * u1;
      float wcmd = sqrtf(fmaxf(w2, 0.0f));
      wcmd = fminf(fmaxf(wcmd, 0.0f), p.w_max);
      const float al = wcmd > rot ? p.a_up : p.a_dn;
      rot = al * rot + (1.0f - al) * wcmd;
    }

    // --- rotor wrench, summed in rotor order on every lane ---------------
    float t_r = 0.0f, t_p = 0.0f, t_y = 0.0f, thrust = 0.0f, absw = 0.0f;
#pragma unroll
    for (int r = 0; r < RP_R; ++r) {
      const float wr_ = __shfl_sync(RP_FULL, rot, r, RP_LANES);
      const float w2 = wr_ * wr_;
      t_r += p.alloc[0][r] * w2;
      t_p += p.alloc[1][r] * w2;
      t_y += p.alloc[2][r] * w2;
      thrust += p.alloc[3][r] * w2;
      absw += fabsf(wr_);
    }
    // body-frame airspeed R^T v, its z component dropped for the drag
    const float vbx = m00 * vx + m10 * vy + m20 * vz;
    const float vby = m01 * vx + m11 * vy + m21 * vz;
    const float fx = -p.c_drag * absw * vbx + ef[0];
    const float fy = -p.c_drag * absw * vby + ef[1];
    const float fz = thrust + ef[2];
    const float tq_r = (t_r - p.c_roll * absw * vbx) + (tg[0] + et[0]);
    const float tq_p = (t_p - p.c_roll * absw * vby) + (tg[1] + et[1]);
    const float tq_y = t_y + (tg[2] + et[2]);

    // --- rigid-body integration -----------------------------------------
    const float ax = (m00 * fx + m01 * fy + m02 * fz) / p.mass;
    const float ay = (m10 * fx + m11 * fy + m12 * fz) / p.mass;
    const float az_w = (m20 * fx + m21 * fy + m22 * fz) / p.mass - 9.81f;
    const float wdx = (tq_r - (wp * (p.izz * wy) - wy * (p.iyy * wp))) / p.ixx;
    const float wdy = (tq_p - (wy * (p.ixx * wr) - wr * (p.izz * wy))) / p.iyy;
    const float wdz = (tq_y - (wr * (p.iyy * wp) - wp * (p.ixx * wr))) / p.izz;
    vx += ax * dt;
    vy += ay * dt;
    vz += az_w * dt;
    px += vx * dt;
    py += vy * dt;
    pz += vz * dt;
    wr += wdx * dt;
    wp += wdy * dt;
    wy += wdz * dt;
    // inelastic ground clamp
    if (pz <= p.ground_z) {
      pz = p.ground_z;
      vx = 0.0f;
      vy = 0.0f;
      vz = fmaxf(vz, 0.0f);
      wr = 0.0f;
      wp = 0.0f;
      wy = 0.0f;
    }
    // quaternion update: q * exp(omega dt / 2), normalized
    const float aax = wr * dt, aay = wp * dt, aaz = wy * dt;
    const float ang = sqrtf(aax * aax + aay * aay + aaz * aaz);
    const float half = 0.5f * ang;
    const float scale = ang > 1e-6f ? sinf(half) / fmaxf(ang, 1e-12f) : 0.5f - ang * ang / 48.0f;
    const float dw = cosf(half), dx = aax * scale, dy = aay * scale, dz = aaz * scale;
    const float nqw = qw * dw - qx * dx - qy * dy - qz * dz;
    const float nqx = qw * dx + qx * dw + qy * dz - qz * dy;
    const float nqy = qw * dy - qx * dz + qy * dw + qz * dx;
    const float nqz = qw * dz + qx * dy - qy * dx + qz * dw;
    const float nrm = fmaxf(sqrtf(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz), 1e-12f);
    qw = nqw / nrm;
    qx = nqx / nrm;
    qy = nqy / nrm;
    qz = nqz / nrm;
  }

  if (row >= n) return;
  float* o = out + (size_t)b * RP_STATE;
  o[13 + lane] = rot;
  if (lane != 0) return;
  o[0] = px; o[1] = py; o[2] = pz;
  o[3] = qw; o[4] = qx; o[5] = qy; o[6] = qz;
  o[7] = vx; o[8] = vy; o[9] = vz;
  o[10] = wr; o[11] = wp; o[12] = wy;
#pragma unroll
  for (int j = 0; j < RP_J; ++j) {
    o[21 + j] = q[j];
    o[28 + j] = qd[j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[35 + i] = ie[i];
    o[38 + i] = pe[i];
    o[41 + i] = mh[i];
  }
  o[44] = nh[0];
  o[45] = nh[1];
}

template <int MODE, bool MM_ONCE>
static void launch(const RneaPlantParams* p, const float* state, const float* cmd,
                   const float* tau, const float* ext, float* out, int n, cudaStream_t stream) {
  const int rows_per_block = RP_BLOCK / RP_LANES;
  rnea_plant_kernel<MODE, MM_ONCE><<<(n + rows_per_block - 1) / rows_per_block, RP_BLOCK, 0,
                                     stream>>>(*p, state, cmd, tau, ext, out, n);
}

extern "C" {

// One control period for n vehicle rows; `ext` may be null (no external
// wrench).  mode: 0 attitude, 1 position, 2 wrench; mm_once: factor M once
// per period.  Returns cudaGetLastError() after the launch.
int rnea_plant_launch(const RneaPlantParams* p, int mode, int mm_once, const float* state,
                      const float* cmd, const float* tau, const float* ext, float* out, int n,
                      void* stream) {
  if (n <= 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode * 2 + (mm_once ? 1 : 0)) {
    case 0: launch<0, false>(p, state, cmd, tau, ext, out, n, s); break;
    case 1: launch<0, true>(p, state, cmd, tau, ext, out, n, s); break;
    case 2: launch<1, false>(p, state, cmd, tau, ext, out, n, s); break;
    case 3: launch<1, true>(p, state, cmd, tau, ext, out, n, s); break;
    case 4: launch<2, false>(p, state, cmd, tau, ext, out, n, s); break;
    default: launch<2, true>(p, state, cmd, tau, ext, out, n, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
