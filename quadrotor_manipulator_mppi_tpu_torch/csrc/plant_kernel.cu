// Plant-tick kernel for NVIDIA Hopper (sm_90a): one control period of the
// whole-body plant at 1 kHz.
//
// Replaces the TPU kernel of
// quadrotor_manipulator_mppi_tpu/ops/pallas/plant_kernel.py
// (make_plant_tick_kernel, kernel body :137): `substeps` semi-implicit
// Euler steps of the serving configuration's plant -- position mode, frozen
// arm coefficients, free flight.  Each substep runs the frozen arm forward
// dynamics (7x7x7 Coriolis contraction, M^-1, joint stops), the arm gravity
// moment on the base, the ZYX attitude, the adaptive backstepping law, the
// 8x4 pseudo-inverse allocation with the asymmetric rotor lag, the rotor
// wrench and drag, the integration with the inelastic ground clamp, and the
// axis-angle quaternion update.
//
// What bounds it on this card.  Per vehicle row it reads 479 floats
// (state 46, coefficients 422, command 4, torque 7) and writes 46, and does
// ~15.6k float32 operations over 10 substeps (~1.56k per substep, 777 of
// them the frozen Coriolis contraction): 8 operations per byte, under the
// H100's ~20 float32 operations per byte, so a full card of rows would be
// bound by bytes.  The serving loop runs ONE row (B = 1): the work is a few
// nanoseconds, and the kernel's time is its launch and the chain of
// dependent instructions a warp issues over the 10 substeps.
//
// What the design does about it.  Eight lanes per vehicle row
// (PT_LANES), four rows per warp, PT_BLOCK threads a block; shuffles have
// width 8.  Before the substep loop each lane loads, once, the
// coefficients it uses into registers: lane i < 7 its row i of the
// Coriolis tensor (49), of M^-1 (7) and of g_tau (3), and its joint's
// stops; lane r its rotor's pseudo-inverse row; every lane g_n (9).  In a
// substep lane i forms Coriolis row i, rhs_i, then M^-1 rhs row i from
// the rhs_j of the other lanes (shuffles), and joint i's integration and
// stop; lane r runs the allocation and the asymmetric lag of rotor r.
// Everything else -- the attitude, the backstepping law, the wrench sums
// in rotor order r = 0..7 over the shuffled rotor speeds, the rigid-body
// step -- every lane computes alike, so no value of the base state has to
// be broadcast and no branch diverges inside a row.  The 777-operation
// contraction is issued as 111 warp instructions, and no coefficient is
// read again inside the loop.  Every lane keeps the single-thread
// kernel's arithmetic order (j, then k, in a Coriolis row; j in M^-1 rhs;
// r = 0..7 in every rotor sum), and the source is built with
// --fmad=false, so each output is the same float32 expression as before.
// A row past the batch (the rest of the last warp) repeats the last row's
// work and writes nothing, so every lane reaches every shuffle.  One body
// for every batch size.  Per-configuration constants arrive by value in a
// POD struct (PlantParams).  Inverse trig uses atan2f/asinf (the TPU
// kernel's polynomial has no counterpart here); no fast-math flags.

#include <cuda_runtime.h>
#include <stdint.h>

#define PT_STATE 46   // plant state vector
#define PT_DYN 422    // minv 49 | g_tau 21 | g_n 9 | c_tau 343
#define PT_J 7        // arm joints
#define PT_R 8        // rotors
#define PT_LANES 8    // lanes per vehicle row (shuffle width)
#define PT_BLOCK 64   // threads per block: 8 rows
#define PT_FULL 0xffffffffu

// Per-configuration constants.  Field order and types must match the
// ctypes Structure PlantParams in ops/cuda/plant_kernel.py; every field is
// 4 bytes, so both sides lay it out without padding.  The kernel takes it
// as a __grid_constant__ parameter, so a lane's row of it (a joint's
// stops, a rotor's pseudo-inverse row) is read in place, not copied.
struct PlantParams {
  int substeps, pad_;
  float dt, mass, ixx, iyy, izz, xlen, ylen;
  float alloc[4][PT_R];  // rotor speed^2 -> [tau_roll, tau_pitch, tau_yaw, T]
  float pinv[PT_R][4];   // its right pseudo-inverse
  float a_up, a_dn, w_max, c_drag, c_roll, ground_z;
  float q_lo[PT_J], q_hi[PT_J];
  float kp_x, kp_y, kp_z, kd_x, kd_y, kd_z, ki_x, ki_y, ki_z;
  float kp_roll, kp_pitch, kp_yaw, kd_roll, kd_pitch, kd_yaw;
};

__global__ void __launch_bounds__(PT_BLOCK)
plant_tick_kernel(const __grid_constant__ PlantParams p, const float* __restrict__ state,
                  const float* __restrict__ dyn, const float* __restrict__ cmd,
                  const float* __restrict__ tau, float* __restrict__ out, int n) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = gid & (PT_LANES - 1);  // joint i = lane (lane 7 repeats 6); rotor r = lane
  const int row = gid / PT_LANES;
  const int b = row < n ? row : n - 1;    // a row past the batch repeats the last
  const int ji = lane < PT_J ? lane : PT_J - 1;
  const float* s0 = state + (size_t)b * PT_STATE;
  const float* minv = dyn + (size_t)b * PT_DYN;
  const float* g_tau = minv + 49;
  const float* g_n = g_tau + 21;
  const float* c_tau = g_n + 9;
  const float dt = p.dt;

  // This lane's coefficients, loaded once.
  float crow[PT_J][PT_J], mrow[PT_J], gtr[3], gn[9];
#pragma unroll
  for (int j = 0; j < PT_J; ++j) {
#pragma unroll
    for (int k = 0; k < PT_J; ++k) crow[j][k] = __ldg(c_tau + (ji * PT_J + j) * PT_J + k);
    mrow[j] = __ldg(minv + ji * PT_J + j);
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) gtr[m] = __ldg(g_tau + 3 * ji + m);
#pragma unroll
  for (int m = 0; m < 9; ++m) gn[m] = __ldg(g_n + m);
  const float q_lo = p.q_lo[ji], q_hi = p.q_hi[ji];
  const float pinv0 = p.pinv[lane][0], pinv1 = p.pinv[lane][1];
  const float pinv2 = p.pinv[lane][2], pinv3 = p.pinv[lane][3];

  float px = s0[0], py = s0[1], pz = s0[2];
  float qw = s0[3], qx = s0[4], qy = s0[5], qz = s0[6];
  float vx = s0[7], vy = s0[8], vz = s0[9];
  float wr = s0[10], wp = s0[11], wy = s0[12];
  float rot = s0[13 + lane];              // rotor r = lane
  float qj = s0[21 + ji], qdj_ = s0[28 + ji];  // joint i = lane
  float ie[3], pe[3], mh[3], nh[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ie[i] = s0[35 + i];
    pe[i] = s0[38 + i];
    mh[i] = s0[41 + i];
  }
  nh[0] = s0[44];
  nh[1] = s0[45];
  const float spx = __ldg(cmd + 4 * b), spy = __ldg(cmd + 4 * b + 1);
  const float spz = __ldg(cmd + 4 * b + 2), yaw_des = __ldg(cmd + 4 * b + 3);
  const float tau_i = __ldg(tau + PT_J * b + ji);
  const float alpha_y = cosf(yaw_des), beta_y = sinf(yaw_des);

#pragma unroll 1
  for (int it = 0; it < p.substeps; ++it) {
    // --- frozen arm dynamics: row i on lane i ----------------------------
    float qd[PT_J];
#pragma unroll
    for (int k = 0; k < PT_J; ++k) qd[k] = __shfl_sync(PT_FULL, qdj_, k, PT_LANES);
    const float a0[3] = {9.81f * (2.0f * (qx * qz - qw * qy)),
                         9.81f * (2.0f * (qy * qz + qw * qx)),
                         9.81f * (1.0f - 2.0f * (qx * qx + qy * qy))};
    float acc = gtr[0] * a0[0] + gtr[1] * a0[1] + gtr[2] * a0[2];
#pragma unroll
    for (int j = 0; j < PT_J; ++j) {
      float inner = 0.0f;
#pragma unroll
      for (int k = 0; k < PT_J; ++k) inner += crow[j][k] * qd[k];
      acc += qd[j] * inner;
    }
    const float rhs = tau_i - acc;
    float qdd = 0.0f;
#pragma unroll
    for (int j = 0; j < PT_J; ++j) qdd += mrow[j] * __shfl_sync(PT_FULL, rhs, j, PT_LANES);
    {
      const float qdj = qdj_ + qdd * dt;
      const float qraw = qj + qdj * dt;
      // The stop test reads the unclamped position.
      const bool at_stop = qraw < q_lo || qraw > q_hi;
      qj = fminf(fmaxf(qraw, q_lo), q_hi);
      qdj_ = at_stop ? 0.0f : qdj;
    }
    float tg[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      tg[i] = -(gn[3 * i] * a0[0] + gn[3 * i + 1] * a0[1] + gn[3 * i + 2] * a0[2]);

    // --- attitude: ZYX angles of the quaternion's rotation ---------------
    const float m00 = 1.0f - 2.0f * (qy * qy + qz * qz);
    const float m01 = 2.0f * (qx * qy - qw * qz);
    const float m02 = 2.0f * (qx * qz + qw * qy);
    const float m10 = 2.0f * (qx * qy + qw * qz);
    const float m11 = 1.0f - 2.0f * (qx * qx + qz * qz);
    const float m12 = 2.0f * (qy * qz - qw * qx);
    const float m20 = 2.0f * (qx * qz - qw * qy);
    const float m21 = 2.0f * (qy * qz + qw * qx);
    const float m22 = 1.0f - 2.0f * (qx * qx + qy * qy);
    const float roll = atan2f(m21, m22);
    const float pitch = asinf(fminf(fmaxf(-m20, -1.0f), 1.0f));
    const float yaw = atan2f(m10, m00);

    // --- adaptive backstepping ------------------------------------------
    const float err[3] = {spx - px, spy - py, spz - pz};
    float integ[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) integ[i] = ie[i] + 0.5f * (err[i] + pe[i]) * dt;
    const float e5 = err[2], p5 = integ[2];
    const float e6 = p.kp_z * e5 + p.ki_z * p5 - vz;
    const float az = 9.81f + p.ki_z * e5 + p.kp_z * (-p.kp_z * e5 - p.ki_z * p5 + e6) + e5 +
                     p.kd_z * e6;
    const float mz = mh[2] + 3.0f * e6 * az * dt;
    const float u1 = (mz / (cosf(roll) * cosf(pitch))) * az;

    const float ex2 = p.kp_x * err[0] + p.ki_x * integ[0] - vx;
    const float ax_ = p.ki_x * err[0] - p.kp_x * p.kp_x * err[0] - p.ki_x * p.kp_x * integ[0] +
                      p.kp_x * ex2 + err[0] + p.kd_x * ex2;
    const float mx = mh[0] + 2.0f * ex2 * ax_ * dt;
    const float ux = (mx / u1) * ax_;
    const float ey2 = p.kp_y * err[1] + p.ki_y * integ[1] - vy;
    const float ay_ = p.ki_y * err[1] - p.kp_y * p.kp_y * err[1] - p.ki_y * p.kp_y * integ[1] +
                      p.kp_y * ey2 + err[1] + p.kd_y * ey2;
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
    const float nx = nh[0] + 3.0f * z2 * dt;
    const float u2 = (p.ixx / p.ylen) * (-p.kp_roll * (z2 - p.kp_roll * z1) - z1 -
                                         p.kd_roll * z2 - nx - p.xlen * tg[0] / p.ixx) +
                     (1.0f / p.ylen) * ((p.izz - p.iyy) * wp * wy);
    const float z3 = pitch - pitch_des;
    const float z4 = wp - (0.0f - p.kp_pitch * z3);
    const float ny = nh[1] + 3.0f * z4 * dt;
    // The reference's pitch channel: -kp_pitch * (z4 - kd_pitch * z3).
    const float u3 = (p.iyy / p.xlen) * (-p.kp_pitch * (z4 - p.kd_pitch * z3) - z3 -
                                         p.kd_pitch * z4 - ny - p.ylen * tg[1] / p.iyy) +
                     (1.0f / p.xlen) * ((p.ixx - p.izz) * wr * wy);
    const float z5 = yaw - yaw_des;
    const float z6 = wy - (0.0f - p.kp_yaw * z5);
    const float u4 = p.izz * (-p.kp_yaw * (z6 - p.kd_yaw * z5) - z5 - p.kd_yaw * z6 -
                              tg[2] / p.izz) +
                     (p.iyy - p.ixx) * wr * wp;

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
    for (int r = 0; r < PT_R; ++r) {
      const float wr_ = __shfl_sync(PT_FULL, rot, r, PT_LANES);
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
    const float fx = -p.c_drag * absw * vbx;
    const float fy = -p.c_drag * absw * vby;
    const float fz = thrust;
    const float tq_r = t_r - p.c_roll * absw * vbx + tg[0];
    const float tq_p = t_p - p.c_roll * absw * vby + tg[1];
    const float tq_y = t_y + tg[2];

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
    float nqw = qw * dw - qx * dx - qy * dy - qz * dz;
    float nqx = qw * dx + qx * dw + qy * dz - qz * dy;
    float nqy = qw * dy - qx * dz + qy * dw + qz * dx;
    float nqz = qw * dz + qx * dy - qy * dx + qz * dw;
    const float nrm = fmaxf(sqrtf(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz), 1e-12f);
    qw = nqw / nrm;
    qx = nqx / nrm;
    qy = nqy / nrm;
    qz = nqz / nrm;

#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ie[i] = integ[i];
      pe[i] = err[i];
    }
    mh[0] = mx;
    mh[1] = my;
    mh[2] = mz;
    nh[0] = nx;
    nh[1] = ny;
  }

  if (row >= n) return;
  float* o = out + (size_t)b * PT_STATE;
  o[13 + lane] = rot;
  if (lane < PT_J) {
    o[21 + lane] = qj;
    o[28 + lane] = qdj_;
  }
  if (lane != 0) return;
  o[0] = px; o[1] = py; o[2] = pz;
  o[3] = qw; o[4] = qx; o[5] = qy; o[6] = qz;
  o[7] = vx; o[8] = vy; o[9] = vz;
  o[10] = wr; o[11] = wp; o[12] = wy;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[35 + i] = ie[i];
    o[38 + i] = pe[i];
    o[41 + i] = mh[i];
  }
  o[44] = nh[0];
  o[45] = nh[1];
}

extern "C" {

// One control period for n vehicle rows.  Returns cudaGetLastError() after
// the launch.
int plant_tick_launch(const PlantParams* p, const float* state, const float* dyn,
                      const float* cmd, const float* tau, float* out, int n,
                      void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int rows_per_block = PT_BLOCK / PT_LANES;
  plant_tick_kernel<<<(n + rows_per_block - 1) / rows_per_block, PT_BLOCK, 0,
                      (cudaStream_t)stream>>>(*p, state, dyn, cmd, tau, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
