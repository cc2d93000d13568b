"""PyTorch / CUDA port of the whole-body MPPI framework, for NVIDIA Hopper.

The JAX package ``quadrotor_manipulator_mppi_tpu`` is the reference; this
package mirrors its module names so each counterpart is easy to find, and
never imports it (nor JAX).  Every Pallas kernel on a ported path becomes a
hand-written CUDA kernel under ``csrc/``, built with ``nvcc`` at first use
(``ops/cuda/build.py``); each kernel wrapper keeps a plain PyTorch version
beside it that runs for CPU tensors and serves as the on-card yardstick.

Layout:
  utils/       rotations, poses, rigid transforms, Savitzky-Golay, device
               selection, CUDA graphs, checkpoints, timing and tracing
  models/      kinematic chain (quaternion and matrix FK), the URDF loader,
               Kinova constants, rigid-body dynamics, the multirotor,
               whole-body, fixed-wing and point-mass models
  ops/         sampling (Philox), softmin, integrators, the cost library,
               and ``ops/cuda`` — the kernel wrappers and their build
  solver/      the plain MPPI pipeline; the whole-body, drone, arm,
               multirotor, fixed-wing and mapped solvers; serving
  sim/         closed loops, plants, flight control, sensors, the camera stack
  parallel/    process groups, the mesh, sharded solvers, scaling
  scenarios/   the scenario runners (``run.py`` is the command line)
  bridge/      the QMM solver bridge, its adapters and HIL session
  evaluation/  metrics, log analysis, plant parity, the rosbag reader,
               dataset collection
  config.py    the configuration tree and its JSON round trip
  convert.py   carries the JAX package's trees and states across
"""

import torch as _torch

# Geometry runs through small float32 matmuls (horizon operators, the
# Savitzky-Golay smoother) whose error budget is the 5 mm reach tolerance:
# keep every matmul and convolution in full float32, never TF32 — the same
# guard the JAX package applies with ``jax_default_matmul_precision``.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
