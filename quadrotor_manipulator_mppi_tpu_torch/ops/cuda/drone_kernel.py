"""The drone point-mass MPPI solve on hand-written CUDA kernels.

Port of the JAX package's ``ops/pallas/drone_kernel.py``: the fused
two-pass solve :func:`solve_drone_cuda`, the counterpart of
``solve_drone_pallas``, on the kernels of ``csrc/drone_kernel.cu``:

* pass 1 draws the noise in the kernel (Philox) or reads explicit
  sigma-scaled noise (K, H, A), double-integrates u_prev + eps per sample
  and writes the per-sample cost S (K,): one warp per sample, the horizon
  across its lanes, the integrations as warp scans;
* between the passes PyTorch forms the softmin weights w (K,);
* pass 2 reduces du = sum_k w_k eps_k (H, A), drawing the same noise again
  or reading it: a block per column of the (K, H*A) noise at small K, per
  tile of 32 columns and chunk of samples at large K, the chunks' partials
  summed in a fixed order by the tile's last block (:func:`update_split`);
* after the passes, du is smoothed (SavGol, one (H, H) matmul) and added to
  u_prev.

====================  =====================  ===============
wrapper               TPU kernel             PERF.md row
====================  =====================  ===============
drone_cost            _cost_kernel           9a
drone_update          _update_kernel         9b
drone_cost_noise      _cost_kernel_noise     9c
drone_update_noise    _update_kernel_noise   9d
====================  =====================  ===============

The noise is the port's Philox stream (``ops/sampling.py``) with key = the
solve's seed and counter = (0, sample k, a*H + t, 0), so
``sampling.philox_normals(seed, 0, K, H, A)`` is the plain versions'
stream word for word, and the first step of ``solver/drone``'s
``make_drone_solver`` on the same seed draws the same numbers.  The TPU's
in-kernel Box-Muller stream cannot be reproduced on any other device: only
the explicit-noise solve is compared with the JAX package.

The seed is a (1,) int64 tensor on the solve's device (an int is turned
into one, ``sampling.philox_keys``); a closed loop advances a tensor of
its own in place, so no host copy is made per solve.  Each wrapper
launches its kernel for CUDA tensors, or raises; for CPU tensors it runs
its plain version (``*_plain``).  Each wrapper's ``launches`` counts its
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ...ops import costs as costs_mod
from ...ops import integrators, sampling
from ...ops import weights as weights_ops
from ...utils import graphs, savgol
from ...utils.device import device_const
from . import build

Tensor = torch.Tensor

_SMEM_LIMIT = 48 * 1024   # default dynamic shared memory per block
COST_WARPS = 4            # samples (one warp each) per drone_cost block (DRONE_COST_WARPS)
WARP_LANES = 32           # horizon steps per drone_cost chunk (WARP_LANES)
UPDATE_TILE = 32          # columns of a wide drone_update block (DRONE_UPDATE_TILE)
UPDATE_WARPS = 8          # warps per drone_update block (DRONE_UPDATE_WARPS)
# The split rule, from chip_smoke's drone sweep on the H100.  Up to
# UPDATE_NARROW_MAX_K samples (16 a thread), with at least
# UPDATE_NARROW_MIN_COLUMNS columns (blocks for half the SMs), a block
# takes one column and all K: no cross-block sum.  Else a block takes 32
# columns, and K is split across blocks until the tiles fill the card (8
# resident blocks of 256 threads on each of the 132 SMs), at most one chunk
# per 4 samples a warp.
UPDATE_NARROW_MAX_K = 16 * UPDATE_WARPS * WARP_LANES
UPDATE_NARROW_MIN_COLUMNS = 64
UPDATE_BLOCKS = 8 * 132
UPDATE_MIN_CHUNK = 4 * UPDATE_WARPS


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def update_split(k: int, h: int, a: int):
    """(columns per block, column blocks, sample chunks, samples per chunk)
    of a drone_update launch over a (k, h*a) noise matrix.  A chunk holds a
    multiple of ``UPDATE_WARPS`` samples; the last may hold fewer."""
    c = h * a
    if k <= UPDATE_NARROW_MAX_K and c >= UPDATE_NARROW_MIN_COLUMNS:
        return 1, c, 1, _ceil_div(k, UPDATE_WARPS) * UPDATE_WARPS
    tiles = _ceil_div(c, UPDATE_TILE)
    chunks = max(1, min(_ceil_div(k, UPDATE_MIN_CHUNK), _ceil_div(UPDATE_BLOCKS, tiles)))
    k_chunk = _ceil_div(_ceil_div(k, chunks), UPDATE_WARPS) * UPDATE_WARPS
    return UPDATE_TILE, tiles, _ceil_div(k, k_chunk), k_chunk


_TICKETS: dict = {}


def _tickets(dev, blocks: int) -> Tensor:
    """The zeroed per-column-block tickets of the cross-chunk sum on
    ``dev`` (the kernel leaves them zero), allocated once per device and
    size."""
    t = _TICKETS.get(dev)
    if t is None or t.numel() < blocks:
        t = _TICKETS[dev] = torch.zeros(max(blocks, 64), dtype=torch.int32, device=dev)
    return t


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load_library("drone_kernel")
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.drone_cost_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, cf, cf, cf, cf, vp, vp]
    lib.drone_cost_launch.restype = ci
    lib.drone_update_launch.argtypes = [vp, vp, vp, ci, ci, ci, cf, ci, ci, vp, vp, vp, vp]
    lib.drone_update_launch.restype = ci
    return lib


def _check(t: Tensor, shape, device, name: str, dtype=torch.float32) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {str(dtype)[6:]} tensor of shape {tuple(shape)} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_cost_inputs(u_prev: Tensor, x0: Tensor, v0: Tensor, target: Tensor) -> None:
    h, a = u_prev.shape
    _check(u_prev, (h, a), u_prev.device, "u_prev")
    for name, t in (("x0", x0), ("v0", v0), ("target", target)):
        _check(t, (a,), u_prev.device, name)


def _launch_cost(name: str, u_prev: Tensor, x0: Tensor, v0: Tensor, target: Tensor,
                 noise: Optional[Tensor], seeds: Optional[Tensor], k: int, dt: float,
                 sigma: float, stage_w: float, term_w: float) -> Tensor:
    h, a = u_prev.shape
    dev = u_prev.device
    if (h * a + 3 * a) * 4 > _SMEM_LIMIT:
        raise ValueError("horizon too long for the kernel's shared-memory warm start")
    s = torch.empty(k, dtype=torch.float32, device=dev)
    rc = _lib().drone_cost_launch(
        u_prev.data_ptr(), x0.data_ptr(), v0.data_ptr(), target.data_ptr(),
        None if noise is None else noise.data_ptr(),
        None if seeds is None else seeds.data_ptr(), k, h, a, dt, sigma, stage_w, term_w,
        s.data_ptr(), _stream(dev))
    _raise_on(rc, name)
    return s


def _launch_update(name: str, w: Tensor, noise: Optional[Tensor], seeds: Optional[Tensor],
                   h: int, a: int, sigma: float) -> Tensor:
    dev = w.device
    k = w.shape[0]
    tile, blocks, chunks, k_chunk = update_split(k, h, a)
    du = torch.empty((h, a), dtype=torch.float32, device=dev)
    partials = torch.empty((chunks, h * a), dtype=torch.float32, device=dev) if chunks > 1 \
        else None
    rc = _lib().drone_update_launch(
        w.data_ptr(), None if noise is None else noise.data_ptr(),
        None if seeds is None else seeds.data_ptr(), k, h, a, sigma, tile, k_chunk,
        None if partials is None else partials.data_ptr(),
        _tickets(dev, blocks).data_ptr() if chunks > 1 else None, du.data_ptr(), _stream(dev))
    _raise_on(rc, name)
    return du


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def drone_cost(u_prev: Tensor, x0: Tensor, v0: Tensor, target: Tensor, seeds: Tensor,
               n_samples: int, dt: float, sigma: float, stage_w: float,
               term_w: float) -> Tensor:
    """Pass 1 drawing the noise (row 9a): S (K,) of the K = ``n_samples``
    samples u_prev + sigma z, z the Philox stream of ``seeds`` (1,)."""
    _check_cost_inputs(u_prev, x0, v0, target)
    _check(seeds, (1,), u_prev.device, "seeds", torch.int64)
    if u_prev.device.type == "cpu":
        return drone_cost_plain(u_prev, x0, v0, target, seeds, n_samples, dt, sigma, stage_w,
                                term_w)
    s = _launch_cost("drone_cost", u_prev, x0, v0, target, None, seeds, n_samples, dt, sigma,
                     stage_w, term_w)
    graphs.count_launch(drone_cost)
    return s


drone_cost.launches = 0


def drone_cost_noise(u_prev: Tensor, noise: Tensor, x0: Tensor, v0: Tensor, target: Tensor,
                     dt: float, stage_w: float, term_w: float) -> Tensor:
    """Pass 1 on explicit sigma-scaled noise (K, H, A) (row 9c): S (K,)."""
    _check_cost_inputs(u_prev, x0, v0, target)
    _check(noise, (noise.shape[0],) + tuple(u_prev.shape), u_prev.device, "noise")
    if u_prev.device.type == "cpu":
        return drone_cost_noise_plain(u_prev, noise, x0, v0, target, dt, stage_w, term_w)
    s = _launch_cost("drone_cost_noise", u_prev, x0, v0, target, noise, None, noise.shape[0],
                     dt, 0.0, stage_w, term_w)
    graphs.count_launch(drone_cost_noise)
    return s


drone_cost_noise.launches = 0


def drone_update(w: Tensor, seeds: Tensor, n_horizon: int, n_action: int,
                 sigma: float) -> Tensor:
    """Pass 2 drawing the noise again (row 9b): du = sum_k w_k eps_k,
    (H, A), over the stream pass 1 drew from ``seeds``."""
    _check(w, (w.shape[0],), w.device, "w")
    _check(seeds, (1,), w.device, "seeds", torch.int64)
    if w.device.type == "cpu":
        return drone_update_plain(w, seeds, n_horizon, n_action, sigma)
    du = _launch_update("drone_update", w, None, seeds, n_horizon, n_action, sigma)
    graphs.count_launch(drone_update)
    return du


drone_update.launches = 0


def drone_update_noise(noise: Tensor, w: Tensor) -> Tensor:
    """Pass 2 on explicit noise (K, H, A) (row 9d): du (H, A)."""
    _check(w, (w.shape[0],), w.device, "w")
    if noise.ndim != 3:
        raise ValueError(f"noise: expected (K, H, A), got {tuple(noise.shape)}")
    _check(noise, (w.shape[0],) + tuple(noise.shape[1:]), w.device, "noise")
    if w.device.type == "cpu":
        return drone_update_noise_plain(noise, w)
    du = _launch_update("drone_update_noise", w, noise, None, noise.shape[1], noise.shape[2],
                        0.0)
    graphs.count_launch(drone_update_noise)
    return du


drone_update_noise.launches = 0

KERNEL_WRAPPERS = (drone_cost, drone_update, drone_cost_noise, drone_update_noise)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def philox_noise(seeds: Tensor, n_samples: int, n_horizon: int, n_action: int,
                 sigma: float) -> Tensor:
    """The noise (K, H, A) the kernels draw: sigma times the Philox normals
    of solve index 0 under the key in ``seeds`` (1,)."""
    (seed,) = sampling.key_list(seeds)
    z = sampling.philox_normals(seed, 0, n_samples, n_horizon, n_action, seeds.device)
    return (z.permute(2, 1, 0) * sigma).contiguous()


def rollout_cost(u_prev: Tensor, noise: Tensor, x0: Tensor, v0: Tensor, target: Tensor,
                 dt: float, stage_w: float, term_w: float) -> Tensor:
    """S (K,) of the drone preset's rollout and costs on v = u_prev + noise."""
    traj, _ = integrators.double_integrate(u_prev[None] + noise, x0, v0, dt)
    return (costs_mod.position_stage_cost(traj, target, stage_w)
            + costs_mod.position_terminal_cost(traj, target, term_w))


def drone_cost_plain(u_prev: Tensor, x0: Tensor, v0: Tensor, target: Tensor, seeds: Tensor,
                     n_samples: int, dt: float, sigma: float, stage_w: float,
                     term_w: float) -> Tensor:
    """Plain version of :func:`drone_cost`."""
    noise = philox_noise(seeds, n_samples, *u_prev.shape, sigma)
    return rollout_cost(u_prev, noise, x0, v0, target, dt, stage_w, term_w)


def drone_cost_noise_plain(u_prev: Tensor, noise: Tensor, x0: Tensor, v0: Tensor,
                           target: Tensor, dt: float, stage_w: float, term_w: float) -> Tensor:
    """Plain version of :func:`drone_cost_noise`."""
    return rollout_cost(u_prev, noise, x0, v0, target, dt, stage_w, term_w)


def drone_update_plain(w: Tensor, seeds: Tensor, n_horizon: int, n_action: int,
                       sigma: float) -> Tensor:
    """Plain version of :func:`drone_update`."""
    return drone_update_noise_plain(philox_noise(seeds, w.shape[0], n_horizon, n_action, sigma),
                                    w)


def drone_update_noise_plain(noise: Tensor, w: Tensor) -> Tensor:
    """Plain version of :func:`drone_update_noise`."""
    return torch.einsum("k,kha->ha", w, noise)


# ---------------------------------------------------------------------------
# The solve
# ---------------------------------------------------------------------------

def solve_drone_cuda(
    u_prev: Tensor,           # (H, A)
    x0: Tensor,               # (A,)
    v0: Tensor,               # (A,)
    target: Tensor,           # (A,)
    seed,                     # (1,) int64 tensor on u_prev's device, or an int
    noise: Optional[Tensor] = None,  # (K, H, A), sigma-scaled: explicit-noise mode
    n_samples: int = 1024,
    n_horizon: int = 32,
    n_action: int = 3,
    dt: float = 0.01,
    lam: float = 0.1,
    sigma: float = 30.0,
    stage_w: float = 100.0,
    term_w: float = 20.0,
    savgol_window: int = 5,
) -> Tensor:
    """One fused MPPI solve on ``u_prev``'s device; returns the updated
    (H, A) plan.  Without ``noise`` the kernels draw it (the production
    mode); with ``noise`` both passes read it.  Any ``n_samples`` >= 1."""
    dev = u_prev.device

    def f32(t):
        return torch.as_tensor(t, dtype=torch.float32, device=dev).contiguous()

    u_prev, x0, v0, target = f32(u_prev), f32(x0), f32(v0), f32(target)
    if tuple(u_prev.shape) != (n_horizon, n_action):
        raise ValueError(f"u_prev is {tuple(u_prev.shape)}, not (n_horizon, n_action) = "
                         f"({n_horizon}, {n_action})")
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    if noise is None:
        keys = sampling.philox_keys(seed, dev)
        s = drone_cost(u_prev, x0, v0, target, keys, n_samples, dt, sigma, stage_w, term_w)
        w = weights_ops.softmin_weights(s, lam)
        du = drone_update(w, keys, n_horizon, n_action, sigma)
    else:
        noise = f32(noise)
        if tuple(noise.shape) != (n_samples, n_horizon, n_action):
            raise ValueError(f"noise is {tuple(noise.shape)}, not (n_samples, n_horizon, "
                             f"n_action) = ({n_samples}, {n_horizon}, {n_action})")
        s = drone_cost_noise(u_prev, noise, x0, v0, target, dt, stage_w, term_w)
        w = weights_ops.softmin_weights(s, lam)
        du = drone_update_noise(noise, w)
    if savgol_window:
        du = device_const(savgol.savgol_matrix(n_horizon, savgol_window, 2), du) @ du
    return u_prev + du
