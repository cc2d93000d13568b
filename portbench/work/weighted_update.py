"""Stage "softmin-weighted update": from the costs S (K) form the softmin
weights w = exp(-(S - min S) / lambda) / eta and the weighted noise sum
du = sum_k w_k eps_k over the (H, A) rows.

Per scenario: the weights, K * (1 sub + 1 mul + 1 exp + 1 add) and the
minimum, K; du, 2 per noise element (K * H * A multiply-adds).  The noise
is either read (4 bytes per element, written by the rollout) or drawn
again (``common.DRAW`` per element): both options are listed and the
harness takes the cheaper at the peaks, so no implementation can read
over 100%.  Bytes besides: S read once (K), du written once (H * A).
"""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_work_common",
                                               Path(__file__).with_name("common.py"))
c = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(c)

KERNELS = ("wb_update_kernel",)


def work(shape: dict) -> list:
    b, k, h, a = shape["B"], shape["K"], shape["H"], shape["A"]
    n = k * h * a
    base_flops = b * (k * (3 + c.TRANSCENDENTAL) + k + 2 * n)
    base_bytes = b * c.FLOAT * (k + h * a)
    return [{"flops": base_flops, "bytes": base_bytes + b * c.FLOAT * n},   # read the noise
            {"flops": base_flops + b * n * c.DRAW, "bytes": base_bytes}]    # draw it again
