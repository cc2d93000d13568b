"""The packed serving wire format (all float32), as the port's
``solver/serving.py`` reads it:

``obs_vec`` (27,): [0:3] base world position, [3:7] base quaternion wxyz
(body->world), [7:14] arm q, [14:17] base world velocity, [17:20] base body
rates, [20:27] arm qdot.

``target_vec`` (10,): [EE position (3), EE quaternion wxyz (4), base
station-keeping target (3)].
"""

from __future__ import annotations

import torch

from ..models.multirotor import Multirotor12State
from ..models.whole_body import WholeBodyState
from ..utils import rotations as rot
from ..utils.pose import Pose
from . import whole_body as wbs

Tensor = torch.Tensor


def unpack_obs(obs_vec: Tensor, target_vec: Tensor) -> "wbs.WholeBodyObs":
    """(obs_vec, target_vec) -> WholeBodyObs, on the vectors' device."""
    quat = rot.quat_normalize(obs_vec[3:7])
    ang = rot.matrix_to_euler(rot.quat_to_matrix(quat), "ZYX")
    base = Multirotor12State(
        pos=obs_vec[0:3], rpy=torch.stack([ang[2], ang[1], ang[0]]),
        vel=obs_vec[14:17], omega=obs_vec[17:20],
    )
    return wbs.WholeBodyObs(
        state=WholeBodyState(base=base, q=obs_vec[7:14], qdot=obs_vec[20:27]),
        ee_target=Pose(position=target_vec[0:3],
                       quat=rot.quat_normalize(target_vec[3:7])),
        base_target=target_vec[7:10],
    )
