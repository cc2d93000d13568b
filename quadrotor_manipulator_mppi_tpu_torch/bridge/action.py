"""Actionlib-style task interface over the QMM bridge.

The reference names "Apply ROS Action (Planning scenario)" as future work
(the reference README, ``README.md:30-34``); this module supplies that capability
for the solver bridge with the same semantics ROS actionlib defines — a goal is
submitted, streams feedback while active, terminates in exactly one result
(SUCCEEDED / ABORTED / PREEMPTED / CANCELED), and a newer goal preempts the
active one.  Transport is three QMM frame types (``protocol.MsgType.ACTION_*``)
so any peer of the bridge (C++ tools, a Gazebo adapter, another process) can
drive missions without ROS.

Tasks map onto the solver session's targets:

* ``EE_REACH`` — set the arm MPPI end-effector target (through the
  session's ``set_ee_position``, which writes the host target that every
  request copies into the solver's input buffer); succeeds when the
  measured EE position error (L1, the reference's reach metric
  ``mppi.py:117``) stays under ``reach_tol`` for ``hold_ticks`` states.
* ``WAYPOINT`` — set the drone MPPI position target; L2 tolerance.
* ``LAND`` — engage the landing behavior (teleop code 9 equivalent);
  succeeds below ``land_alt``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional

import numpy as np

from . import protocol as proto


class ActionStatus(IntEnum):
    PENDING = 0
    ACTIVE = 1
    PREEMPTED = 2
    SUCCEEDED = 3
    ABORTED = 4
    CANCELED = 5


class Task(IntEnum):
    EE_REACH = 1   # params: xyz target (3 floats; world frame)
    WAYPOINT = 2   # params: xyz target (3 floats)
    LAND = 3       # params: none


@dataclass
class Goal:
    goal_id: int
    task: Task
    params: List[float]
    status: ActionStatus = ActionStatus.ACTIVE
    ticks: int = 0
    ticks_in_tol: int = 0


def goal_frame(goal_id: int, task: Task, params=()) -> proto.Frame:
    """Client-side helper: build an ACTION_GOAL frame."""
    return proto.Frame(
        proto.MsgType.ACTION_GOAL,
        [float(goal_id), float(int(task))] + [float(p) for p in params],
    )


def cancel_frame(goal_id: int) -> proto.Frame:
    return proto.Frame(proto.MsgType.ACTION_CANCEL, [float(goal_id)])


@dataclass
class ActionManager:
    """One active goal per session (actionlib's simple-action-server model).

    The owning session calls :meth:`handle_goal` / :meth:`handle_cancel` on
    the matching frames and :meth:`on_tick` once per ROBOT_STATES frame with
    the measured errors; every call returns the protocol frames to send.
    """

    reach_tol: float = 0.005      # L1 m, reference reach criterion (mppi.py:117)
    waypoint_tol: float = 0.05    # L2 m
    land_alt: float = 0.06        # m
    hold_ticks: int = 50          # reference's convergence gate (kinova.py:154-157)
    feedback_every: int = 10      # ticks between ACTION_FEEDBACK frames
    timeout_ticks: int = 0        # 0 = no timeout; else ABORTED past this
    active: Optional[Goal] = None

    def handle_goal(self, payload: List[float], session) -> List[proto.Frame]:
        out: List[proto.Frame] = []
        if len(payload) < 2:
            return out
        goal = Goal(goal_id=int(payload[0]), task=Task(int(payload[1])),
                    params=list(payload[2:]))
        if self.active is not None and self.active.status == ActionStatus.ACTIVE:
            self.active.status = ActionStatus.PREEMPTED
            out.append(self._result(self.active))
        self._apply(goal, session)
        self.active = goal
        out.append(proto.Frame(
            proto.MsgType.ACTION_FEEDBACK,
            [float(goal.goal_id), float(ActionStatus.ACTIVE), float("nan")],
        ))
        return out

    def handle_cancel(self, payload: List[float], session) -> List[proto.Frame]:
        if (
            self.active is None
            or self.active.status != ActionStatus.ACTIVE
            or (payload and int(payload[0]) != self.active.goal_id)
        ):
            return []
        self.active.status = ActionStatus.CANCELED
        if self.active.task == Task.LAND:
            session.land = False
        return [self._result(self.active)]

    def on_tick(self, ee_err_l1: float, base_pos: np.ndarray) -> List[proto.Frame]:
        goal = self.active
        if goal is None or goal.status != ActionStatus.ACTIVE:
            return []
        goal.ticks += 1
        if goal.task == Task.EE_REACH:
            err, tol = float(ee_err_l1), self.reach_tol
        elif goal.task == Task.WAYPOINT:
            err = float(np.linalg.norm(np.asarray(base_pos) - goal.params[:3]))
            tol = self.waypoint_tol
        else:  # LAND
            err, tol = float(base_pos[2]), self.land_alt

        out: List[proto.Frame] = []
        goal.ticks_in_tol = goal.ticks_in_tol + 1 if err < tol else 0
        hold = 1 if goal.task == Task.LAND else self.hold_ticks
        if goal.ticks_in_tol >= hold:
            goal.status = ActionStatus.SUCCEEDED
            out.append(self._result(goal, err))
        elif self.timeout_ticks and goal.ticks > self.timeout_ticks:
            goal.status = ActionStatus.ABORTED
            out.append(self._result(goal, err))
        elif goal.ticks % self.feedback_every == 0:
            out.append(proto.Frame(
                proto.MsgType.ACTION_FEEDBACK,
                [float(goal.goal_id), float(ActionStatus.ACTIVE), err],
            ))
        return out

    def _apply(self, goal: Goal, session) -> None:
        if goal.task == Task.EE_REACH:
            if len(goal.params) < 3:
                goal.status = ActionStatus.ABORTED
                return
            session.set_ee_position(goal.params[:3])
        elif goal.task == Task.WAYPOINT:
            if len(goal.params) < 3:
                goal.status = ActionStatus.ABORTED
                return
            session.drone_target = np.asarray(goal.params[:3], np.float32)
        elif goal.task == Task.LAND:
            session.land = True

    @staticmethod
    def _result(goal: Goal, err: float = float("nan")) -> proto.Frame:
        return proto.Frame(
            proto.MsgType.ACTION_RESULT,
            [float(goal.goal_id), float(goal.status), err],
        )
