"""Generic URDF -> ChainSpec loader (host-side, stdlib XML only).

A copy of the JAX package's ``models/urdf.py`` on this package's
:class:`~.chain.ChainSpec` and :class:`~.rigid_body.InertialParams`: load a
URDF, pick a root and tip link, walk the joint chain, and produce a
batched-FK-ready model.  Parsing happens once on the host with
``xml.etree``; fixed joints are folded into the following actuated joint's
origin (or into the tip transform), so the FK touches only actuated joints.

    spec, inertials = load_chain("arm.urdf", "world", "j2s7s300_link_7")
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Optional, Tuple

import numpy as np

from .chain import PRISMATIC, REVOLUTE, ChainSpec, build_chain, rpy_to_matrix_np
from .rigid_body import InertialParams


def _floats(s: Optional[str], default=(0.0, 0.0, 0.0)):
    if s is None:
        return list(default)
    return [float(x) for x in s.split()]


class Urdf:
    """Parsed URDF with chain-extraction helpers."""

    def __init__(self, root: ET.Element):
        self.root = root
        self.joints: Dict[str, ET.Element] = {}
        self.parent_of_link: Dict[str, str] = {}  # child link -> joint name
        for j in root.findall("joint"):
            name = j.get("name")
            self.joints[name] = j
            child = j.find("child").get("link")
            self.parent_of_link[child] = name

    @classmethod
    def from_file(cls, path: str) -> "Urdf":
        return cls(ET.parse(path).getroot())

    @classmethod
    def from_string(cls, text: str) -> "Urdf":
        return cls(ET.fromstring(text))

    def chain_joints(self, root_link: str, tip_link: str):
        """Joints on the path root_link -> tip_link, root-first."""
        path = []
        link = tip_link
        while link != root_link:
            jname = self.parent_of_link.get(link)
            if jname is None:
                raise ValueError(
                    f"no path from {root_link!r} to {tip_link!r} (stuck at {link!r})"
                )
            j = self.joints[jname]
            path.append(j)
            link = j.find("parent").get("link")
        return list(reversed(path))

    def build_chain(self, root_link: str, tip_link: str) -> ChainSpec:
        """Compile the root->tip chain, folding fixed joints away."""
        joints = self.chain_joints(root_link, tip_link)

        # Pending fixed transform accumulated since the last actuated joint.
        acc_r, acc_t = np.eye(3), np.zeros(3)
        axes, types, lo, hi, vel, eff, names = ([] for _ in range(7))
        origin_rots, origin_trans = [], []

        def origin_of(j):
            o = j.find("origin")
            if o is None:
                return np.eye(3), np.zeros(3)
            return (
                rpy_to_matrix_np(_floats(o.get("rpy"))),
                np.asarray(_floats(o.get("xyz")), np.float64),
            )

        for j in joints:
            jr, jt = origin_of(j)
            # Compose pending fixed transform with this joint's origin.
            r = acc_r @ jr
            t = acc_t + acc_r @ jt
            jtype = j.get("type")
            if jtype == "fixed":
                acc_r, acc_t = r, t
                continue
            if jtype in ("revolute", "continuous"):
                types.append(REVOLUTE)
            elif jtype == "prismatic":
                types.append(PRISMATIC)
            else:
                raise ValueError(f"unsupported joint type {jtype!r}")
            origin_rots.append(r)
            origin_trans.append(t)
            acc_r, acc_t = np.eye(3), np.zeros(3)

            ax = j.find("axis")
            axes.append(_floats(ax.get("xyz") if ax is not None else None, (1, 0, 0)))
            lim = j.find("limit")
            if jtype == "continuous" or lim is None:
                lo.append(-np.inf)
                hi.append(np.inf)
                vel.append(np.inf)
                eff.append(np.inf)
            else:
                lo.append(float(lim.get("lower", "-inf")))
                hi.append(float(lim.get("upper", "inf")))
                vel.append(float(lim.get("velocity", "inf")))
                eff.append(float(lim.get("effort", "inf")))
            names.append(j.get("name"))

        if not types:
            raise ValueError("chain has no actuated joints")

        # build_chain composes origins from rpy/xyz; the origins here are
        # matrices already (fixed joints folded in), so build the spec directly.
        spec = build_chain(
            origins_xyz=[[0.0, 0.0, 0.0]] * len(types),
            origins_rpy=[[0.0, 0.0, 0.0]] * len(types),
            axes=axes,
            joint_types=types,
            lower=lo,
            upper=hi,
            velocity=vel,
            effort=eff,
            joint_names=names,
        )
        # Trailing fixed joints become the tip transform.
        return ChainSpec(
            origin_rot=np.stack(origin_rots),
            origin_trans=np.stack(origin_trans),
            axis=spec.axis,
            joint_type=spec.joint_type,
            lower=spec.lower,
            upper=spec.upper,
            velocity=spec.velocity,
            effort=spec.effort,
            tip_rot=acc_r,
            tip_trans=acc_t,
            joint_names=spec.joint_names,
        )

    def build_inertials(self, root_link: str, tip_link: str) -> InertialParams:
        """Inertials of each actuated joint's child link along the chain.

        URDF inertia tensors are specified about the COM in an optionally
        rotated frame; they are rotated into the link frame.  The masses of
        links hung on fixed joints along the chain are ignored, as in the
        JAX loader (only the actuated links 1..7 matter for the arm).
        """
        links = {l.get("name"): l for l in self.root.findall("link")}
        joints = self.chain_joints(root_link, tip_link)
        mass, com, inertia = [], [], []
        for j in joints:
            if j.get("type") == "fixed":
                continue
            child = j.find("child").get("link")
            inert = links[child].find("inertial")
            if inert is None:
                mass.append(0.0)
                com.append(np.zeros(3))
                inertia.append(np.zeros((3, 3)))
                continue
            m = float(inert.find("mass").get("value"))
            o = inert.find("origin")
            c = np.asarray(_floats(o.get("xyz")) if o is not None else [0, 0, 0])
            r = rpy_to_matrix_np(_floats(o.get("rpy")) if o is not None else [0, 0, 0])
            ie = inert.find("inertia")
            i_local = np.array(
                [
                    [float(ie.get("ixx")), float(ie.get("ixy", "0")), float(ie.get("ixz", "0"))],
                    [float(ie.get("ixy", "0")), float(ie.get("iyy")), float(ie.get("iyz", "0"))],
                    [float(ie.get("ixz", "0")), float(ie.get("iyz", "0")), float(ie.get("izz"))],
                ]
            )
            mass.append(m)
            com.append(c)
            inertia.append(r @ i_local @ r.T)
        return InertialParams(
            mass=np.asarray(mass), com=np.stack(com), inertia=np.stack(inertia)
        )


def load_chain(path: str, root_link: str, tip_link: str) -> Tuple[ChainSpec, InertialParams]:
    u = Urdf.from_file(path)
    return u.build_chain(root_link, tip_link), u.build_inertials(root_link, tip_link)
