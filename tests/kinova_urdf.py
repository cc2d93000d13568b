"""The Kinova j2s7s300 arm as URDF text, built from the joint table of
``tests/test_kinematics.py``'s FK oracle: the inverted world mount (a fixed
joint, rpy (pi, 0, 0)), the seven revolute joints with the arm model's
limits, the fixed end-effector frame, and the links' inertials.  The URDF
loaders of both packages read it in the tests, and ``chip_smoke.py`` reads
it on the card; it needs NumPy only.

    text = kinova_urdf_text(kinova)   # either package's models.kinova
"""

import numpy as np

PI = float(np.pi)

# (xyz, rpy) of joints 1..7 (tests/test_kinematics.py's fk_oracle table).
JOINT_ORIGINS = (
    ((0, 0, 0.15675), (0, PI, 0)),
    ((0, 0.0016, -0.11875), (-PI / 2, 0, PI)),
    ((0, -0.205, 0), (-PI / 2, 0, 0)),
    ((0, 0, -0.205), (PI / 2, 0, PI)),
    ((0, 0.2073, -0.0114), (-PI / 2, 0, PI)),
    ((0, 0, -0.10375), (PI / 2, 0, PI)),
    ((0, 0.10375, 0), (-PI / 2, 0, PI)),
)
MOUNT_RPY = (PI, 0, 0)
END_EFFECTOR = ((0, 0, -0.16), (PI, 0, PI / 2))
ROOT, LINK_7, TIP = "world", "j2s7s300_link_7", "j2s7s300_end_effector"


def _v(xs) -> str:
    return " ".join(repr(float(x)) for x in xs)


def kinova_urdf_text(kinova) -> str:
    """URDF of the arm, its limits and inertials from ``kinova`` (a
    ``models/kinova`` module: ``JOINT_LOWER``, ``JOINT_UPPER``,
    ``JOINT_VELOCITY``, ``JOINT_EFFORT``, ``inertials()``)."""
    inert = kinova.inertials()
    parts = ['<robot name="j2s7s300">', f'  <link name="{ROOT}"/>',
             '  <link name="j2s7s300_link_base"/>',
             '  <joint name="connect_root_and_world" type="fixed">',
             f'    <parent link="{ROOT}"/>', '    <child link="j2s7s300_link_base"/>',
             f'    <origin xyz="0 0 0" rpy="{_v(MOUNT_RPY)}"/>', '  </joint>']
    parent = "j2s7s300_link_base"
    for j, (xyz, rpy) in enumerate(JOINT_ORIGINS):
        link = f"j2s7s300_link_{j + 1}"
        i = inert.inertia[j]
        parts += [
            f'  <link name="{link}">', '    <inertial>',
            f'      <mass value="{float(inert.mass[j])!r}"/>',
            f'      <origin xyz="{_v(inert.com[j])}" rpy="0 0 0"/>',
            f'      <inertia ixx="{float(i[0, 0])!r}" ixy="{float(i[0, 1])!r}" '
            f'ixz="{float(i[0, 2])!r}" iyy="{float(i[1, 1])!r}" iyz="{float(i[1, 2])!r}" '
            f'izz="{float(i[2, 2])!r}"/>',
            '    </inertial>', '  </link>',
            f'  <joint name="j2s7s300_joint_{j + 1}" type="revolute">',
            f'    <parent link="{parent}"/>', f'    <child link="{link}"/>',
            f'    <origin xyz="{_v(xyz)}" rpy="{_v(rpy)}"/>', '    <axis xyz="0 0 1"/>',
            f'    <limit lower="{float(kinova.JOINT_LOWER[j])!r}" '
            f'upper="{float(kinova.JOINT_UPPER[j])!r}" '
            f'velocity="{float(kinova.JOINT_VELOCITY[j])!r}" '
            f'effort="{float(kinova.JOINT_EFFORT[j])!r}"/>',
            '  </joint>']
        parent = link
    parts += [f'  <link name="{TIP}"/>',
              '  <joint name="j2s7s300_joint_end_effector" type="fixed">',
              f'    <parent link="{LINK_7}"/>', f'    <child link="{TIP}"/>',
              f'    <origin xyz="{_v(END_EFFECTOR[0])}" rpy="{_v(END_EFFECTOR[1])}"/>',
              '  </joint>', '</robot>']
    return "\n".join(parts) + "\n"
