"""episode.arm_ms: device ms per control step of the arm's tracking torque
(frozen coefficients or the mass matrix and nonlinear effects). The mean
over the stamped slice's calls of the port's marks ``wb_loop.arm_dynamics``
-> ``wb_loop.carrot`` (``%globaltimer`` on the card, ``stamped.py``); None
where either mark is missing."""

from portbench import stamped


def read(ctx):
    st = stamped.of(ctx)
    return None if st is None else st.stage_ms("wb_loop.arm_dynamics", "wb_loop.carrot")
