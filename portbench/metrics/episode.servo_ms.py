"""episode.servo_ms: device ms per control step of the arm servo (pose error
Jacobian, damped least squares, joint stops). The mean over the stamped
slice's calls of the port's marks ``wb_loop.servo`` ->
``wb_loop.arm_dynamics`` (``%globaltimer`` on the card, ``stamped.py``);
None where either mark is missing."""

from portbench import stamped


def read(ctx):
    st = stamped.of(ctx)
    return None if st is None else st.stage_ms("wb_loop.servo", "wb_loop.arm_dynamics")
