"""solver.tail_ms: device ms per call from the update kernel's end to the
graph's last op: the update tail (smoothing, clamp, warm start), the
setpoints, the reply and the carry copy. The mean over the stamped slice's
calls of the port's marks ``solve.tail`` -> ``graph.end`` (``%globaltimer``
on the card, ``stamped.py``); None where either mark is missing."""

from portbench import stamped


def read(ctx):
    st = stamped.of(ctx)
    return None if st is None else st.stage_ms("solve.tail", "graph.end")
