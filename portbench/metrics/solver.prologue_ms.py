"""solver.prologue_ms: device ms per call from the graph's first op to the cost
kernel: the observation unpack, the sigma schedule's FK and the scalar pack.
The mean over the stamped slice's calls of the port's marks ``graph.begin``
-> ``solve.cost`` (``%globaltimer`` on the card, ``stamped.py``); None where
either mark is missing."""

from portbench import stamped


def read(ctx):
    st = stamped.of(ctx)
    return None if st is None else st.stage_ms("graph.begin", "solve.cost")
