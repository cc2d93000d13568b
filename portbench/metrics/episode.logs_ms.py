"""episode.logs_ms: device ms per control step of the logs: their FK, the log-
row writes and the step index. The mean over the stamped slice's calls of
the port's marks ``wb_loop.logs`` -> ``graph.end`` (``%globaltimer`` on the
card, ``stamped.py``); None where either mark is missing."""

from portbench import stamped


def read(ctx):
    st = stamped.of(ctx)
    return None if st is None else st.stage_ms("wb_loop.logs", "graph.end")
