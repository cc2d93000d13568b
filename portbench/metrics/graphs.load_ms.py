"""graphs.load_ms: host ms per call in the port's span ``graphs.load``: the
argument structure checked and the arguments copied into the graph's static
buffers. The mean over the stamped slice's calls (host clock, no profiler;
``stamped.py``); None where the span is missing."""

from portbench import stamped


def read(ctx):
    st = stamped.of(ctx)
    return None if st is None else st.span_ms("graphs.load")
