"""graphs.capture_s: host s in the port's span ``graphs.capture`` for the
stamped slice's step (its warm-up calls and ``torch.cuda.graph``), from the
tracer's ``capture_s`` (``stamped.py``); None without a capture."""

from portbench import stamped


def read(ctx):
    st = stamped.of(ctx)
    return None if st is None else st.capture_s()
