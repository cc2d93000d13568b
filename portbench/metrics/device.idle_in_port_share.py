"""device.idle_in_port_share: of the card's idle time between one call's
``graph.end`` mark and the next call's ``graph.begin`` (on the host clock
through the tracer's calibration), the share in % in which one of the port's
host spans (``graphs.load``, ``graphs.replay``, ``serving.reply``) was open;
the rest is the caller's (``stamped.py``)."""

from portbench import stamped


def read(ctx):
    st = stamped.of(ctx)
    return None if st is None else st.idle_in_port_share()
