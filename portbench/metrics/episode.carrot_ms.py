"""episode.carrot_ms: device ms per control step of the base command (the
position mode's smooth carrot along the plan). The mean over the stamped
slice's calls of the port's marks ``wb_loop.carrot`` -> ``wb_loop.tick``
(``%globaltimer`` on the card, ``stamped.py``); None where either mark is
missing."""

from portbench import stamped


def read(ctx):
    st = stamped.of(ctx)
    return None if st is None else st.stage_ms("wb_loop.carrot", "wb_loop.tick")
