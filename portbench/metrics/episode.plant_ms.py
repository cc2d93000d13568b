"""episode.plant_ms: device ms per control step of the plant's control period
(the plant kernel with its packing, or the substeps). The mean over the
stamped slice's calls of the port's marks ``wb_loop.tick`` ->
``wb_loop.logs`` (``%globaltimer`` on the card, ``stamped.py``); None where
either mark is missing."""

from portbench import stamped


def read(ctx):
    st = stamped.of(ctx)
    return None if st is None else st.stage_ms("wb_loop.tick", "wb_loop.logs")
