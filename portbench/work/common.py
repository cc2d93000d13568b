"""Costs shared by the stage work counts, each stated once.

Operations are counted as float32 operations (an add, a multiply, a
compare; a fused multiply-add counts two).  A transcendental (sin, cos,
exp, log, sqrt, a division) counts :data:`TRANSCENDENTAL`.  One normal
drawn counts :data:`DRAW`, whatever generator draws it: a quarter of one
Philox4x32-10 block (10 rounds of 2 multiplies giving high and low words,
2 xors and 2 key additions: 100 integer operations for 4 words, so 25 per
word) and the inverse-CDF transform of one 32-bit word (shift, convert,
scale, and an ``erfinv`` of 22 operations: 25).  These are the algorithm's
costs, not any kernel's: a generator that draws more words per block, or a
transform that is cheaper, reads a higher share, never above 100%.
"""

TRANSCENDENTAL = 4
DRAW = 50
FLOAT = 4  # bytes
