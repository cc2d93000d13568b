"""The plain reference of the benchmark's cells.

``frozen/`` is a snapshot of the port's plain PyTorch modules that the
cells' timed paths are held against: the whole-body solve's plain pipeline
(``solver/mppi.make_step`` over ``solver/whole_body.rollout_cost_fns``),
the Philox4x32-10 normal draw (``ops/sampling``), the packed wire format
(``solver/serving.unpack_obs``) and the closed loop's eager control step
(``sim/whole_body_loop``: the tube servo, the carrot, the frozen-coefficient
plant substeps and the per-substep RNEA plant).  The files are copied and
cut to what the reference runs (the plain pipeline, the eager free-flight
loop); their imports are relative, so they import nothing of the port.
The snapshot does not follow later changes of the port: it is the
yardstick, and only a benchmark change may edit it.  Since it began as a
copy of the port, ``tests/test_portbench_reference_jax.py`` holds it
against the JAX package, an implementation written apart from the port, on
shared noise.

:mod:`.solve` drives the snapshot: one solve from a given warm start, Philox
key and solve index, and the control steps of an episode from a given
start or from a given state.  It runs in any dtype; the check runs it in
float64.
"""
