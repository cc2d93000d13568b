"""CUDA-graph capture and replay of a step function: the port's
counterpart of ``jax.jit`` for the serving solve and the episode's control
step.

A step of the port is a few hundred small eager ops (the solve) or a few
thousand (a control step), each costing the host several microseconds to
enqueue, while the card is busy for well under a millisecond of them.
:func:`graphed` captures one call of the step in a CUDA graph, on static
copies of its arguments, and replays it: one launch of the host's per call.

* It warms up on a side stream first.  Device constants are created on
  their first use (``utils.device.device_const``, ``ops.sampling`` keys)
  by a pageable host-to-device copy, which a capture cannot hold; library
  handles and workspaces are created there too.
* It captures one call of ``fn`` on static copies of the first call's
  arguments; what ``fn`` writes in place into them (a carry, a step
  counter, log rows) is written on every replay.  A later call copies its
  arguments into those buffers (a buffer passed back in is not copied)
  and replays; arguments of another structure get a graph of their own.
* A capture or a replay that fails raises.  There is no fallback to the
  eager call: a path that cannot be captured is a fault to repair.
* ``capture_error_mode`` is the capture's ``cudaStreamCaptureMode``
  (``torch.cuda.graph``'s argument).  The default, ``"global"``, fails the
  capture when any thread of the process makes a call that is unsafe
  during a capture (an allocation, a synchronizing copy).  A step that
  takes every input from its own static buffers and may be captured while
  other threads use the card (the bridge's session heads, beside a plant
  or another server) passes ``"thread_local"``: only its own thread is
  then held to the rule.
* The kernel wrappers count their launches on the host, once per call,
  through :func:`count_launch`; a replay runs no Python.  So a capture
  tallies the calls its own thread makes during its host pass, which
  launches nothing: they are taken back off the counters, and added to
  them again on every replay.  Another thread's launches during the
  capture count as that thread's.
* With a tracer installed (``utils.profiling.tracing``) a capture holds
  the marks ``graph.begin`` before ``fn`` and ``graph.end`` after it, the
  warm-up and the capture run in the span ``graphs.capture`` (counted in
  the tracer's ``captures`` and ``capture_s``), and :meth:`GraphedStep.load`
  and :meth:`GraphedStep.replay` run in the spans ``graphs.load`` and
  ``graphs.replay``.  Without one, the graph holds ``fn``'s nodes alone.

:func:`episode_step` and :func:`run_episode` are the episode runner the
whole-body, drone and arm episodes share: one control step captured on the
carry's static buffers, the log rows written at a device step index, one
replay per step.  :func:`episode_runner` wraps them, with the eager loop
beside them, for the arm episode and the scenario episodes (perfect-model,
fixed-wing, mapped flight).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict

import torch

from . import profiling

Tensor = torch.Tensor

_CAPTURE = threading.local()  # .tally: {wrapper: calls} of this thread's capture


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel (each ``ops.cuda`` wrapper calls
    this where it launches): on its ``launches`` counter, and in the tally
    of the capture this thread is running, if any."""
    wrapper.launches += 1
    tally = getattr(_CAPTURE, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1


def copy_into(dst: Any, src: Any) -> None:
    """Copy the tensors of the pytree ``src`` into those of ``dst`` (same
    structure: tensors, tuples, NamedTuples, None), skipping a tensor that
    is already ``dst``'s."""
    if isinstance(dst, Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            copy_into(d, s)
    elif dst is not None:
        raise TypeError(f"not a tensor tree: {type(dst).__name__}")


def shapes(tree: Any) -> Any:
    """The (shape, dtype) of every tensor of the pytree ``tree``, nested as
    the tree is."""
    if isinstance(tree, Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, (tuple, list)):
        return tuple(shapes(x) for x in tree)
    return tree


def clone_tree(tree: Any, device=None) -> Any:
    """A copy of the pytree ``tree`` with every tensor cloned (onto
    ``device`` if given)."""
    if isinstance(tree, Tensor):
        return tree.clone() if device is None else tree.to(device, copy=True)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(x, device) for x in tree)
    return tree


class GraphedStep:
    """``fn(*args)`` captured once in a CUDA graph on static copies of
    ``args`` (:attr:`args`); :meth:`replay` runs it again.

    ``fn`` reads and writes its arguments (the static buffers) and may
    return tensors, which become the graph's static outputs (:attr:`out`,
    overwritten by every replay).  ``warmup`` eager calls run first on a
    side stream, on the static buffers; they are real launches and count
    as such.  :meth:`load` copies new arguments into the buffers."""

    def __init__(self, fn: Callable[..., Any], device, *args, warmup: int = 2,
                 capture_error_mode: str = "global"):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        # The graph's marks write into this tracer's ring: it lives as long.
        self._tracer = tracer = profiling.current()
        t0 = time.perf_counter()
        with profiling.span("graphs.capture"):
            self._capture(fn if tracer is None else _stamped(fn), device, args, warmup,
                          capture_error_mode)
        if tracer is not None:
            tracer.captures += 1
            tracer.capture_s += time.perf_counter() - t0

    def _capture(self, fn, device, args, warmup: int, capture_error_mode: str) -> None:
        self.args = clone_tree(args, device)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn(*self.args)
        current.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        _CAPTURE.tally = tally = {}
        try:
            # Captured on its own stream: torch.cuda.graph's default capture
            # stream is one per process, which two threads capturing at
            # once would share.
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode=capture_error_mode):
                self.out = fn(*self.args)
        except Exception as exc:
            raise RuntimeError(f"CUDA graph capture failed: {exc}") from exc
        finally:
            _CAPTURE.tally = None
            for w, n in tally.items():
                w.launches -= n
        self._per_replay = list(tally.items())

    @property
    def launches_per_replay(self) -> dict:
        """{wrapper name: kernel launches in one replay}."""
        return {w.__name__: n for w, n in self._per_replay}

    def load(self, *args) -> "GraphedStep":
        """Copy ``args`` (the capture's structure) into the static buffers."""
        with profiling.span("graphs.load"):
            if shapes(args) != shapes(self.args):
                raise ValueError(f"this graph was captured for {shapes(self.args)}, "
                                 f"got {shapes(args)}")
            copy_into(self.args, args)
        return self

    def replay(self) -> Any:
        """Replay the graph once; returns :attr:`out`."""
        with profiling.span("graphs.replay"):
            self.graph.replay()
        for w, n in self._per_replay:
            w.launches += n
        return self.out


def _stamped(fn: Callable[..., Any]) -> Callable[..., Any]:
    """``fn`` between the marks ``graph.begin`` and ``graph.end``."""
    def stamped(*args):
        profiling.mark("graph.begin")
        out = fn(*args)
        profiling.mark("graph.end")
        return out

    return stamped


def graphed(fn: Callable[..., Any], device, warmup: int = 2,
            capture_error_mode: str = "global") -> Callable[..., GraphedStep]:
    """``load(*args)``: the :class:`GraphedStep` of ``fn`` for the structure
    of ``args`` (captured at its first call), with ``args`` loaded into its
    static buffers, ready to :meth:`~GraphedStep.replay`."""
    cache: Dict[Any, GraphedStep] = {}

    def load(*args) -> GraphedStep:
        key = shapes(args)
        if key not in cache:
            cache[key] = GraphedStep(fn, device, *args, warmup=warmup,
                                     capture_error_mode=capture_error_mode)
        return cache[key].load(*args)

    return load


def require_tensors(tree: Any, what: str, path: str = "") -> None:
    """Raise unless every leaf of the pytree ``tree`` is a tensor (or None):
    a Python number in a graph's carry would be frozen into the capture."""
    if isinstance(tree, Tensor) or tree is None:
        return
    if isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", range(len(tree)))
        for name, x in zip(names, tree):
            require_tensors(x, what, f"{path}.{name}")
        return
    raise TypeError(f"{what}{path} is a {type(tree).__name__}, not a tensor: a graph "
                    f"would freeze it")


def episode_step(control_step: Callable[[Any, Any], tuple]) -> Callable[..., None]:
    """The captured body of an episode: ``control_step(carry, z_i) ->
    (carry, log_row)`` becomes ``one_step(carry, z, index, logs)``, which
    reads ``z[index]`` (``z`` None: no explicit noise), updates ``carry`` in
    place, writes each field of the log row into its (n_steps, ...) buffer
    at the device step index, and advances the index.  The row index is
    clamped to the last row: the capture's warm-up calls advance it past
    the end of an episode shorter than they are (their writes are
    discarded when the buffers are loaded)."""
    def one_step(carry, z, index, logs):
        row_index = index.clamp(max=logs[0].shape[0] - 1)
        zi = None if z is None else z.index_select(0, row_index)[0]
        new_carry, row = control_step(carry, zi)
        copy_into(carry, new_carry)
        for buf, x in zip(logs, row):
            buf.index_copy_(0, row_index, x.unsqueeze(0))
        index.add_(1)

    return one_step


def run_episode(load: Callable[..., GraphedStep], carry: Any, z: Any, logs: Any,
                n_steps: int) -> tuple:
    """Replay the graph of ``episode_step`` (``load = graphed(one_step,
    device)``) ``n_steps`` times from ``carry``, the logs written into the
    preallocated ``logs`` buffers.  Returns copies of the final carry and of
    the log buffers."""
    require_tensors(carry, "the carry")
    index = torch.zeros(1, dtype=torch.int64, device=logs[0].device)
    g = load(carry, z, index, logs)
    for _ in range(n_steps):
        g.replay()
    carry, _, _, logs = g.args
    return clone_tree(carry), clone_tree(logs)


def episode_runner(control_step: Callable[[Any, Any], tuple], row_like: Callable[[Any], tuple],
                   n_steps: int, device, graph: bool = True):
    """``run(carry, z=None) -> (final carry, logs)``: ``n_steps`` calls of
    ``control_step(carry, z_i) -> (carry, log_row)``, each log field stacked
    over the steps; ``row_like(carry)`` gives one row's tensors, whose
    shapes and dtypes size the log buffers.  On the card (``graph=True``)
    the first call captures one control step (:func:`episode_step`) and
    every call replays it (:func:`run_episode`: every field of the carry
    must be a tensor; the final carry and the logs are copies).
    ``graph=False``, and the CPU, run the same control step eagerly."""
    dev = torch.device(device)
    load = graphed(episode_step(control_step), dev) if graph and dev.type == "cuda" else None

    def run(carry, z=None):
        if z is not None and len(z) != n_steps:
            raise ValueError(f"z carries {len(z)} steps, the episode {n_steps}")
        if load is not None:
            logs = tuple(torch.zeros((n_steps,) + tuple(x.shape), dtype=x.dtype, device=dev)
                         for x in row_like(carry))
            return run_episode(load, carry, z, logs, n_steps)
        rows = []
        for i in range(n_steps):
            carry, row = control_step(carry, None if z is None else z[i])
            rows.append(row)
        return carry, tuple(torch.stack(f) for f in zip(*rows))

    return run
