"""One run of one cell: set up, warm up, measure for ``--seconds``, check.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``); the
mix's ``driver`` picks the entry point (``drivers.py``).  With ``--trace 0``
the result's metrics are the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, read by ``metrics/<name>.py`` from a traced slice
that follows the window.  The last line of standard output is the result,
a JSON object; the numbers compared by the check close standard error.
``--stand-in control`` (TF32), ``control-bf16`` or ``fault:<name>`` puts
the plain reference in the program's place (the controls and the planted
faults that the limits were set against); the benchmark's own runs never
pass it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "quadrotor_manipulator_mppi_tpu")
CACHE = HERE / "out" / "cache"


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least q% of all values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def read_json(path: Path) -> dict:
    if not path.exists():
        raise SystemExit(f"missing {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}")
    return json.loads(path.read_text())


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix and limits."""

    def __init__(self, name: str):
        self.bench = read_json(ROOT / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"unknown workload {name!r}; one of {sorted(entries)}")
        self.name, self.entry = name, entries[name]
        files = {c["name"]: c["file"] for c in self.bench["configs"]}
        self.config = read_json(ROOT / files[self.entry["config"]])
        self.mix = read_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        limits = HERE / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text()) if limits.exists() else {}
        self.driver = self.mix["driver"]
        self.shape = {"B": int(self.mix["vehicles"]), "K": int(self.config["n_samples"]),
                      "H": int(self.config["n_horizon"]), "A": int(self.config["n_action"]),
                      "mode": self.config["control_mode"],
                      "n_obstacles": int(self.config.get("n_obstacles", 0)),
                      "substeps": int(self.mix.get("loop", {}).get("substeps", 10)),
                      "loop": dict(self.mix.get("loop", {}))}

    def metrics(self, kind: str) -> list:
        """The cell's metrics of ``kind`` (``end_to_end`` / ``per_layer``)."""
        return [m for m in self.bench[kind] if self.name in m.get("workloads", [self.name])]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--stand-in", default=None,
                    help="'control', 'control-bf16' or 'fault:<name>': the plain reference in "
                         "the program's place (limit setting only)")
    return ap.parse_args(argv)


def fix_caches() -> None:
    """Every cache a run could write goes inside the checkout, at fixed paths."""
    CACHE.mkdir(parents=True, exist_ok=True)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None, t_start: Optional[float] = None, device=None, overrides=None) -> int:
    """One run; returns the exit code.  ``device`` and ``overrides`` (sizes
    for the CPU tests: ``K``, ``H``, ``B``, ``episode_steps``, ...) are
    for the tests, which drive a run on the CPU without the card."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    fix_caches()
    import torch

    cell = Cell(args.workload)
    chips = int(cell.entry["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"this cell needs {chips} CUDA card(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = "cuda:0"
    torch.set_num_threads(2)
    from . import runner

    result, checks = runner.run(cell, args, torch.device(device), t_start, overrides or {})
    found = forbidden_modules(sys.modules)
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}")
        return 5
    for name, c in checks.items():
        log(f"check {name}: {c['value']:.6e} limit {c['limit']}")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0
