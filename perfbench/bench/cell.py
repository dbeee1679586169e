"""One run of one cell: set-up, the measured window, the check, and the
result line's numbers."""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from typing import Any, Callable, Optional

from . import checks, serve, spec, train

DRIVERS = {"train": train, "closed_loop": serve}


def process_start_epoch():
    """When this process started (wall clock), from ``/proc``; None where
    that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return None


@dataclasses.dataclass
class Context:
    """What a driver needs, and what it reports back at the window's
    edges."""

    c: dict
    t: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float  # wall clock of the process's start
    fault: Optional[Callable] = None
    precs: tuple = ("fp32",)
    setup_s: float = math.nan
    memory_peak_bytes: int = 0
    window_ns: list = dataclasses.field(default_factory=list)

    def phase(self, name):
        """Set-up's progress, on standard error."""
        print(f"perfbench: {name} at {time.time() - self.started:.2f} s",
              file=sys.stderr, flush=True)

    def window_opens(self):
        """Marks the window's start; returns it on ``perf_counter``."""
        self.setup_s = time.time() - self.started
        self.window_ns = [time.time_ns()]
        return time.perf_counter()

    def window_closes(self):
        """Marks the window's end; returns it on ``perf_counter``."""
        import torch

        w1 = time.perf_counter()
        self.window_ns.append(time.time_ns())
        if self.device.type == "cuda":
            self.memory_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)
        return w1


class RunView:
    """What a per-layer metric's reader sees of a traced run."""

    def __init__(self, workload, c, t, out, trace):
        self.workload, self.c, self.t = workload, c, t
        self.window_s = out["window_s"]
        self.work = out["work"]
        self.trace = trace


def run_cell(bench, workload, seed, seconds, trace, device, *,
             started=None, fault=None, precs=("fp32",), c=None, t=None):
    """Runs ``workload`` and returns ``(result, checks)``: the result
    line's keys, and each compared number beside its limit.  ``c`` and
    ``t`` replace the cell's configuration and traffic (tests run them
    small)."""
    import torch

    _, _, c0, t0 = spec.cell(bench, workload)
    c, t = c or c0, t or t0
    ctx = Context(c=c, t=t, seed=seed, seconds=seconds, trace=trace,
                  device=torch.device(device),
                  started=started or time.time(), fault=fault, precs=precs)
    out = DRIVERS[t["kind"]].run(ctx)
    correct, judged = checks.judge(out["numbers"], spec.limits(workload))
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device)
           if ctx.device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": ctx.memory_peak_bytes}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {}, "device": dev}
    if not trace:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        for m in spec.metrics_of(bench, workload, "end_to_end"):
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    else:
        from .trace import Trace

        tr = Trace(out["prof"], ctx.window_ns, out["spans"])
        view = RunView(workload, c, t, out, tr)
        for m in spec.metrics_of(bench, workload, "per_layer"):
            v = spec.reader(m["name"]).read(view)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
        print(f"perfbench: device activities left out of busy_s: "
              f"{dict(tr.left_out)}", file=sys.stderr, flush=True)
    result["notes"] = out["notes"]
    return result, judged
