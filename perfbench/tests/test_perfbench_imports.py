"""Neither the harness nor the program it runs loads JAX or the JAX
package, and the plain reference loads nothing of the program: each
checked in a fresh interpreter, by whole top-level module names."""

import json
import subprocess
import sys

import _paths

HARNESS = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import perfbench.run, perfbench.control
from perfbench.bench import cell, serve, train, trace, program
from perfbench.bench import spec
from perfbench.reference import hla_lm
import repro_torch.serving.engine, repro_torch.distributed.steps
bench = spec.load_benchmark()
for m in bench["per_layer"]:
    spec.reader(m["name"])
import json
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
from perfbench.reference import hla_lm
from perfbench.costs import kernels, model, peaks
from perfbench.bench import weights, traffic, checks
import json
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run(
        [sys.executable, "-c", code.format(src=str(_paths.ROOT / "src"),
                                           root=str(_paths.ROOT))],
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(HARNESS)
    assert "repro_torch" in names and "perfbench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert "torch" in names
    assert not names & {"repro_torch", "jax", "jaxlib", "flax", "repro"}
