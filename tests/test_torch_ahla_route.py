"""AHLA's chunk route (prefill) against its step route (decode) by
position, in the port and in the reference: the port's routes part no
further than the reference's do.

Reduced hla-1b with the AHLA mixer, fp32, the reference's weights, one
row of 512 seeded tokens, plain versions on both sides
(``tests/torch_ahla_route_reference.py``, which this imports, runs the
same comparison at 2048 positions outside the suite).  The port's
largest |logit difference| between its two routes, in every window of
positions, stays within 4x the reference's largest (measured under the
suite's x64 setting: 7.3e-6 against 1.2e-5, max |logit| 3.7), and
neither route of the port is further from the port's fp64 chunk route
than 4x the reference's routes are.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

spec = importlib.util.spec_from_file_location(
    "torch_ahla_route_reference",
    Path(__file__).with_name("torch_ahla_route_reference.py"))
route = importlib.util.module_from_spec(spec)
spec.loader.exec_module(route)

N = 512


@pytest.fixture(scope="module")
def routes():
    from repro_torch.configs import get_config

    toks = route.tokens(get_config("hla-1b", reduced=True).vocab, N)
    r_chunk, r_step, weights = route.ref_routes(toks, "ahla")
    p_chunk, p_step = route.port_routes(toks, "ahla", weights)
    truth, _ = route.port_routes(toks, "ahla", weights, "float64")
    return r_chunk, r_step, p_chunk, p_step, truth


def test_port_routes_part_no_further_than_reference(routes):
    r_chunk, r_step, p_chunk, p_step, _ = routes
    ref = max(route.window_max(r_chunk - r_step))
    got = route.window_max(p_chunk - p_step)
    assert len(got) == 4 and max(got) <= 4 * ref, (got, ref)


def test_port_routes_as_close_to_fp64_as_reference(routes):
    r_chunk, r_step, p_chunk, p_step, truth = routes
    ref = max(max(route.window_max(x - truth)) for x in (r_chunk, r_step))
    for x in (p_chunk, p_step):
        assert max(route.window_max(x - truth)) <= 4 * ref
    assert np.isfinite(truth).all()
