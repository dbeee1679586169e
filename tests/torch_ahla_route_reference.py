"""Not a test (pytest does not collect this file): how far AHLA's chunk
route (a prefill over the whole sequence) and its step route (token-by-
token decode from zero states) part with position, in the reference and
in the port, on the CPU through their plain versions:

    PYTHONPATH=src python tests/torch_ahla_route_reference.py [n] [mixer]

Reduced hla-1b (2 layers, d_model 64, heads of 16) with the given mixer
(default ``ahla``), fp32 activations, the reference's seeded weights
carried into the port with ``from_jax_params``; one row of ``n`` (default
2048) seeded random tokens.  For each window of positions it prints the
largest |logit difference| of chunk against step route in each package,
and each route's distance from the port's chunk route in fp64.  The suite
holds the same comparison at 512 positions
(``tests/test_torch_ahla_route.py``).  Takes about a minute at 2048."""

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WINDOWS = (0, 64, 128, 256, 512, 1024, 2048)


def tokens(vocab, n, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (1, n))


def ref_routes(toks, mixer):
    """The reference's fp32 logits ``(n, vocab)`` by chunk and by step
    route, and its weights (numpy leaves)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import lm
    from repro.models.param import init_params

    cfg = get_config("hla-1b", reduced=True, mixer=mixer)
    params = init_params(lm.lm_specs(cfg), jax.random.key(0))
    n = toks.shape[1]
    chunk = np.asarray(jax.jit(lambda p, t: lm.lm_apply(p, t, cfg)[0])(
        params, jnp.asarray(toks)))[0]

    @jax.jit
    def step(p, t, st, pos):
        logits, st, _ = lm.lm_apply(p, t, cfg, states=st, mode="decode",
                                    positions=pos)
        return logits[:, 0], st

    st = lm.lm_init_states(cfg, 1, n)
    out = []
    for t in range(n):
        logits, st = step(params, jnp.asarray(toks[:, t:t + 1]), st,
                          jnp.full((1, 1), t))
        out.append(np.asarray(logits)[0])
    return chunk, np.stack(out), jax.device_get(params)


def port_routes(toks, mixer, weights, dtype="float32"):
    """The port's logits ``(n, vocab)`` by chunk and by step route (the
    step route only in fp32: the decode wrappers take fp32 or bf16)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.param import from_jax_params, tree_map

    cfg = get_config("hla-1b", reduced=True, mixer=mixer).replace(
        dtype=dtype)
    params = from_jax_params(weights, lm.lm_specs(cfg), device="cpu")
    params = tree_map(lambda x: x.to(getattr(torch, dtype)), params)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        chunk = lm.lm_apply(params, t, cfg)[0][0].double().numpy()
        if dtype == "float64":
            return chunk, None
        st = lm.lm_init_states(cfg, 1, "cpu")
        out = []
        for i in range(t.shape[1]):
            logits, st, _ = lm.lm_apply(params, t[:, i:i + 1], cfg, states=st,
                                        mode="decode")
            out.append(logits[0, 0].double().numpy())
    return chunk, np.stack(out)


def window_max(diff):
    """Largest |diff| over each window of ``WINDOWS`` (rows = positions)."""
    n = diff.shape[0]
    return [float(np.abs(diff[a:min(b, n)]).max())
            for a, b in zip(WINDOWS, WINDOWS[1:]) if a < n]


def main(n=2048, mixer="ahla"):
    from repro_torch.configs import get_config

    vocab = get_config("hla-1b", reduced=True).vocab
    toks = tokens(vocab, n)
    r_chunk, r_step, weights = ref_routes(toks, mixer)
    p_chunk, p_step = port_routes(toks, mixer, weights)
    truth, _ = port_routes(toks, mixer, weights, "float64")
    rows = {
        "reference chunk vs step": r_chunk - r_step,
        "port chunk vs step": p_chunk - p_step,
        "reference chunk vs fp64": r_chunk - truth,
        "reference step vs fp64": r_step - truth,
        "port chunk vs fp64": p_chunk - truth,
        "port step vs fp64": p_step - truth,
    }
    heads = [f"[{a}, {b})" for a, b in zip(WINDOWS, WINDOWS[1:]) if a < n]
    print(f"{mixer}, reduced hla-1b, fp32, 1 x {n} tokens; max |logit "
          f"difference| per window of positions (max |logit| "
          f"{np.abs(truth).max():.3f})")
    print(" | ".join(["route"] + heads))
    for name, diff in rows.items():
        print(" | ".join([name] + [f"{x:.3e}" for x in window_max(diff)]))


if __name__ == "__main__":
    main(*(int(a) if a.isdigit() else a for a in sys.argv[1:]))
