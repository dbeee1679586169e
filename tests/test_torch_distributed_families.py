"""The rest of the port's multi-device code on 4 gloo ranks on the CPU:
speculative serving and the prefix cache under a mesh, sharded ``hla3``
serving, the families' sharded forwards (MoE, Mamba in the hybrid stack,
RWKV-6, GLA, whisper), the int8 error-feedback all-reduce and the GPipe
pipeline; and, in this process, the dry run over every family and
``remat="dots"``.

Four ranks are spawned once for the module (``ranks``, rendezvous through a
``FileStore`` under ``tmp_path``, a time limit), as in
``test_torch_distributed.py``; every scenario but two runs on the mesh
``(data, model) = (2, 2)``.  The pipeline runs on a ``("pipe",)`` mesh of
the four and the compression on a ``("data",)`` one.  Rank 0 returns numpy
results.  The single-device results come from the port itself in this
process, computed while the ranks run, and from the reference where that
is cheap: the compression (the reference's ``int8_allreduce_mean`` under
``jax.vmap(axis_name="data")``), the pipeline's serial oracle and
``remat="dots"``.  The dry-run cells (a ``fake`` process group of 4 in
this process) and ``remat="dots"``'s gradients are computed in the same
window, so the module takes about as long as the ranks (~50 s).

What is held, and how tightly:

* speculative serving (reduced hla-1b, ``hla2`` and ``ahla``, the n-gram
  and the LM drafter, k = 3, fp32 greedy): the streams equal the
  single-device speculative engine's and plain greedy's; every target-pool
  and draft-pool leaf has the placements ``steps.state_shardings_for``
  gives (slots over "data", heads over "model"); the engine ran rounds;
* the prefix cache: the streams equal the single-device engine's with a
  cache, and the hits resume at the same prompt positions; a slot's host
  snapshot taken on (2, 2) restores onto a (1, 2) pool of ranks 0 and 1
  and equals the saved leaves exactly;
* ``hla3`` served on the mesh: the tokens equal, the pools' final states
  within 1e-4 (the reference test's bound), every leaf placed;
* MoE routing: the expert ids of every (token, k) pair equal the
  single-device run's, for reduced granite-moe and qwen3-moe;
* one AdamW step (fp64) of reduced granite-moe (its own GQA softmax
  attention), qwen3-moe (``hla2``), jamba (one group: Mamba, MoE and the
  ``hla2`` drop-in), rwkv6-7b, hla-1b with ``gla`` and whisper-small with
  ``hla2``: the loss within 1e-6 relative, every parameter's update within
  ``UPDATE_TOL`` in norm and the step-0 gradient norm within 1e-5
  relative of the single-device step; a prefill of 8 tokens and 4 serve
  steps (fp32: the HLA step kernels' wrappers take fp32 or bf16) give
  logits within 1e-5 of their largest.  The bounds are
  ``test_torch_distributed.py``'s: both runs cast the out-norm and the
  cross-entropy to fp32, so they part at fp32's rounding;
* the compression (4 rows of 4096): the port's mean estimate and new
  error equal the reference's within one phase-2 quantization step per
  element (the share that is bit for bit is asserted above 99%); one
  round is within 5% of the exact mean, 8 error-feedback rounds within 2%
  accumulated (the reference test's properties);
* the pipeline (L = 8, M = 4, mb = 2, n = 8, d = 16 on 4 stages): the
  forward equals the reference's serial stack within 1e-5 and the
  gradients equal ``jax.grad`` of the serial loss within 1e-4.
"""

import queue
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.models.param import init_params, leaf_paths, tree_map

WORLD = 4
B, N = 4, 32
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: the families trained and decoded on the mesh: (arch, mixer override)
FAMILIES = {
    "granite": ("granite-moe-3b-a800m", None),
    "qwen3": ("qwen3-moe-30b-a3b", "hla2"),
    "jamba": ("jamba-1.5-large-398b", "hla2"),
    "rwkv6": ("rwkv6-7b", None),
    "gla": ("hla-1b", "gla"),
    "whisper": ("whisper-small", "hla2"),
}
SPEC = [(m, d) for m in ("hla2", "ahla") for d in ("ngram", "lm")]
PROMPTS = (20, 33, 7, 41)
PREFILL, DECODE = 8, 4
UPDATE_TOL = 1e-3  # fp64, as test_torch_distributed.py's
PIPE = dict(L=8, M=4, mb=2, n=8, d=16)


def _family_cfg(name, dtype="float64"):
    """Training runs in fp64; decoding in fp32 (the HLA step kernels'
    wrappers take fp32 or bf16)."""
    arch, mixer = FAMILIES[name]
    return get_config(arch, reduced=True, mixer=mixer).replace(
        dtype=dtype, param_dtype=dtype, moment_dtype=dtype,
        grad_accum_dtype=dtype)


def _family_params(cfg):
    from repro_torch.distributed import steps

    return init_params(steps.model_specs(cfg), 0, "cpu")


def _batch(cfg, seed=1):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (B, N + 1))
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    out["labels"][0, :5] = -1  # uneven masking across the data ranks
    if cfg.enc_layers:
        out["frames"] = rng.randn(B, cfg.enc_frames, cfg.d_model) * 0.5
    return {k: torch.from_numpy(v) for k, v in out.items()}


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n) for n in PROMPTS]


def _cache_prompts(vocab):
    rng = np.random.RandomState(2)
    prefix = rng.randint(2, vocab, 12)
    return [np.concatenate([prefix, rng.randint(2, vocab, n)])
            for n in (1, 2, 4, 9)] + [rng.randint(2, vocab, 3)]


def _serve_cfg(mixer):
    return get_config("hla-1b", reduced=True, mixer=mixer)


def _engine(cfg, mesh=None, **kw):
    """An engine over the seed-0 weights of ``cfg`` (distributed on
    ``mesh``)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    params = init_params(lm.lm_specs(cfg), 0, "cpu")
    if mesh is not None:
        params = shd.distribute(params, shd.param_shardings(
            lm.lm_specs(cfg), mesh), mesh)
    return Engine(cfg, params, slots=4, max_len=64, block=4, device="cpu",
                  mesh=mesh, **kw)


def _streams(eng, prompts, max_new=6):
    from repro_torch.serving.engine import GenRequest

    res = eng.run([GenRequest(rid=i, prompt=p, max_new=max_new)
                   for i, p in enumerate(prompts)])
    return [list(r.tokens) for r in res]


def _spec_engine(mixer, drafter, mesh=None):
    from repro_torch.serving.spec import SpecConfig

    return _engine(_serve_cfg(mixer), mesh,
                   spec=SpecConfig(k=3, drafter=drafter))


def _cache_engine(mesh=None):
    from repro_torch.serving.cache import PrefixCache

    return _engine(_serve_cfg("hla2"), mesh,
                   cache=PrefixCache(granularity=4, budget_bytes=1 << 26))


def _hits(eng):
    return {e["rid"]: e["cached_prefix"]
            for e in eng.obs.events("request.admitted")}


def _full_states(states):
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import state_tree

    return [shd.full(x).numpy() for x in state_tree.leaves(states)]


def _placed(cfg, states, mesh):
    from repro_torch.distributed import steps
    from repro_torch.models import state_tree

    want = steps.state_shardings_for(cfg, mesh, states)
    return [tuple(x.placements) for x in state_tree.leaves(states)] == \
        [tuple(p) for p in want]


def _train(cfg, params, batch, mesh=None):
    """One AdamW step: ``(loss, grad norm, {path: final parameter})``."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps
    from repro_torch.optim import adamw

    ps = None
    if mesh is not None:
        ps, ms = steps.make_shardings(cfg, mesh)
        zeros = adamw.init_opt_state(params, cfg.moment_dtype)
        opt = adamw.OptState(0, shd.distribute(zeros.mu, ms, mesh),
                             shd.distribute(zeros.nu, ms, mesh))
        params = shd.distribute(params, ps, mesh)
        batch = {k: shd.batch_rows(v, mesh) for k, v in batch.items()}
    else:
        opt = adamw.init_opt_state(params, cfg.moment_dtype)
    step = steps.make_train_step(cfg, adamw.OptConfig(**OPT),
                                 grad_shardings=ps)
    with shd.use_mesh(mesh):
        params, _, m = step(params, opt, batch)
    return (float(m["loss"]), float(m["grad_norm"]),
            {"/".join(p): shd.full(x).numpy() for p, x in leaf_paths(params)})


def _decode(cfg, params, mesh=None):
    """The last logits of a prefill of ``PREFILL`` tokens, then of each of
    ``DECODE`` serve steps (numpy), through ``steps.make_prefill_step`` and
    ``make_serve_step``."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps

    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, (B, PREFILL + DECODE)))
    batch = {"tokens": toks[:, :PREFILL]}
    if cfg.enc_layers:
        batch["frames"] = _batch(cfg)["frames"]
    if mesh is not None:
        params = shd.distribute(params, steps.make_shardings(cfg, mesh)[0],
                                mesh)
        batch = {k: shd.batch_rows(v, mesh) for k, v in batch.items()}
    with torch.no_grad(), shd.use_mesh(mesh):
        logits, states = steps.make_prefill_step(cfg)(params, batch)
        out = [shd.full(logits).numpy()]
        serve = steps.make_serve_step(cfg)
        for t in range(PREFILL, PREFILL + DECODE):
            logits, states = serve(params, {
                "tokens": shd.batch_rows(toks[:, t:t + 1], mesh),
                "positions": shd.batch_rows(torch.full((B, 1), t), mesh)},
                states)
            out.append(shd.full(logits).numpy())
    return out


def _routes(cfg, params, mesh=None):
    """Every MoE layer's expert ids of the training batch (numpy); on
    ``mesh`` each rank routes its own rows, gathered here over "data"."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps
    from repro_torch.models import lm, moe

    seen = []
    real = moe.route

    def spy(p, x, c):
        out = real(p, x, c)
        seen.append(out[2].numpy())
        return out

    batch = _batch(cfg)
    if mesh is not None:
        params = shd.distribute(params, steps.make_shardings(cfg, mesh)[0],
                                mesh)
        batch = {k: shd.batch_rows(v, mesh) for k, v in batch.items()}
    moe.route = spy
    try:
        with torch.no_grad(), shd.use_mesh(mesh):
            lm.lm_apply(params, batch["tokens"], cfg)
    finally:
        moe.route = real
    if mesh is None:
        return seen
    parts = [None] * mesh.size(0)
    torch.distributed.all_gather_object(parts, seen,
                                        group=mesh.get_group("data"))
    return [np.concatenate(rows) for rows in zip(*parts)]


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------


def _scenarios(rank):
    """``[(key, thunk)]`` of every mesh scenario of one rank."""
    from repro_torch.distributed import compression, pipeline_par
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm

    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = []

    def spec(mixer, drafter):
        eng = _spec_engine(mixer, drafter, mesh)
        toks = _streams(eng, _prompts(eng.cfg.vocab))
        pools = [eng.pool] + ([eng.drafter.pool] if drafter == "lm" else [])
        placed = all(_placed(eng.cfg, p.states, mesh) for p in pools)
        return toks, placed, eng.stats["spec_rounds"]

    for mixer, drafter in SPEC:
        out.append((("spec", mixer, drafter),
                    lambda m=mixer, d=drafter: spec(m, d)))

    def cache():
        eng = _cache_engine(mesh)
        toks = _streams(eng, _cache_prompts(eng.cfg.vocab))
        # a host snapshot of slot 1 from the (2, 2) pool, restored onto a
        # (1, 2) pool of ranks 0 and 1
        snap = eng.pool.snapshot_slot(1, host=True)
        small = torch.distributed.device_mesh.DeviceMesh(
            "cpu", [[0, 1]], mesh_dim_names=("data", "model"))
        same = None
        if rank < 2:
            from repro_torch.serving.state_pool import StatePool

            cfg = eng.cfg
            pool = StatePool(
                lambda n: lm.lm_init_states(cfg, n, "cpu"), 4, mesh=small,
                placements=steps.state_shardings_for(
                    cfg, small, lm.lm_init_states(cfg, 4, "meta")))
            pool.restore_slot(2, snap)
            back = pool.snapshot_slot(2, host=True)
            same = all(torch.equal(a, b) for a, b in zip(
                _leaves(back), _leaves(snap))) and \
                _placed(cfg, pool.states, small)
        return toks, _hits(eng), same

    out.append(("cache", cache))

    def hla3():
        eng = _engine(_serve_cfg("hla3"), mesh)
        toks = _streams(eng, _prompts(eng.cfg.vocab))
        return toks, _full_states(eng.pool.states), _placed(
            eng.cfg, eng.pool.states, mesh)

    out.append(("hla3", hla3))

    for name in ("granite", "qwen3"):
        out.append((("route", name), lambda n=name: _routes(
            _family_cfg(n), _family_params(_family_cfg(n)), mesh)))
    for name in FAMILIES:
        def family(n=name):
            cfg, dcfg = _family_cfg(n), _family_cfg(n, "float32")
            dec = _decode(dcfg, _family_params(dcfg), mesh)
            return _train(cfg, _family_params(cfg), _batch(cfg), mesh), dec

        out.append((("family", name), family))

    def compress():
        cmesh = make_mesh((WORLD,), ("data",), device_type="cpu")
        group = cmesh.get_group("data")
        x = torch.from_numpy(_compress_rows()[rank])
        err = torch.zeros_like(x)
        rounds = []
        for _ in range(9):  # one round, then 8 error-feedback rounds
            red, err = compression.int8_allreduce_mean(x, err, group=group)
            rounds.append((red.numpy(), err.numpy()))
        qd = compression.quantize_dequantize(x).numpy()
        # the per-leaf form: one round over a dict of leaves
        run = compression.make_compressed_grad_allreduce(cmesh)
        red, err = run({"w": {"a": x.reshape(64, 64)}},
                       {"w": {"a": torch.zeros(64, 64)}})
        tree = (red["w"]["a"].reshape(-1).numpy(),
                err["w"]["a"].reshape(-1).numpy())
        return rounds, qd, tree

    out.append(("compress", compress))

    def pipe():
        pmesh = make_mesh((WORLD,), ("pipe",), device_type="cpu")
        Ws, xs = (torch.from_numpy(a) for a in _pipe_inputs())
        Ws.requires_grad_(True)
        y = pipeline_par.pipelined_forward(
            lambda w, x: torch.tanh(x @ w), Ws, xs, pmesh)
        (y ** 2).sum().backward()
        g = Ws.grad.clone()
        torch.distributed.all_reduce(g)  # each stage holds its layers'
        return y.detach().numpy(), g.numpy()

    out.append(("pipe", pipe))
    return out


def _leaves(tree):
    from repro_torch.models import state_tree

    return state_tree.leaves(tree)


def _rank(rank, store_path, results):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    out = {}
    try:
        for key, thunk in _scenarios(rank):
            try:
                out[key] = thunk()
            except Exception:  # reported by the scenario's test
                out[key] = ("error", traceback.format_exc())
    finally:
        if rank == 0:
            results.put(out)
        dist.destroy_process_group()


def _compress_rows():
    return np.random.RandomState(0).randn(WORLD, 4096).astype(np.float32)


def _pipe_inputs():
    rng = np.random.RandomState(0)
    L, M, mb, n, d = (PIPE[k] for k in ("L", "M", "mb", "n", "d"))
    return (rng.randn(L, d, d).astype(np.float32) * np.float32(d ** -0.5),
            rng.randn(M, mb, n, d).astype(np.float32))


def _single():
    """The port's single-device results of every scenario."""
    out = {}
    for mixer, drafter in SPEC:
        eng = _spec_engine(mixer, drafter)
        out[("spec", mixer, drafter)] = _streams(
            eng, _prompts(eng.cfg.vocab))
        if drafter == "ngram":
            plain = _engine(_serve_cfg(mixer))
            out[("plain", mixer)] = _streams(plain,
                                             _prompts(plain.cfg.vocab))
    eng = _cache_engine()
    out["cache"] = (_streams(eng, _cache_prompts(eng.cfg.vocab)), _hits(eng))
    eng = _engine(_serve_cfg("hla3"))
    out["hla3"] = (_streams(eng, _prompts(eng.cfg.vocab)),
                   _full_states(eng.pool.states))
    for name in ("granite", "qwen3"):
        cfg = _family_cfg(name)
        out[("route", name)] = _routes(cfg, _family_params(cfg))
    for name in FAMILIES:
        cfg, dcfg = _family_cfg(name), _family_cfg(name, "float32")
        params = _family_params(cfg)
        start = {"/".join(p): x.numpy().copy()
                 for p, x in leaf_paths(params)}
        dec = _decode(dcfg, _family_params(dcfg))
        out[("family", name)] = (_train(cfg, params, _batch(cfg)), dec,
                                 start)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 4 ranks once and, while they run, the single-device
    results here; returns ``(rank 0's results, single-device results)``."""
    tmp = tmp_path_factory.mktemp("mesh_families")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, str(tmp / "store"), results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    out = None
    try:
        torch.set_num_threads(2)
        single = _single()
        # the in-process checks, while the ranks still run
        single["dots"] = _dots_errors()
        single["dry"] = _dry_cells()
        out = results.get(timeout=300)
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30 if out is not None else 0)
            if p.is_alive():
                p.kill()
    assert out is not None, "a rank hung or failed before reporting"
    return out, single


def _got(ranks, key):
    got = ranks[0].get(key)
    assert got is not None, f"{key}: not reached"
    if isinstance(got, tuple) and isinstance(got[0], str):
        pytest.fail(f"{key} failed on the mesh:\n{got[1]}")
    return got


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mixer, drafter", SPEC)
def test_spec_on_mesh_matches_single_device(ranks, mixer, drafter):
    toks, placed, rounds = _got(ranks, ("spec", mixer, drafter))
    single = ranks[1]
    assert toks == single[("spec", mixer, drafter)] == \
        single[("plain", mixer)]
    assert placed  # every target-pool and draft-pool leaf
    assert rounds > 0


def test_cache_on_mesh_matches_single_device(ranks):
    toks, hits, _ = _got(ranks, "cache")
    want_toks, want_hits = ranks[1]["cache"]
    assert toks == want_toks
    assert hits == want_hits == {0: 0, 1: 12, 2: 12, 3: 12, 4: 0}


def test_cache_snapshot_restores_onto_a_smaller_mesh(ranks):
    assert _got(ranks, "cache")[2] is True


def test_hla3_serving_on_mesh_matches_single_device(ranks):
    toks, states, placed = _got(ranks, "hla3")
    want_toks, want_states = ranks[1]["hla3"]
    assert toks == want_toks
    assert placed
    for a, b in zip(states, want_states):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# the families
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["granite", "qwen3"])
def test_moe_routing_on_mesh_is_identical(ranks, name):
    got, want = _got(ranks, ("route", name)), ranks[1][("route", name)]
    assert len(got) == len(want) == _family_cfg(name).n_layers
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_train_step_on_mesh_matches_single_device(ranks, name):
    (loss, norm, params), _ = _got(ranks, ("family", name))
    (w_loss, w_norm, w_params), _, start = ranks[1][("family", name)]
    np.testing.assert_allclose(loss, w_loss, rtol=1e-6)
    np.testing.assert_allclose(norm, w_norm, rtol=1e-5)
    assert params.keys() == w_params.keys()
    for path in params:
        moved = np.linalg.norm(w_params[path] - start[path])
        err = np.linalg.norm(params[path] - w_params[path])
        assert err <= UPDATE_TOL * moved, (path, err / moved)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_decode_on_mesh_matches_single_device(ranks, name):
    _, got = _got(ranks, ("family", name))
    _, want, _ = ranks[1][("family", name)]
    assert len(got) == len(want) == 1 + DECODE
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


# --------------------------------------------------------------------------
# compression and the pipeline, against the reference
# --------------------------------------------------------------------------


def _ref_compress():
    """The reference's ``int8_allreduce_mean`` on the same rows under
    ``jax.vmap(axis_name="data")``: 9 rounds of (mean, new error)."""
    from repro.distributed.compression import int8_allreduce_mean

    run = jax.vmap(lambda x, e: int8_allreduce_mean(x, "data", e),
                   axis_name="data")
    x = jnp.asarray(_compress_rows())
    err = jnp.zeros_like(x)
    out = []
    for _ in range(9):
        red, err = run(x, err)
        out.append((np.asarray(red[0]), np.asarray(err[0])))
    return out


def test_int8_allreduce_matches_reference(ranks):
    rounds, qd, tree = _got(ranks, "compress")
    want = _ref_compress()
    x = _compress_rows()
    exact = x.mean(0)
    same = total = 0
    for (red, err), (w_red, w_err) in zip(rounds, want):
        # one phase-2 quantization step: max|mean| / 127
        step = np.abs(w_red).max() / 127.0
        assert np.abs(red - w_red).max() <= step * 1.0001
        assert np.abs(err - w_err).max() <= step * 1.0001
        same += int((red == w_red).sum())
        total += red.size
    assert same / total > 0.99
    # the reference test's properties
    red0 = rounds[0][0]
    assert np.abs(red0 - exact).max() / np.abs(exact).max() < 0.05
    est = sum(r for r, _ in rounds[1:])
    acc = 8 * exact
    assert np.abs(est - acc).max() / np.abs(acc).max() < 0.02
    from repro_torch.distributed.compression import quantize_dequantize

    np.testing.assert_array_equal(
        qd, quantize_dequantize(torch.from_numpy(x[0])).numpy())
    # make_compressed_grad_allreduce: a leaf's round is the flat one's
    for a, b in zip(tree, rounds[0]):
        np.testing.assert_array_equal(a, b)


def test_pipeline_matches_serial_reference(ranks):
    y, g = _got(ranks, "pipe")
    Ws, xs = (jnp.asarray(a) for a in _pipe_inputs())

    def serial(Ws):
        h = xs
        for i in range(PIPE["L"]):
            h = jnp.tanh(h @ Ws[i])
        return h

    np.testing.assert_allclose(y, np.asarray(serial(Ws)), atol=1e-5,
                               rtol=1e-5)
    want = jax.grad(lambda w: jnp.sum(serial(w) ** 2))(Ws)
    np.testing.assert_allclose(g, np.asarray(want), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# in this process: remat="dots" and the dry run
# --------------------------------------------------------------------------


def _dots_errors():
    """``remat="dots"``: each gradient leaf of the port's reduced hla-1b
    against the reference's, relative to the leaf's largest."""
    from repro.configs import get_config as ref_get_config
    from repro.models import lm as ref_lm
    from repro.models.param import init_params as ref_init_params
    from repro_torch.models import lm
    from repro_torch.models.param import from_jax_params

    ref_cfg = ref_get_config("hla-1b", reduced=True).replace(
        remat="dots", dtype="float32")
    cfg = get_config("hla-1b", reduced=True).replace(remat="dots",
                                                     dtype="float32")
    weights = jax.device_get(ref_init_params(ref_lm.lm_specs(ref_cfg),
                                             jax.random.key(0)))
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 33))
    x, y = toks[:, :-1], toks[:, 1:]
    want = jax.grad(lambda p: ref_lm.lm_loss(
        p, jnp.asarray(x), jnp.asarray(y), ref_cfg)[0])(weights)
    params = tree_map(lambda t: t.requires_grad_(True), from_jax_params(
        weights, lm.lm_specs(cfg), device="cpu"))
    lm.lm_loss(params, torch.from_numpy(x), torch.from_numpy(y),
               cfg)[0].backward()
    got = {"/".join(p): t.grad.numpy() for p, t in leaf_paths(params)}
    out = {}
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        w = np.asarray(w)
        out[key] = np.abs(got[key] - w).max() / np.abs(w).max()
    return out


def test_remat_dots_gradients_match_reference(ranks):
    errs = ranks[1]["dots"]
    assert errs and max(errs.values()) <= 1e-5, errs


#: the dry-run cells on a fake 2 x 2 mesh: every family's decode, and the
#: train step of the MoE configs and whisper (the chunk loops of Mamba,
#: RWKV-6 and GLA over 4096 tokens take 20-55 s of host time: the
#: test_torch_sharding.py CLI cell and the chip run's dry runs cover them)
DRY = [(arch, mixer, "decode_32k") for arch, mixer in (
    ("granite-moe-3b-a800m", None), ("qwen3-moe-30b-a3b", "hla2"),
    ("jamba-1.5-large-398b", "hla2"), ("rwkv6-7b", None), ("hla-1b", "gla"),
    ("whisper-small", "hla2"))] + [
    ("granite-moe-3b-a800m", None, "train_4k"),
    ("qwen3-moe-30b-a3b", "hla2", "train_4k"),
    ("whisper-small", "hla2", "train_4k")]


def _dry_cells():
    """Every ``DRY`` cell lowered on a fake 2 x 2 mesh in this process (a
    ``fake`` process group, destroyed after): ``(peak bytes, FLOPs,
    collective counts)`` by cell."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun

    mesh = dryrun.cli_mesh("2x2")
    out = {}
    try:
        for arch, mixer, shape in DRY:
            res = dryrun.lower_cell(arch, shape, mesh, mixer=mixer,
                                    reduced=True)
            out[(arch, mixer, shape)] = (res["memory"]["peak_bytes"],
                                         res["cost"]["flops"],
                                         res["collectives"]["counts"])
    finally:
        dist.destroy_process_group()
    return out


@pytest.mark.parametrize("arch, mixer, shape", DRY)
def test_dryrun_lowers_every_family(ranks, arch, mixer, shape):
    peak, flops, counts = ranks[1]["dry"][(arch, mixer, shape)]
    assert peak > 0 and flops > 0
    if get_config(arch, reduced=True).moe is not None:
        # the experts' outputs cross the "model" axis
        assert counts["all_gather"] > 0
