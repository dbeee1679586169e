"""The port under a (data, model) mesh of 4 gloo ranks on the CPU, held to
single-device results.

Four ranks are spawned once for the module (``_ranks``, rendezvous through
a ``FileStore`` under ``tmp_path``, one thread each, a time limit) and run
every scenario on the mesh (2, 2); rank 0 returns numpy results.  The
single-device results come from the reference (its train step, eager
JAX, on the same numpy weights and batches) and from the port itself in
this process:

* three AdamW train steps of reduced hla-1b with ``hla2`` and ``ahla``,
  in fp64 and fp32 (``sharding.distribute``d parameters, ZeRO-1 moments,
  batch split over "data", the kernels through ``call_sharded`` on each
  rank's (batch, head) rows), and in fp64 of two configs that take the
  mesh's other routes: hla-1b with a vocab of 8448 rows (over 8192, so
  ``blocks.embed_apply``'s vocab-parallel gather runs, as it does for
  hla-1b's 50304 on any model split), and a GQA softmax config, reduced
  qwen2-72b at 6 query heads over 3 KV heads, whose model split of 2
  does not fall on KV-head boundaries (``attention._kv_for_heads``): the
  losses within 1e-5 relative of the reference's and 1e-6 of the port's
  single-device run; each parameter leaf's three-step update, ``final -
  initial``, within 1e-3 (fp64) and 2e-2 (fp32) of both runs' in norm
  (``UPDATE_TOL``); the step-0 gradient norm (the clip's) within 1e-5
  (fp64) and 1e-4 (fp32) relative of both, the later steps' within 1e-3
  (they follow the updates), also when the step is given no
  ``grad_shardings`` and AdamW meets the gradients as autograd left them
  (``Partial`` ones among them);
* ``blocks.embed_apply`` of a table of 8448 rows equals ``table[ids]``
  bit for bit, with the ids as a DTensor and as a plain tensor;
* the gradients of two microbatches equal one batch's under the mesh
  (fp64, 1e-6 of each leaf's max);
* ``call_sharded`` hands each rank a ``(B/2, H/2, ...)`` block and its
  output (the training call, and a decode step's in-place state) equals
  the single-device call (fp64, 1e-12);
* ``Engine(mesh=)`` gives the single-device engine's greedy streams;
* the GQA config's KV-cache decode on the mesh (the cache placed by
  ``steps.state_shardings_for`` and written by ``attention._write_cache``,
  each rank its own block): a prefill of 8 tokens and 4 serve steps give
  the logits of the port's single-device run and of the reference's
  within 1e-5 of their largest (fp64; measured 1.7e-7 and 2.7e-7: the
  fp32 out-norm, as below);
* a checkpoint saved on (2, 2) restores onto a (1, 2) mesh of ranks 0
  and 1 and equals the saved leaves exactly.

The bounds: the model casts the out-norm and the cross-entropy to fp32
even in an fp64 run (both packages do), so a sharded fp64 run differs
from an unsharded one at fp32's rounding (~1e-7 relative in the step-0
gradients; the reductions run in other orders), not at fp64's.  AdamW's
normalised update then moves a weight whose gradient is near zero by up
to lr either way, so the parameters are held by their updates' norms.
Measured on a CPU (sharded vs reference, sharded vs port): losses
1.0e-6 and 1e-7 relative at most; updates 3.7e-4 and 7.7e-5 (fp64),
8.2e-3 and 6.1e-3 (fp32, AHLA; the port's own single-device fp32 run is
2.1e-3 from the reference's); step-0 gradient norms 1.1e-6 and 1.8e-7
(fp64), 7.0e-6 and 3.2e-7 (fp32), later steps 7.4e-5 at most.
"""

import os
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticStream as RefStream
from repro.distributed import steps as ref_steps
from repro.models import lm as ref_lm
from repro.models.param import init_params as ref_init_params
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.distributed.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.param import from_jax_params, leaf_paths, tree_map
from repro_torch.optim import adamw
from repro_torch.serving.engine import Engine, GenRequest

WORLD = 4
B, N, STEPS = 4, 32, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
#: the trained configs: (arch, mixer override, weights' key, replaced
#: fields), the same in both packages
CONFIGS = {
    "hla2": ("hla-1b", "hla2", "hla-1b", {}),
    "ahla": ("hla-1b", "ahla", "hla-1b", {}),
    # over 8192 rows: the vocab-parallel embedding gather
    "vocab": ("hla-1b", "hla2", "vocab", {"vocab": 8448}),
    # 3 KV heads on a model split of 2: a rank's query heads take KV heads
    # of both halves
    "gqa": ("qwen2-72b", None, "gqa",
            {"d_model": 48, "n_heads": 6, "n_kv_heads": 3}),
}
RUNS = [(m, d) for m in ("hla2", "ahla") for d in ("float64", "float32")] \
    + [("vocab", "float64"), ("gqa", "float64")]
ENGINES = ("hla2", "ahla")
PROMPTS = (20, 33, 7, 41)
PREFILL, DECODE, CACHE = 8, 4, 16  # the GQA decode: tokens, steps, cache


def _config(get, name, dtype=None):
    """``CONFIGS[name]`` through ``get`` (either package's
    ``get_config``)."""
    arch, mixer, _, kw = CONFIGS[name]
    cfg = get(arch, reduced=True, mixer=mixer).replace(**kw)
    return cfg.replace(dtype=dtype) if dtype else cfg


def _batches(vocab):
    stream = RefStream(RefDataConfig(vocab, N, B, seed=1))
    out = []
    for i in range(STEPS):
        host = stream.batch(i)
        host["labels"] = host["labels"].copy()
        host["labels"][0, :5] = -1  # uneven masking across the data ranks
        out.append(host)
    return out


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n) for n in PROMPTS]


def _rank(rank, store_path, weights, results):
    """One rank: every scenario on the mesh (2, 2); rank 0 puts results."""
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import shard_ops
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import blocks

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    out = {}
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        batches = _batches(get_config("hla-1b", reduced=True).vocab)

        def on_mesh(batch):
            return {k: shd.distribute_leaf(
                torch.from_numpy(v), mesh, shd.batch_sharding(mesh, v.shape))
                for k, v in batch.items()}

        def setup(name, dtype):
            cfg = _config(get_config, name, dtype)
            specs = steps.model_specs(cfg)
            dt = getattr(torch, dtype)
            params = tree_map(lambda x: x.to(dt), from_jax_params(
                weights[CONFIGS[name][2]], specs, device="cpu"))
            ps, ms = steps.make_shardings(cfg, mesh)
            return cfg, ps, ms, shd.distribute(params, ps, mesh)

        def train(name, dtype, placed=True):
            cfg, ps, ms, params = setup(name, dtype)
            zeros = adamw.init_opt_state(tree_map(shd.full, params))
            opt = adamw.OptState(0, shd.distribute(zeros.mu, ms, mesh),
                                 shd.distribute(zeros.nu, ms, mesh))
            step = steps.make_train_step(
                cfg, adamw.OptConfig(**OPT),
                grad_shardings=ps if placed else None)
            losses, norms = [], []
            with shd.use_mesh(mesh):
                for host in _batches(cfg.vocab):
                    params, opt, m = step(params, opt, on_mesh(host))
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
            return params, opt, (losses, {
                "/".join(p): shd.full(x).numpy()
                for p, x in leaf_paths(params)}, norms)

        trained = None
        for name, dtype in RUNS:
            params, opt, out[("train", name, dtype)] = train(name, dtype)
            if (name, dtype) == ("hla2", "float32"):
                trained = (params, opt)
        # the gradients as autograd leaves them: AdamW's clip meets
        # Partial leaves (a replicated weight of batch-split rows)
        out["unplaced"] = train("hla2", "float64", placed=False)[2]

        # the vocab-parallel gather alone: ids as a DTensor and as a plain
        # tensor (each rank takes its rows)
        gen = torch.Generator().manual_seed(7)
        table = torch.randn(8448, 16, generator=gen)
        ids = torch.randint(0, 8448, (4, 32), generator=gen)
        dtab = shd.distribute(table, shd.param_shardings(
            blocks.embed_specs(8448, 16), mesh)["embedding"], mesh)
        with shd.use_mesh(mesh):
            rows = [blocks.embed_apply({"embedding": dtab}, x) for x in (
                shd.distribute_leaf(ids, mesh,
                                    shd.batch_sharding(mesh, ids.shape)),
                ids)]
            out["embed"] = [(r.placements[1].is_partial(),
                             torch.equal(r.full_tensor(), table[ids]))
                            for r in rows]

        # two microbatches against one batch, same mesh
        cfg, ps, _, params = setup("hla2", "float64")
        grads = {}
        with shd.use_mesh(mesh):
            for mb in (1, 2):
                _, _, _, g = steps.accumulate_grads(
                    params, on_mesh(batches[0]), cfg, microbatches=mb)
                grads[mb] = {"/".join(p): shd.full(x).numpy()
                             for p, x in leaf_paths(g)}
        out["micro"] = grads

        # call_sharded: the local row block, the training call and a
        # decode step's in-place state
        gen = torch.Generator().manual_seed(5)
        q, k, v = (torch.randn(4, 4, 16, 8, generator=gen,
                               dtype=torch.float64) for _ in range(3))
        gamma = torch.rand(4, 4, generator=gen, dtype=torch.float64) * 0.1 \
            + 0.85
        seen = []

        def attn(*args):
            seen.append(tuple(args[0].shape))
            return kops.hla2_attention(*args)

        rows = shd.placements(("data", "model"), mesh)
        dq, dk, dv, dg = (shd.distribute_leaf(x, mesh, rows)
                          for x in (q, k, v, gamma))
        with shd.use_mesh(mesh):
            o = shard_ops.call_sharded(attn, dq, dk, dv, dg)
            st = kops.hla2_prefill(q, k, v, gamma)[1]
            dst = type(st)(*(shd.distribute_leaf(x.float(), mesh, rows)
                             for x in st))
            q1, k1, v1 = (shd.distribute_leaf(x[:, :, -1].float(), mesh, rows)
                          for x in (q, k, v))
            new, o1 = shard_ops.call_sharded(
                kops.hla2_decode_step, dst, q1, k1, v1,
                shd.distribute_leaf(gamma.float(), mesh, rows))
        out["call"] = (seen, o.full_tensor().numpy(),
                       all(a is b for a, b in zip(new, dst)),
                       [x.full_tensor().numpy() for x in dst],
                       o1.full_tensor().numpy())

        # Engine(mesh=): the streams
        for name in ENGINES:
            cfg, ps, _, params = setup(name, "float32")
            out[("engine", name)] = _serve(cfg, params, mesh)
        # a KV cache on the mesh
        cfg, _, _, params = setup("gqa", "float64")
        out["decode"] = _decode(cfg, params, mesh)

        # elastic restore: saved on (2, 2); ranks 0 and 1 start a world of
        # two and restore onto a (1, 2) mesh
        params, opt = trained
        template = (tree_map(shd.full, params),
                    adamw.OptState(0, tree_map(shd.full, opt.mu),
                                   tree_map(shd.full, opt.nu)))
        ckpt = os.path.join(os.path.dirname(store_path), "ckpt")
        CheckpointManager(ckpt, async_save=False).save(3, (params, opt))
        dist.barrier()
        dist.destroy_process_group()
        if rank < 2:
            dist.init_process_group(
                "gloo", store=dist.FileStore(store_path + "2", 2), rank=rank,
                world_size=2)
            small = make_mesh((1, 2), ("data", "model"), device_type="cpu")
            cfg = get_config("hla-1b", reduced=True)
            ps, ms = steps.make_shardings(cfg, small)
            (rp, ro), manifest = CheckpointManager(ckpt).restore(
                template, shardings=(ps, adamw.OptState(None, ms, ms)),
                mesh=small)
            pairs = list(zip(leaf_paths(rp), leaf_paths(template[0]))) + \
                list(zip(leaf_paths(ro.mu), leaf_paths(template[1].mu))) + \
                list(zip(leaf_paths(ro.nu), leaf_paths(template[1].nu)))
            same = all(torch.equal(x.full_tensor(), y)
                       for (_, x), (_, y) in pairs)
            placed = [tuple(x.placements) for _, x in leaf_paths(rp)] == [
                tuple(p) for _, p in leaf_paths(ps)]
            out["restore"] = (same, placed, ro.step, manifest["step"],
                              tuple(small.shape), len(pairs))
    finally:
        if rank == 0:
            results.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def _serve(cfg, params, mesh=None):
    """The greedy streams of ``PROMPTS`` on 4 slots."""
    eng = Engine(cfg, params, slots=4, device="cpu", mesh=mesh)
    res = eng.run([GenRequest(rid=i, prompt=p, max_new=6)
                   for i, p in enumerate(_prompts(cfg.vocab))])
    return [list(r.tokens) for r in res]


def _decode_tokens(vocab):
    return np.random.RandomState(3).randint(0, vocab,
                                            (B, PREFILL + DECODE))


def _decode(cfg, params, mesh=None):
    """The last logits of a prefill of ``PREFILL`` tokens into caches of
    ``CACHE``, then of each of ``DECODE`` serve steps (numpy); on ``mesh``
    the states, tokens and positions are DTensors."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import steps
    from repro_torch.models import state_tree

    toks = torch.from_numpy(_decode_tokens(cfg.vocab))
    states = lm.lm_init_states(cfg, B, "cpu", CACHE)

    def put(x):
        return x if mesh is None else shd.distribute_leaf(
            x, mesh, shd.batch_sharding(mesh, x.shape))

    if mesh is not None:
        pls = iter(steps.state_shardings_for(cfg, mesh, states))
        states = state_tree.tree_map(
            lambda x: shd.distribute_leaf(x, mesh, next(pls)), states)
    serve = steps.make_serve_step(cfg)
    with torch.no_grad(), shd.use_mesh(mesh):
        logits, states, _ = lm.lm_apply(params, put(toks[:, :PREFILL]), cfg,
                                        states=states, mode="prefill")
        out = [shd.full(logits[:, -1]).numpy()]
        for t in range(PREFILL, PREFILL + DECODE):
            logits, states = serve(params, {
                "tokens": put(toks[:, t:t + 1]),
                "positions": put(torch.full((B, 1), t))}, states)
            out.append(shd.full(logits).numpy())
    return out


def _ref_decode(ref_cfg, params):
    """``_decode`` in the reference, on one device."""
    toks = jnp.asarray(_decode_tokens(ref_cfg.vocab))
    states = ref_lm.lm_init_states(ref_cfg, B, CACHE)
    logits, states, _ = ref_lm.lm_apply(params, toks[:, :PREFILL], ref_cfg,
                                        states=states, mode="prefill")
    out = [np.asarray(logits[:, -1])]
    serve = ref_steps.make_serve_step(ref_cfg)
    for t in range(PREFILL, PREFILL + DECODE):
        logits, states = serve(params, {
            "tokens": toks[:, t:t + 1],
            "positions": jnp.full((B, 1), t, jnp.int32)}, states)
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def ref_weights():
    """The reference's seeded weights of each weights' key of
    ``CONFIGS``."""
    out = {}
    for name, (_, _, key, _) in CONFIGS.items():
        if key not in out:
            ref_cfg = _config(ref_get_config, name)
            out[key] = jax.device_get(ref_init_params(
                ref_lm.lm_specs(ref_cfg), jax.random.key(0)))
    return out


@pytest.fixture(scope="module")
def ranks(ref_weights, tmp_path_factory):
    """Spawn the 4 ranks once and, while they run, the single-device
    results here; returns ``(rank 0's results, single-device results)``."""
    tmp = tmp_path_factory.mktemp("mesh")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, str(tmp / "store"),
                                             ref_weights, results))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    out = None
    try:
        single = {run: _single(ref_weights, *run) for run in RUNS}
        for name in ENGINES:
            cfg = _config(get_config, name)
            single[("engine", name)] = _serve(cfg, from_jax_params(
                ref_weights[CONFIGS[name][2]], lm.lm_specs(cfg),
                device="cpu"))
        cfg = _config(get_config, "gqa", "float64")
        params = tree_map(lambda x: x.double(), from_jax_params(
            ref_weights["gqa"], lm.lm_specs(cfg), device="cpu"))
        ref_cfg = _config(ref_get_config, "gqa", "float64")
        single["decode"] = (_decode(cfg, params), _ref_decode(
            ref_cfg, jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                                  ref_weights["gqa"])))
        out = results.get(timeout=240)
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30 if out is not None else 0)
            if p.is_alive():
                p.kill()
    assert out is not None, "a rank hung or failed before reporting"
    return out, single


def _ref_leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _single(ref_weights, name, dtype):
    """The reference's and the port's single-device three steps: each
    ``(losses, final parameters, gradient norms)``."""
    ref_cfg = _config(ref_get_config, name, dtype)
    cfg = _config(get_config, name, dtype)
    weights = ref_weights[CONFIGS[name][2]]
    r_params = jax.tree.map(lambda x: jnp.asarray(x).astype(dtype), weights)
    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg,
                                                 ref_adamw.OptConfig(**OPT)))
    r_state = ref_adamw.init_opt_state(r_params)
    params = tree_map(lambda x: x.to(getattr(torch, dtype)), from_jax_params(
        weights, lm.lm_specs(cfg), device="cpu"))
    step = make_train_step(cfg, adamw.OptConfig(**OPT))
    state = adamw.init_opt_state(params)
    r_losses, losses, r_norms, norms = [], [], [], []
    for host in _batches(cfg.vocab):
        r_params, r_state, r_m = ref_step(
            r_params, r_state, {k: jnp.asarray(v) for k, v in host.items()})
        params, state, m = step(
            params, state, {k: torch.from_numpy(v) for k, v in host.items()})
        r_losses.append(float(r_m["loss"]))
        losses.append(float(m["loss"]))
        r_norms.append(float(r_m["grad_norm"]))
        norms.append(float(m["grad_norm"]))
    return (r_losses, _ref_leaves(r_params), r_norms), (losses, {
        "/".join(p): x.numpy() for p, x in leaf_paths(params)}, norms)


#: per-leaf bound on ``||got - want|| / ||want - initial||`` after three
#: steps: the parameters' updates agree to this share
UPDATE_TOL = {"float64": 1e-3, "float32": 2e-2}
#: relative bound on the step-0 gradient norm (the same weights)
NORM0_TOL = {"float64": 1e-5, "float32": 1e-4}


def _check_train(got, single, start, dtype):
    got_losses, got_params, got_norms = got
    for want_losses, want, want_norms in single:
        # the step-0 norm is of the same weights; later ones follow the
        # updates' agreement
        np.testing.assert_allclose(got_norms[0], want_norms[0],
                                   rtol=NORM0_TOL[dtype])
        np.testing.assert_allclose(got_norms, want_norms, rtol=1e-3)
        assert got_params.keys() == want.keys()
        for path in got_params:
            moved = np.linalg.norm(want[path] - start[path])
            err = np.linalg.norm(got_params[path] - want[path])
            assert err <= UPDATE_TOL[dtype] * moved, (path, err / moved)
    (r_losses, _, _), (losses, _, _) = single
    np.testing.assert_allclose(got_losses, r_losses, rtol=1e-5)
    np.testing.assert_allclose(got_losses, losses, rtol=1e-6)


@pytest.mark.parametrize("mixer, dtype", RUNS)
def test_sharded_train_matches_single_device(ranks, ref_weights, mixer,
                                             dtype):
    _check_train(ranks[0][("train", mixer, dtype)], ranks[1][(mixer, dtype)],
                 _ref_leaves(ref_weights[CONFIGS[mixer][2]]), dtype)


def test_train_without_grad_shardings_matches_single_device(ranks,
                                                            ref_weights):
    _check_train(ranks[0]["unplaced"], ranks[1][("hla2", "float64")],
                 _ref_leaves(ref_weights["hla-1b"]), "float64")


def test_vocab_parallel_embedding_is_exact(ranks):
    # the masked local gather's result is a Partial sum over "model"
    assert ranks[0]["embed"] == [(True, True), (True, True)]


def test_microbatches_match_one_batch(ranks):
    one, two = ranks[0]["micro"][1], ranks[0]["micro"][2]
    for path in one:
        scale = max(np.abs(one[path]).max(), 1e-30)
        assert np.abs(two[path] - one[path]).max() <= 1e-6 * scale, path


def test_call_sharded_runs_on_the_local_row_block(ranks):
    from repro_torch.kernels import ops as kops

    seen, o, in_place, st, o1 = ranks[0]["call"]
    assert seen == [(2, 2, 16, 8)]  # (B/2, H/2, n, d) on every rank
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(4, 4, 16, 8, generator=gen, dtype=torch.float64)
               for _ in range(3))
    gamma = torch.rand(4, 4, generator=gen, dtype=torch.float64) * 0.1 + 0.85
    np.testing.assert_allclose(o, kops.hla2_attention(q, k, v, gamma).numpy(),
                               rtol=1e-12, atol=1e-12)
    want = kops.hla2_prefill(q, k, v, gamma)[1]
    want = type(want)(*(x.float() for x in want))
    _, w1 = kops.hla2_decode_step(want, q[:, :, -1].float(),
                                  k[:, :, -1].float(), v[:, :, -1].float(),
                                  gamma.float())
    assert in_place  # the step returned the caller's DTensors
    for a, b in zip(st, want):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(o1, w1.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mixer", ENGINES)
def test_engine_mesh_streams_match_single_device(ranks, mixer):
    assert ranks[0][("engine", mixer)] == ranks[1][("engine", mixer)]


def test_gqa_decode_on_mesh_matches_single_device(ranks):
    got = ranks[0]["decode"]
    for want in ranks[1]["decode"]:
        assert len(got) == len(want) == 1 + DECODE
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def test_elastic_restore_onto_a_smaller_mesh(ranks):
    same, placed, step, manifest_step, shape, n = ranks[0]["restore"]
    assert same and placed
    assert step == manifest_step == 3
    assert shape == (1, 2) and n == 3 * 14  # params, mu, nu
