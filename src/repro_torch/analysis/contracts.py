"""Run-time contracts of the four hot entry points: what one call may do.

The port's counterpart of ``repro/analysis/contracts.py``.  The reference
lowers its entry points to HLO and checks the compiled program; eager
PyTorch has no program to read, so this module runs each entry point once,
for real (on the CPU or the card), and watches the call:

* **no-f64** — a ``TorchDispatchMode`` records every aten op with an fp64
  input or output: a silent float64 upcast doubles state bytes and halves
  the roofline;
* **donation → in place** — every buffer the reference's entry point
  donates keeps its storage through the call
  (``untyped_storage().data_ptr()`` before and after): ``train_step``
  updates the parameters and both moments in place; ``decode_block`` and
  ``spec_round`` update the state pool's leaves and the slots' tokens in
  place (the reference also donates positions; the port's model has none);
  ``prefill`` declares no donation and its output aliases no parameter;
* **host transfers** — the calls that bring device values to the host,
  as many as the port's annotated ``# sync-point:``s say: ``train_step``
  0, an admission 1, a decode block 1, a speculative round 1 when every
  draft is accepted and 2 when it rolls back.  Counted as calls of
  ``.cpu()``, ``.item()``, ``.tolist()`` and ``.numpy()`` (the last not on
  a tensor ``.cpu()`` just returned); on the card the call also runs under
  ``torch.cuda.set_sync_debug_mode("warn")``, whose warnings catch what
  the CPU cannot see (a ``nonzero``, a Python ``bool`` of a tensor, a
  pageable host-to-device copy) and must number the same;
* **bounded collectives** — no ``c10d`` op (one device);
* **stable dispatch** (the reference's stable-HLO, its recompilation
  hazard) — prompt lengths that pad to one chunk bucket
  (``pad_to_bucket``) give admissions with the same kernel launches
  (``kernels._build.LAUNCHES``) and the same sequence of aten op names.

On the card each call must also launch exactly its kernels: a prefill one
chunk-forward launch per layer, a decode block one step launch per layer
and step, a round one chunk-forward launch per layer (and a rollback one
step launch per layer and replayed step), a train step each layer's
forward (twice under ``remat="full"``) and backward.  On the CPU the
wrappers take their plain versions and nothing launches.

CLI: ``python -m repro_torch.analysis.contracts [--arch hla-1b] [--mixer
ahla] [--device cpu|cuda] [--json]``; exit 1 on any violated contract.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import warnings
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels._build import LAUNCHES
from ..serving.spec.drafters import Drafter

ENTRY_POINTS = ("train_step", "prefill", "decode_block", "spec_round")

#: aten op namespaces of the process-group collectives
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

#: what the sync debug mode warns with at each synchronizing operation (its
#: one-time notice that the mode is a prototype says "synchronizing" too)
_SYNC_WARNING = "called a synchronizing CUDA operation"

#: each mixer's (chunk forward, chunk backward, decode step) kernels; the
#: plain records (hla3, hla3_paper, linattn) launch none
_KERNELS = {"hla2": ("hla2_chunk_fwd", "hla2_chunk_bwd", "hla2_step"),
            "ahla": ("ahla_chunk_fwd", "ahla_chunk_bwd", "ahla_step")}


def pad_to_bucket(n: int, chunk: int) -> int:
    """The serving admission bucket: lengths are padded up to a chunk
    multiple, so only the bucket — never the raw length — may key a
    compilation."""
    return max(chunk, -(-n // chunk) * chunk)


# --------------------------------------------------------------------------
# watching one call
# --------------------------------------------------------------------------


class _Recorder(TorchDispatchMode):
    """Every aten op of a call: its name, whether it read or wrote fp64,
    whether it was a collective."""

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []
        self.f64: List[str] = []
        self.collectives: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        self.ops.append(name)
        if any(isinstance(x, torch.Tensor) and x.dtype == torch.float64
               for x in tree_flatten((args, kwargs, out))[0]):
            self.f64.append(name)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self.collectives.append(name)
        return out


@dataclasses.dataclass
class _Watch:
    recorder: _Recorder
    transfers: collections.Counter
    sync_warnings: Optional[int] = None
    sync_sites: List[str] = dataclasses.field(default_factory=list)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def _watch(device: torch.device):
    """Record one call: its aten ops, its host transfers, its kernel
    launches and, on the card, the sync debug mode's warnings."""
    transfers: collections.Counter = collections.Counter()
    fetched = {}  # id -> weakref of the tensors .cpu() returned
    originals = {name: getattr(torch.Tensor, name)
                 for name in ("cpu", "item", "tolist", "numpy")}

    def counted(name):
        orig = originals[name]

        def method(self, *args, **kwargs):
            ref = fetched.get(id(self))
            if not (name == "numpy" and ref is not None and ref() is self):
                transfers[name] += 1  # .numpy() of a fetched tensor is free
            out = orig(self, *args, **kwargs)
            if name == "cpu":
                fetched[id(out)] = weakref.ref(out)
            return out

        return method

    watch = _Watch(_Recorder(), transfers)
    before = dict(LAUNCHES)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        mode = torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for name in originals:
                setattr(torch.Tensor, name, counted(name))
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with watch.recorder:
                    yield watch
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(mode)
                for name, orig in originals.items():
                    setattr(torch.Tensor, name, orig)
    finally:
        if cuda:
            torch.cuda.synchronize(device)
    for w in caught:  # pass on what is not the debug mode's
        if _SYNC_WARNING not in str(w.message):
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)
    if cuda:  # where the syncs were issued from: the Python call sites
        sites = [f"{w.filename}:{w.lineno}" for w in caught
                 if _SYNC_WARNING in str(w.message)]
        watch.sync_warnings, watch.sync_sites = len(sites), sites
    watch.launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                      if v != before.get(k, 0)}


def _storages(tensors) -> List[int]:
    return [x.untyped_storage().data_ptr() for x in tensors]


def _leaves(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _fingerprint(ops: Sequence[str]) -> str:
    return hashlib.sha256("\n".join(ops).encode()).hexdigest()


# --------------------------------------------------------------------------
# reports
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ContractReport:
    """One entry point's verdict.  ``violations`` empty means the call
    honoured every contract."""

    name: str
    violations: List[str]
    syncs: int  # explicit host transfers counted in the call
    sync_warnings: Optional[int]  # the card's sync debug mode (None: CPU)
    expected_syncs: int
    donated: int  # buffers the reference donates
    kept: int  # of them, storages kept through the call
    f64_ops: int
    collectives: int
    launches: Dict[str, int]
    aten_ops: int
    fingerprint: str

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def _report(name, watch: _Watch, *, expected_syncs: int, donated=(),
            after=(), launches_want: Optional[Dict[str, int]] = None,
            device: torch.device) -> ContractReport:
    """The verdict on one watched call.  ``donated``/``after`` are the
    storage pointers of the donated buffers before and after the call."""
    rec = watch.recorder
    violations = []
    if rec.f64:
        violations.append(f"f64 ops in the call ({len(rec.f64)}): "
                          + "; ".join(sorted(set(rec.f64))[:5]))
    syncs = sum(watch.transfers.values())
    if syncs != expected_syncs:
        violations.append(
            f"host transfers: {syncs} ({dict(watch.transfers)}), the "
            f"contract allows {expected_syncs}")
    if watch.sync_warnings is not None and \
            watch.sync_warnings != expected_syncs:
        violations.append(
            f"synchronizing CUDA operations: {watch.sync_warnings} (sync "
            f"debug mode, from {watch.sync_sites}), the contract allows "
            f"{expected_syncs}")
    kept = sum(a == b for a, b in zip(donated, after))
    if len(donated) != len(after) or kept != len(donated):
        violations.append(
            f"donation contract: {len(donated)} buffer(s) donated but "
            f"{kept} kept their storage — an out-of-place update keeps a "
            "dead copy live through the call")
    if rec.collectives:
        violations.append(f"collective ops ({len(rec.collectives)}): "
                          + "; ".join(sorted(set(rec.collectives))))
    want = {k: v for k, v in (launches_want or {}).items() if k} \
        if device.type == "cuda" else {}
    if watch.launches != want:
        violations.append(f"kernel launches {watch.launches}, want {want}")
    return ContractReport(
        name=name, violations=violations, syncs=syncs,
        sync_warnings=watch.sync_warnings, expected_syncs=expected_syncs,
        donated=len(donated), kept=kept, f64_ops=len(rec.f64),
        collectives=len(rec.collectives), launches=watch.launches,
        aten_ops=len(rec.ops), fingerprint=_fingerprint(rec.ops))


# --------------------------------------------------------------------------
# the speculative round's input: scripted drafts
# --------------------------------------------------------------------------


class ScriptedDrafter(Drafter):
    """Proposes, for each slot, the next ``k`` tokens of a known stream
    (``scripts[slot]``: prompt + the plain greedy continuation), so a round
    accepts every draft; with ``wrong`` set it proposes each of them plus
    one (mod ``vocab``), so the round rejects and rolls back.  Host only:
    the drafts are the round's input, as in the reference's contract."""

    def __init__(self, scripts: Dict[int, Sequence[int]], vocab: int):
        self.vocab = vocab
        self.scripts = {s: list(map(int, t)) for s, t in scripts.items()}
        self.seen: Dict[int, int] = {}
        self.wrong = False

    def admit(self, slot, tokens):
        self.seen[slot] = len(tokens)

    def commit(self, slot, tokens):
        self.seen[slot] += len(tokens)

    def propose(self, slot_ids, k):
        drafts = np.zeros((len(slot_ids), k), np.int64)
        for i, s in enumerate(slot_ids):
            nxt = self.scripts[s][self.seen[s]:self.seen[s] + k]
            drafts[i, :len(nxt)] = nxt
        if self.wrong:
            drafts = (drafts + 1) % self.vocab
        return drafts, None


# --------------------------------------------------------------------------
# the full contract run
# --------------------------------------------------------------------------


def default_config(mixer: Optional[str] = None, arch: str = "hla-1b"):
    """``arch`` reduced, with a chunk of 16 (the reference's contract
    config), so the default prompt lengths (5, 11, 16) share one bucket."""
    from ..configs import get_config

    cfg = get_config(arch, reduced=True, mixer=mixer)
    return cfg.replace(hla=dataclasses.replace(cfg.hla, chunk=16))


def check_entry_points(cfg=None, *, device="cuda", seed: int = 0,
                       prompt_lengths: Optional[Sequence[int]] = None,
                       block: int = 4, spec_k: int = 4, batch: int = 2,
                       seq: int = 64) -> List[ContractReport]:
    """Run all four entry points once each, watched, and return their
    reports: ``prefill``, ``decode_block``, ``spec_round/accept``,
    ``spec_round/reject`` and ``train_step``.

    ``prompt_lengths`` (default: three lengths of the first
    ``cfg.hla.chunk`` bucket, ``(chunk - 11, chunk - 5, chunk)``) drive the
    stable-dispatch check.  The serving calls run on one ``Engine``
    (greedy, ``block`` steps a block) warmed by one admission and one
    block, the speculative rounds (``spec_k`` drafts) on a second one fed
    by ``ScriptedDrafter``, the train step (``batch`` x ``seq`` tokens of
    ``SyntheticStream``, default ``OptConfig``) after one warmup step.  The
    weights are random, from ``seed``."""
    from ..data.pipeline import DataConfig, SyntheticStream
    from ..distributed.steps import make_train_step
    from ..models import lm
    from ..models.param import init_params
    from ..optim import adamw
    from ..serving.engine import Engine, GenRequest, check_servable
    from ..serving.spec import SpecConfig
    from ..serving.state_pool import to_device

    cfg = default_config() if cfg is None else cfg
    # the serving entry points need a config the engine admits (no KV
    # cache, no hybrid stack): refuse before allocating anything
    check_servable(cfg, SpecConfig(k=spec_k))
    device = torch.device(device)
    chunk = cfg.hla.chunk
    lengths = list(prompt_lengths or (chunk - 11, chunk - 5, chunk))
    fwd, bwd, step = _KERNELS.get(cfg.mixer, (None, None, None))
    L = cfg.n_layers
    gen = 4 * (spec_k + 1) + spec_k + 1  # what the rounds below consume
    rng = np.random.RandomState(seed)
    params = init_params(lm.lm_specs(cfg), seed, device)
    reports = []

    # -- prefill and decode_block -----------------------------------------
    engine = Engine(cfg, params, slots=len(lengths) + 1,
                    max_len=max(lengths) + gen + 8, block=block,
                    seed=seed, device=device)
    param_storages = set(_storages(_leaves(engine.params)))

    def request(rid, n):
        return GenRequest(rid=rid, prompt=rng.randint(2, cfg.vocab, n),
                          max_new=gen)

    engine.admit(0, request(0, lengths[0]))  # warmup: builds, caches
    engine.step_block()
    prompts, calls = {}, []
    for slot, n in enumerate(lengths, 1):
        req = request(slot, n)
        prompts[slot] = req.prompt
        with _watch(device) as w:
            engine.admit(slot, req)
        calls.append((n, w))
    out = _leaves((engine.pool.states, engine.tokens))
    aliased = [x for x in _storages(out) if x in param_storages]
    first = _report("prefill", calls[0][1], expected_syncs=1,
                    launches_want={fwd: L}, device=device)
    for n, w in calls[1:]:  # every admission holds the per-call contracts
        r = _report("prefill", w, expected_syncs=1, launches_want={fwd: L},
                    device=device)
        first.violations += [f"(prompt of {n}) {v}" for v in r.violations]
    if aliased:
        first.violations.append(
            f"prefill output aliases {len(aliased)} parameter storage(s)")
    by_bucket = collections.defaultdict(dict)
    for n, w in calls:
        by_bucket[pad_to_bucket(n, chunk)][n] = (
            _fingerprint(w.recorder.ops), tuple(sorted(w.launches.items())))
    for bucket, seen in sorted(by_bucket.items()):
        if len(set(seen.values())) > 1:
            first.violations.append(
                f"unstable dispatch: prompt lengths {sorted(seen)} all pad "
                f"to bucket {bucket} but run {len(set(seen.values()))} "
                "distinct op sequences or launch counts")
    reports.append(first)

    before = _storages(_leaves((engine.pool.states, engine.tokens)))
    with _watch(device) as w:
        engine.step_block()
    reports.append(_report(
        "decode_block", w, expected_syncs=1, donated=before,
        after=_storages(_leaves((engine.pool.states, engine.tokens))),
        launches_want={step: L * block}, device=device))
    engine.run([])  # the plain greedy streams: the drafter's script
    scripts = {s: list(prompts[s]) + engine.results[s].tokens
               for s in (1, 2)}
    del engine

    # -- spec_round ---------------------------------------------------------
    drafter = ScriptedDrafter({s - 1: t for s, t in scripts.items()},
                              cfg.vocab)
    spec = Engine(cfg, params, slots=2, max_len=max(lengths) + gen + 8,
                  seed=seed, device=device,
                  spec=SpecConfig(k=spec_k, drafter=drafter,
                                  breaker_zero_rounds=10**9))
    for s in (1, 2):
        spec.admit(s - 1, GenRequest(rid=s, prompt=prompts[s],
                                     max_new=gen - spec_k))
    spec.step_block()  # warmup round
    for case, wrong in (("accept", False), ("reject", True)):
        drafter.wrong = wrong
        replays = spec.stats["spec_replays"]
        replay_steps = spec.stats["spec_replay_steps"]
        before = _storages(_leaves((spec.pool.states, spec.tokens)))
        with _watch(device) as w:
            spec.step_block()
        rolled = spec.stats["spec_replays"] - replays
        steps = spec.stats["spec_replay_steps"] - replay_steps
        want = {fwd: L, step: L * steps} if steps else {fwd: L}
        r = _report(f"spec_round/{case}", w, expected_syncs=1 + rolled,
                    donated=before,
                    after=_storages(_leaves((spec.pool.states, spec.tokens))),
                    launches_want=want, device=device)
        if wrong and not rolled:
            r.violations.append("the wrong drafts were not rolled back")
        reports.append(r)
    del spec

    # -- train_step ---------------------------------------------------------
    train_step = make_train_step(cfg, adamw.OptConfig())
    state = adamw.init_opt_state(params)
    data = {k: to_device(v, device) for k, v in SyntheticStream(
        DataConfig(cfg.vocab, seq, batch, seed=seed)).batch(0).items()}
    params, state, _ = train_step(params, state, data)  # warmup
    before = _storages(_leaves((params, state.mu, state.nu)))
    with _watch(device) as w:
        params, state, _ = train_step(params, state, data)
    reports.append(_report(
        "train_step", w, expected_syncs=0, donated=before,
        after=_storages(_leaves((params, state.mu, state.nu))),
        launches_want={fwd: L * (2 if cfg.remat == "full" else 1), bwd: L},
        device=device))
    return reports


def format_report(r: ContractReport) -> str:
    warn = "" if r.sync_warnings is None else \
        f" sync_warnings={r.sync_warnings}"
    return (f"{r.name:18s} {'ok' if r.ok else 'VIOLATED'}  syncs={r.syncs}/"
            f"{r.expected_syncs}{warn} kept={r.kept}/{r.donated} "
            f"f64={r.f64_ops} collectives={r.collectives} "
            f"launches={r.launches} aten_ops={r.aten_ops} "
            f"fp={r.fingerprint[:12]}")


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.contracts",
        description="Run-time contracts of the four hot entry points: "
                    "each runs once, watched.")
    p.add_argument("--arch", default="hla-1b",
                   help="config name, run reduced with a chunk of 16")
    p.add_argument("--mixer", default=None,
                   help="sequence op (default: the arch's)")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("contracts: no CUDA device (use --device cpu)",
              file=sys.stderr)
        return 2

    reports = check_entry_points(default_config(args.mixer, args.arch),
                                 device=args.device)
    if args.json:
        print(json.dumps({"schema": "repro_torch.contracts/v1",
                          "reports": [r.to_dict() for r in reports]},
                         indent=2))
    else:
        for r in reports:
            print(format_report(r))
            for v in r.violations:
                print(f"    - {v}")
    return 0 if all(r.ok for r in reports) else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
