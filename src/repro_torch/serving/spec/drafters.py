"""Drafters: who proposes the k tokens the target model verifies (twin of
``repro/serving/spec/drafters.py``).

A ``Drafter`` follows the engine's slot lifecycle (``admit`` / ``commit`` /
``evict``) and proposes, per round, ``k`` draft tokens for the active slots
(``propose``):

* ``NGramDrafter``: model-free prompt lookup; propose the continuation of
  the most recent earlier occurrence of the committed context's trailing
  n-gram.
* ``HLADrafter``: a small HLA draft LM with its OWN parameters and its OWN
  ``StatePool`` (one slot per engine slot).  Each round first catches its
  state up with the tokens the verifier committed since the last round
  (the masked consume of ``verify.make_replay``), then takes k decode steps
  on a COPY of its pool: the port's decode steps update states in place, so
  the speculative draft states would otherwise leak into the pool (the
  reference discards them for free, its states being immutable).

``propose`` returns device tensors (the engine feeds them straight into the
verify block) or numpy arrays.  ``HLADrafter(mesh=)`` (the reference's) is
the draft model on the engine's mesh: its parameters are DTensors, its
pool placed by ``distributed.steps.state_shardings_for`` (slots over
"data", heads over "model"; the copy its draft steps run on keeps those
placements), its prefills and decode steps run inside
``sharding.use_mesh`` with the kernels through ``call_sharded``, and the
logits are gathered before sampling, so every rank drafts the same tokens.
"""

from __future__ import annotations

import abc
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...distributed import sharding as shd
from ...models import lm, seq_op
from ...models.param import init_params, leaf_paths
from ...models.state_tree import tree_map
from ..sampling import SamplingConfig, probs, sample
from ..state_pool import StatePool, to_device
from .verify import make_replay


class Drafter(abc.ABC):
    """Slot-parallel draft-token source for speculative decoding."""

    #: True when ``propose`` returns the per-token draft laws (the warped q
    #: of speculative sampling); False means deterministic drafts (q =
    #: one-hot), and the verifier's accept rule adapts.
    emits_probs: bool = False
    #: Token-id space of the drafts, or None when proposals always come
    #: from the committed context (n-gram).  The engine refuses a drafter
    #: whose vocab differs from the target's.
    vocab: Optional[int] = None
    #: True when ``propose`` returns rows for EVERY pool slot (inactive
    #: rows are garbage the round ignores); False means rows follow
    #: ``slot_ids``.
    full_width: bool = False

    @abc.abstractmethod
    def admit(self, slot: int, tokens: Sequence[int]) -> None:
        """A request entered ``slot``; ``tokens`` = prompt + first sampled
        token (the committed context so far)."""

    @abc.abstractmethod
    def commit(self, slot: int, tokens: Sequence[int]) -> None:
        """The verifier committed ``tokens`` (accepted prefix + the
        corrected or bonus token) to a live slot."""

    @abc.abstractmethod
    def propose(self, slot_ids: Sequence[int], k: int) -> Tuple:
        """Draft ``k`` tokens for each slot in ``slot_ids``.  Returns
        ``(drafts, q)``: drafts ``(len(slot_ids), k)`` integer ids (a
        tensor or numpy; ``(pool slots, k)`` when ``full_width``), and
        ``q`` None (deterministic) or the matching ``(..., k, vocab)``
        draft laws."""

    def evict(self, slot: int) -> None:  # optional cleanup
        return None


# --------------------------------------------------------------------------
# model-free: prompt-lookup n-gram drafter
# --------------------------------------------------------------------------


class NGramDrafter(Drafter):
    """Propose the continuation of the last earlier occurrence of the
    trailing n-gram (n from ``max_n`` down to ``min_n``) of the committed
    context; fall back to repeating the last token.  Host only."""

    emits_probs = False

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if min_n < 1 or max_n < min_n:
            raise ValueError("need max_n >= min_n >= 1")
        self.max_n, self.min_n = max_n, min_n
        self._ctx = {}

    def admit(self, slot, tokens):
        self._ctx[slot] = [int(t) for t in tokens]

    def commit(self, slot, tokens):
        self._ctx[slot].extend(int(t) for t in tokens)

    def evict(self, slot):
        self._ctx.pop(slot, None)

    def _draft_one(self, ctx: List[int], k: int) -> List[int]:
        for n in range(self.max_n, self.min_n - 1, -1):
            if len(ctx) < n + 1:
                continue
            pat = ctx[-n:]
            # the rightmost earlier occurrence (the search excludes the
            # trailing n-gram itself, so every match has a continuation)
            for i in range(len(ctx) - n - 1, -1, -1):
                if ctx[i:i + n] == pat:
                    cont = ctx[i + n:i + n + k]
                    while len(cont) < k:
                        cont.append(cont[-1])
                    return cont
        return [ctx[-1]] * k

    def propose(self, slot_ids, k):
        drafts = np.asarray(
            [self._draft_one(self._ctx[s], k) for s in slot_ids], np.int64)
        return drafts, None


# --------------------------------------------------------------------------
# model drafter: small HLA LM over its own state pool
# --------------------------------------------------------------------------


class HLADrafter(Drafter):
    """A small streaming-state draft LM sharing the engine's slot layout.

    ``cfg`` is a streaming-op ``ModelConfig``; ``params`` its fp32 weights
    on ``device`` (random from ``seed`` when omitted: fine for plumbing,
    useless for acceptance).  ``sampling`` is the draft law; a non-greedy
    drafter emits its warped q so the verifier runs distribution-preserving
    speculative sampling.  Proposals are full width, on the device.

    ``stats`` counts the drafter's kernel work: ``admissions`` (prefills,
    one chunk-kernel launch per layer each) and ``steps`` (decode steps,
    one step-kernel launch per layer each: catch-up and draft steps).

    On ``mesh`` ``params`` (plain tensors, the same on every rank, or
    DTensors) are placed by ``sharding.param_shardings`` and the pool by
    the decode states' placements.
    """

    full_width = True

    def __init__(self, cfg, params=None, *, slots: int, k: int,
                 sampling: SamplingConfig = SamplingConfig(), seed: int = 0,
                 device="cuda", mesh=None):
        if not seq_op.op_for(cfg).streaming:
            raise ValueError(f"HLADrafter needs a streaming-state op, got "
                             f"{cfg.mixer!r}")
        device = torch.device(device)
        self.cfg = cfg
        self.k = k
        self.sampling = sampling
        self.emits_probs = sampling.method != "greedy"
        self.vocab = cfg.vocab
        self.device = device
        self.mesh = mesh
        if params is None:
            params = init_params(lm.lm_specs(cfg), seed, device)
        pool_pl = None
        if mesh is not None:
            from torch.distributed.tensor import DTensor

            from ...distributed import steps as steps_mod

            if not any(isinstance(x, DTensor)
                       for _, x in leaf_paths(params)):
                params = shd.distribute(params, shd.param_shardings(
                    lm.lm_specs(cfg), mesh), mesh)
            pool_pl = steps_mod.state_shardings_for(
                cfg, mesh, lm.lm_init_states(cfg, slots, "meta"))
        self.params = lm.cast_params(params, cfg)
        self.pool = StatePool(lambda n: lm.lm_init_states(cfg, n, device),
                              slots, mesh=mesh, placements=pool_pl)
        self.last = np.zeros(slots, np.int64)
        # committed tokens the draft state has not consumed yet (at most
        # k+1 per slot between rounds: a round commits at most k+1)
        self._pending: List[List[int]] = [[] for _ in range(slots)]
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed + 1)
        # the rollback's masked consume
        self._consume = make_replay(cfg, mesh=mesh)
        self.stats = dict(admissions=0, steps=0)

    @torch.no_grad()
    def admit(self, slot, tokens):
        toks = [int(t) for t in tokens]
        prompt = to_device([toks[:-1]], self.device)
        with shd.use_mesh(self.mesh):
            _, state = lm.lm_prefill(
                self.params, shd.batch_rows(prompt, self.mesh), self.cfg)
        self.pool.write_slot(slot, state)
        self.stats["admissions"] += 1
        self.last[slot] = toks[-1]
        self._pending[slot] = []

    def commit(self, slot, tokens):
        toks = [int(t) for t in tokens]
        # the draft state ends up having consumed all but the newest
        # committed token (that one is the next model input)
        self._pending[slot].extend([int(self.last[slot])] + toks[:-1])
        if len(self._pending[slot]) > self.k + 1:
            raise RuntimeError("draft state fell behind: propose() must run "
                               "between commits (pending > k+1 tokens)")
        self.last[slot] = toks[-1]

    def evict(self, slot):
        self._pending[slot] = []
        self.last[slot] = 0

    @torch.no_grad()
    def propose(self, slot_ids, k):
        if k != self.k:
            raise ValueError(f"drafter built for k={self.k}, asked for {k}")
        slots = self.pool.slots
        pending = np.zeros((slots, k + 1), np.int64)
        pend_len = [len(p) for p in self._pending]
        for s, p in enumerate(self._pending):
            pending[s, :len(p)] = p
        self._pending = [[] for _ in range(slots)]
        # 1) catch up with the last round's committed tokens, in the pool
        steps = self._consume(self.params, self.pool,
                              to_device(pending, self.device),
                              pend_len)
        # 2) k draft steps on a copy of the pool (its placements kept):
        # its states are dropped
        states = tree_map(torch.clone, self.pool.states)
        tok = to_device(self.last[:, None], self.device)
        drafts, qs = [], []
        for _ in range(k):
            with shd.use_mesh(self.mesh):
                logits, _, _ = lm.lm_apply(
                    self.params, shd.batch_rows(tok, self.mesh), self.cfg,
                    states=states, mode="decode")
            lg = shd.full(logits[:, -1])
            nxt = sample(lg, self.gen, self.sampling)
            if self.emits_probs:
                qs.append(probs(lg, self.sampling))
            drafts.append(nxt)
            tok = nxt[:, None]
        self.stats["steps"] += steps + k
        q = torch.stack(qs, 1) if self.emits_probs else None
        return torch.stack(drafts, 1), q


# --------------------------------------------------------------------------
# factory
# --------------------------------------------------------------------------


def build_drafter(spec, *, slots: int, sampling: SamplingConfig,
                  target_cfg=None, device="cuda", mesh=None) -> Drafter:
    """Resolve ``SpecConfig.drafter`` to an instance: a ready ``Drafter``,
    ``"ngram"``, or ``"lm"`` (``spec.draft_arch`` from the configs
    registry, reduced unless ``spec.draft_reduced`` is False, random
    weights from ``spec.draft_seed``; on ``mesh``, the engine's).  With ``target_cfg`` the draft model
    takes the target's vocabulary (a draft must propose the target's token
    ids; the reference refuses the pair instead, so its reduced draft
    serves only a reduced target) and a draft no smaller than the target
    warns."""
    if isinstance(spec.drafter, Drafter):
        return spec.drafter
    if spec.drafter == "ngram":
        return NGramDrafter(max_n=spec.ngram_max, min_n=spec.ngram_min)
    if spec.drafter == "lm":
        from ...configs import get_config

        cfg = get_config(spec.draft_arch, reduced=spec.draft_reduced)
        if target_cfg is not None:
            cfg = cfg.replace(vocab=target_cfg.vocab)
            draft_cost = cfg.n_layers * cfg.d_model**2
            target_cost = target_cfg.n_layers * target_cfg.d_model**2
            if draft_cost >= target_cost:
                warnings.warn(
                    f"draft model {cfg.name!r} ({cfg.n_layers}L x "
                    f"{cfg.d_model}d) is not smaller than the target "
                    f"({target_cfg.n_layers}L x {target_cfg.d_model}d): "
                    "drafting costs as much as decoding, so speculative "
                    "decode cannot win; point draft_arch at a smaller "
                    "registry entry", stacklevel=2)
        return HLADrafter(cfg, None, slots=slots, k=spec.k,
                          sampling=sampling, seed=spec.draft_seed,
                          device=device, mesh=mesh)
    raise ValueError(f"unknown drafter {spec.drafter!r}")
