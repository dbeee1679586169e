"""Chunk-parallel verification and state rollback for speculative decoding
(twin of ``repro/serving/spec/verify.py``).

Verification is one prefill: ``lm.lm_score_block`` runs the block

    [t_last, d_1, ..., d_k]          (k+1 tokens per slot)

through ONE chunkwise kernel launch per layer with the pool's states as
the carry, so ``logits[:, j]`` is the target's next-token law after the
committed context plus ``d_1..d_j``: the law plain decode would have drawn
``d_{j+1}`` from.  By the paper's Section 4 identity the chunkwise pass
reproduces the serial recurrence, but only in exact arithmetic: verify
runs the chunk kernel and decode the step kernel, which sum in different
orders, so a near-tied argmax may part.  Token-for-token equality with
plain greedy decode is a property of fp32 activations, not of bf16.

Acceptance rules (as in the reference)
--------------------------------------
* **greedy**: accept the longest prefix with ``argmax(logits[:, j]) ==
  d_{j+1}``; the token at the first mismatch (or the bonus token after a
  full block) is the argmax itself, so every committed token is the one
  plain greedy decode emits there.
* **speculative sampling** (Leviathan et al.; Chen et al.): accept ``d_j``
  with probability ``min(1, p(d_j) / q(d_j))``; at the first rejection draw
  from the residual ``norm(max(p - q, 0))``; after a full block draw the
  bonus from ``p``.  ``p`` and ``q`` are the warped laws of
  ``sampling.probs``.  A deterministic drafter (n-gram) is ``q = one-hot``:
  accept with probability ``p(d_j)``, residual ``p`` with the draft zeroed.

State rollback over in-place decode state
-----------------------------------------
The reference keeps the pre-verify pool (its trees are immutable) and
replays each slot's accepted prefix with a masked ``lax.scan`` that
selects, per step, the new state for slots still consuming and the old
one for the rest.  The port's decode step rewrites every row of the pool
in place, so there is no old value to select.  Instead:

* verify leaves the pool as it was (the chunk kernels read their carry and
  write new tensors), so until the round writes it the pool IS the
  pre-verify state;
* a round in which every active slot accepted its whole block copies the
  verify states into the pool (they consumed exactly the committed
  tokens); the pool keeps its tensors, as the reference's round donates
  them;
* otherwise ``make_replay`` steps the whole pool through the block with
  the same decode steps plain decode runs, at the same batch width, and
  freezes each slot once its committed prefix is consumed: a copy of the
  slot taken just before its first step too many, written back at the end.
  So every slot's state equals plain decode steps over its committed
  prefix, bit for bit.

Host transfers: the round needs the accept counts on the host to choose
between the swap and the replay.  A round moves the packed accept counts
and committed tokens together with the verify states' health flags in ONE
transfer; a fully-accepted round stops there.  A rejection round makes one
more: the health flags of the replayed pool, which become the quarantine
flags (the verify states' flags are then stale).
"""

from __future__ import annotations

import numpy as np
import torch

from ...models import lm
from ..sampling import SamplingConfig, draw, probs
from ..state_pool import to_device


def _leading_run(ok: torch.Tensor) -> torch.Tensor:
    """Length of the leading all-True run per row.  ok: (B, k) bool."""
    return torch.cumprod(ok.long(), dim=1).sum(1)


def make_verify(cfg, scfg: SamplingConfig, *, draft_probs: bool = False):
    """The verify step.  Returns ``verify(params, states, tok_block,
    generator, q_probs=None) -> (packed, new_states)``: ``tok_block (slots,
    k+1) = [last committed, drafts]``; ``packed (slots, k+2)`` int64 holds
    the accepted count ``m`` in column 0 and the committed tokens after it
    (the first ``m + 1`` count); ``new_states`` have consumed the whole
    block and ``states`` are left as they were.  ``q_probs (slots, k,
    vocab)``, the drafter's warped laws, is read only under
    ``draft_probs``; greedy acceptance never reads it."""

    def verify(params, states, tok_block, generator, q_probs=None):
        logits, new_states = lm.lm_score_block(params, tok_block, cfg,
                                               states=states)
        drafts = tok_block[:, 1:]
        if scfg.method == "greedy":
            # accepted drafts ARE the argmax predictions, so ``preds`` is
            # also the committed-token row
            preds = logits.argmax(-1)
            n_acc = _leading_run(preds[:, :-1] == drafts)
            return torch.cat([n_acc[:, None], preds], 1), new_states
        p = probs(logits, scfg)  # (slots, k+1, vocab) warped target law
        pk = p[:, :-1]
        p_d = pk.gather(-1, drafts[..., None])[..., 0]
        if q_probs is None or not draft_probs:  # q = one-hot(draft)
            q_d = torch.ones_like(p_d)
            resid = pk.scatter(-1, drafts[..., None], 0.0)
        else:
            q_d = q_probs.gather(-1, drafts[..., None])[..., 0]
            resid = (pk - q_probs).clamp_min(0.0)
        u = torch.rand(drafts.shape, generator=generator,
                       device=drafts.device)
        # u q <= p  <=>  u <= p / q, without the 0/0 hazard
        n_acc = _leading_run(u * q_d <= p_d)
        # the residual law at the rejection index; a zero residual means
        # p == q there (rejection probability 0): any law will do, take p
        rs = resid.sum(-1, keepdim=True)
        resid = torch.where(rs > 0, resid / rs.clamp_min(1e-30), pk)
        dist = torch.cat([resid, p[:, -1:]], 1)
        dist_m = dist.gather(
            1, n_acc[:, None, None].expand(-1, 1, dist.shape[-1]))[:, 0]
        corr = draw(dist_m, generator)
        drafts_pad = torch.cat([drafts, drafts[:, -1:]], 1)
        jpos = torch.arange(drafts_pad.shape[1], device=drafts.device)
        committed = torch.where(jpos[None] == n_acc[:, None], corr[:, None],
                                drafts_pad)
        return torch.cat([n_acc[:, None], committed], 1), new_states

    return verify


def make_replay(cfg):
    """The masked serial consume behind rollback AND the draft model's
    catch-up.  Returns ``replay(params, pool, toks, n_consume) -> steps``:
    slot ``s`` of ``pool`` consumes the first ``n_consume[s]`` tokens of
    ``toks (slots, W)`` through the decode steps plain decode runs (in
    place, every row, the pool's full batch), and every other step of it is
    undone by a copy of the slot taken before that step.  ``n_consume`` is
    a host sequence; ``steps`` is the number of decode steps run, its
    largest entry.
    """

    def replay(params, pool, toks, n_consume) -> int:
        n_consume = [int(n) for n in n_consume]
        width = max(n_consume, default=0)
        held = {}
        for j in range(width):
            for s, n in enumerate(n_consume):
                if n == j:  # consumed its prefix: freeze it from here on
                    held[s] = pool.snapshot_slot(s)
            lm.lm_apply(params, toks[:, j:j + 1], cfg, states=pool.states,
                        mode="decode")
        for s, snap in held.items():
            pool.restore_slot(s, snap)
        return width

    return replay


def make_spec_round(cfg, scfg: SamplingConfig, *, draft_probs: bool = False):
    """Verify, accept, roll back and advance in one call: the engine's
    speculative hot path.

    ``round(params, pool, tokens, active, drafts, generator, q=None) ->
    (packed, finite, new_tokens, replay_steps)``:

    * ``packed`` (host, ``(slots, k+2)``): the verify output;
    * ``finite`` (host, ``(slots,)`` bool): the quarantine flags, of the
      verify states on a fully-accepted round, else of the replayed pool;
    * ``new_tokens`` (device, ``(slots, 1)``): each active slot's newest
      committed token, inactive slots' as they were;
    * ``replay_steps``: decode steps the rollback ran (0 without one).

    ``pool`` ends holding every slot's post-round state, in its own
    tensors.  ``active`` is a
    host bool array; ``tokens (slots, 1)`` and ``drafts (slots, k)`` are on
    the pool's device.
    """
    verify = make_verify(cfg, scfg, draft_probs=draft_probs)
    replay = make_replay(cfg)

    def round_fn(params, pool, tokens, active, drafts, generator, q=None):
        k = drafts.shape[1]
        tok_block = torch.cat([tokens, drafts.to(tokens.dtype)], 1)
        packed, ver_states = verify(params, pool.states, tok_block,
                                    generator, q)
        active_dev = to_device(active, tokens.device)
        last = packed.gather(1, packed[:, :1] + 1)
        new_tokens = torch.where(active_dev[:, None], last, tokens)
        finite = pool.finite_mask(ver_states)
        # sync-point: the round's one transfer (commits + verify-state health)
        host = torch.cat([packed, finite[:, None].long()], 1).cpu().numpy()
        packed_h, finite_h = host[:, :-1], host[:, -1].astype(bool)
        n_comm = np.where(active, packed_h[:, 0] + 1, 0)
        if (n_comm[active] == k + 1).all():
            # no rollback: the verify states become the pool's, copied into
            # its own tensors (the round donates the pool)
            for dst, src in zip(pool.states, ver_states):
                dst.copy_(src)
            return packed_h, finite_h, new_tokens, 0
        steps = replay(params, pool, tok_block, n_comm)
        # sync-point: a rejection round's second transfer (replayed health)
        finite_h = pool.finite_mask().cpu().numpy()
        return packed_h, finite_h, new_tokens, steps

    return round_fn
