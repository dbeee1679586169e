"""The ``SequenceOp`` registry: one record per sequence-mixing operator.

Twin of ``repro/models/seq_op.py``.  A record carries the sublayer's
``specs``, full-sequence ``forward`` (train / chunk-parallel prefill),
one-token ``step`` (decode) and ``init_state``; ``lm.py``, the serving
engine and the cost model program against the record only, and a layer
keeps the record's parameters under its ``param_key``.  State trees are
whatever ``init_state`` returns (``models/state_tree.py`` walks them).
The port registers the HLA family, ``hla2``, ``ahla``, ``hla3``,
``hla3_paper`` and ``linattn`` (``models/mixer.py``), softmax
attention, ``attn`` (``models/attention.py``), gated linear attention,
``gla`` (``models/gla.py``, the registry's worked example), Mamba,
``mamba`` (``models/ssm.py``), and the self-contained RWKV-6 layer,
``rwkv6`` (``models/rwkv6.py``).

Capability flags (the reference's): ``streaming`` (a constant-size
per-slot decode state, so slots batch continuously; requires a ``step``),
``has_fused_kernels`` (the record's train/prefill/decode paths launch
hand-written kernels, chosen inside the record), ``spec_decodable`` (the
state can be snapshot and rolled back, so speculative decoding may verify
over it), ``needs_positions`` (consumes absolute positions, e.g. RoPE),
``self_contained`` (owns its norms and channel mix, replacing the whole
block), ``prealloc_state`` (a prefill given no state starts from a preallocated
one: a KV cache, which it fills in place, or, as the reference's mamba
has it, a zero carry).

Sharding data (the reference's): ``state_axes(cfg)`` is a tree of
``param.Axes`` matching ``init_state``'s tree leaf for leaf, the logical
axes of every decode-state leaf (``distributed/steps.py::state_axes``
resolves them against a mesh for the serving pool and the dry run);
``state_ndims(cfg)`` optionally gives each leaf's rank, which
``resolve_state_ndims`` otherwise reads from an ``init_state`` on the
meta device.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Callable, Dict, Optional, Tuple

import torch


class SequenceOpError(KeyError):
    """Unknown or duplicate operator: the message lists the registry."""


@dataclasses.dataclass(frozen=True, eq=False)
class SequenceOp:
    name: str
    specs: Callable[[Any], Any]
    forward: Callable[..., Any]
    init_state: Callable[..., Any]
    step: Optional[Callable[..., Any]] = None
    state_axes: Optional[Callable[[Any], Any]] = None
    state_ndims: Optional[Callable[[Any], Any]] = None
    # capability flags
    streaming: bool = False
    has_fused_kernels: bool = False
    spec_decodable: bool = False
    needs_positions: bool = False
    self_contained: bool = False
    prealloc_state: bool = False
    # optional analytic-cost override read by ``obs/costs.py``:
    # ``cost_model(cfg, *, mode, seq_len, batch) -> dict`` may return
    # ``state_flops_per_token`` and/or ``state_bytes_per_token`` to replace
    # the family formula for this op's state math (projection FLOPs and
    # state bytes always come from the record's specs and init_state)
    cost_model: Optional[Callable[..., Dict[str, float]]] = None
    # key of the operator's params inside a layer's param dict (default:
    # its name; the HLA family keeps the reference's "mixer")
    param_key: Optional[str] = None

    def __post_init__(self):
        if self.param_key is None:
            object.__setattr__(self, "param_key", self.name)
        if self.streaming and self.step is None:
            raise SequenceOpError(
                f"op {self.name!r}: streaming=True requires a step()")

    def resolve_state_ndims(self, cfg):
        """Per-leaf ranks of the state tree: the ``state_ndims`` override,
        or read from an ``init_state`` on the meta device (no
        allocation)."""
        if self.state_ndims is not None:
            return self.state_ndims(cfg)
        from .state_tree import tree_map

        st = self.init_state(cfg, 1, torch.device("meta"), max_len=8)
        return tree_map(lambda x: x.ndim, st)


_REGISTRY: Dict[str, SequenceOp] = {}


def register_op(op: SequenceOp) -> SequenceOp:
    """Register ``op`` under ``op.name``; a second record for one name
    raises ``SequenceOpError``."""
    if not isinstance(op, SequenceOp):
        raise TypeError(f"register_op expects a SequenceOp, got {type(op)}")
    if op.name in _REGISTRY:
        raise SequenceOpError(
            f"sequence op {op.name!r} is already registered; "
            f"registered ops: {sorted(_REGISTRY)}")
    _REGISTRY[op.name] = op
    return op


def _ensure_builtins() -> None:
    # imported for their register_op side effect
    from . import attention, gla, mixer, rwkv6, ssm  # noqa: F401


def _unknown(name) -> SequenceOpError:
    known = sorted(_REGISTRY)
    close = difflib.get_close_matches(str(name), known, n=1)
    hint = f" (did you mean {close[0]!r}?)" if close else ""
    return SequenceOpError(
        f"unknown sequence op {name!r}{hint}; registered ops: {known}")


def get_op(name: str) -> SequenceOp:
    """The registered operator ``name``; an unknown name fails with the
    registry listing and the closest match."""
    _ensure_builtins()
    if name not in _REGISTRY:
        raise _unknown(name)
    return _REGISTRY[name]


def registered_op_names() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def streaming_op_names() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(n for n, op in _REGISTRY.items() if op.streaming))


def op_name_for(cfg) -> str:
    """The operator ``cfg.mixer`` names ("softmax" is the reference's
    spelling of "attn").  No fallback: an unknown name raises."""
    _ensure_builtins()
    name = "attn" if cfg.mixer == "softmax" else cfg.mixer
    if name not in _REGISTRY:
        raise _unknown(cfg.mixer)
    return name


def op_for(cfg) -> SequenceOp:
    """The registered operator ``cfg.mixer`` names."""
    return _REGISTRY[op_name_for(cfg)]
