"""Checks of the port beyond its tests: the run-time contracts of the hot
entry points (:mod:`repro_torch.analysis.contracts`) and the invariant
linter (:mod:`repro_torch.analysis.checks`).  The reference's third piece,
the HLO parser ``hlo_analysis``, has no twin: eager PyTorch lowers no HLO
(``torch.utils.flop_counter`` and a ``TorchDispatchMode`` stand in)."""
