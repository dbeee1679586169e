"""Machine-checked invariants of the port: the RPR rule set, in torch's
forms (own copy of ``repro/analysis/checks``).

``python -m repro_torch.analysis.checks`` lints ``src/repro_torch``;
library use goes through :func:`run_checks`.  The run-time counterpart
(the entry points' contracts) lives in ``repro_torch.analysis.contracts``.
"""

from .findings import Baseline, Finding, fingerprint, to_json  # noqa: F401
from .rules import ALL_RULES, RULES_BY_CODE  # noqa: F401
from .runner import collect_modules, make_baseline, run_checks  # noqa: F401
