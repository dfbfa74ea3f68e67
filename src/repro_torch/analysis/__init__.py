"""Device-hygiene static analysis of the PyTorch port, the counterpart
of the reference's `repro.analysis`:

* `astlint` + `rules` — lint rules over ``src/repro_torch`` for the
  torch hazards that stall the card inside a device scope (host reads,
  data-dependent Python branches, float64, ``prod``/``cumprod`` on a
  gradient path), plus the reference's nondeterminism, exception,
  mutable-default and clock rules, with a checked-in baseline;
* `contracts` — the engine contracts (`no_recompile`, `transfer_free`,
  `no_f64_constants`, `trace_fingerprint`) proven by counting engine
  builds and by recording the aten ops a call dispatches;
* `speclint` — static validation of `ArchSpec` declarations, which
  `archspec.compile_spec` runs;
* ``python -m repro_torch.analysis`` — the CLI gluing all three into
  one report (``analysis_report_torch.json``).
"""
from .astlint import LintViolation, lint_paths, lint_source  # noqa: F401
from .contracts import (ContractError, ContractResult,  # noqa: F401
                        assert_no_recompile, compiled_programs,
                        jaxpr_fingerprint, no_f64_constants, no_recompile,
                        trace_fingerprint, transfer_free)
from .rules import DEVICE_SCOPES, RULES, Rule  # noqa: F401
from .speclint import SpecIssue, SpecLintError, lint_spec  # noqa: F401
