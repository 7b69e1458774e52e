"""Rule registry for the AST lint layer.

Counterpart of ``repro.analysis.rules``. Adding a rule: write
``rNNN_short_name.py`` beside the existing ones with a class exposing
``rule_id`` / ``title`` / ``applies_to(path)`` / ``check(tree, source,
path)``, then append an instance here. Keep rule modules single-purpose
(one hazard class per rule) and name, in the module docstring, the bug
that motivated it in the port's own terms.
"""
from repro_torch.analysis.rules.r001_clamped_ids import ClampedIdsRule
from repro_torch.analysis.rules.r002_bare_assert import BareAssertRule
from repro_torch.analysis.rules.r003_global_rng import GlobalRngRule
from repro_torch.analysis.rules.r004_host_sync import HostSyncRule
from repro_torch.analysis.rules.r005_accumulation import AccumulationRule
from repro_torch.analysis.rules.r006_swallowed_except import SwallowedExceptRule

ALL_RULES = [
    ClampedIdsRule(),
    BareAssertRule(),
    GlobalRngRule(),
    HostSyncRule(),
    AccumulationRule(),
    SwallowedExceptRule(),
]

RULES_BY_ID = {r.rule_id: r for r in ALL_RULES}
