"""R003 — every random draw names its ``torch.Generator``.

The reference's R003 catches a PRNG key consumed twice: the reference
once drew the first sampled token of every request from the caller's base
key, correlating the first draw across requests. Torch has no key to reuse; its
hazard of the same class is a draw from the process-wide default
generator. Such a draw interleaves with every other draw in the process,
so a request's sampled tokens depend on which requests were served before
it and in what order, and two runs of one request stop agreeing. The port
draws from generators it owns: one seeded per (seed, uid, token index) for
sampling (``serve/engine._request_generator``), one per adapter store
(``serve/adapters.TaskAdapterStore.randomize``), the model's init
generator, the samplers' ``generator=`` arguments.

Flagged, anywhere in the package: ``torch.rand``, ``randn``, ``randint``,
``randperm``, ``normal``, ``bernoulli``, ``multinomial``, ``poisson``,
their ``*_like`` forms (which take no generator at all), and the in-place
draws ``.normal_``, ``.uniform_``, ``.bernoulli_``, ``.exponential_``,
``.random_``, ``.cauchy_``, ``.log_normal_``, ``.geometric_`` and the
methods ``.multinomial`` / ``.bernoulli``, when called without
``generator=`` (or, for ``torch.*`` calls, without a generator passed
positionally where the signature allows none: the rule asks for the
keyword).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import dotted_name, keyword_names

_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
                "multinomial", "poisson", "rand_like", "randn_like", "randint_like"}
_METHOD_DRAWS = {"normal_", "uniform_", "bernoulli_", "exponential_", "random_", "cauchy_",
                 "log_normal_", "geometric_", "multinomial", "bernoulli"}


class GlobalRngRule:
    rule_id = "R003"
    title = "random draw from torch's default generator (no generator=)"

    def applies_to(self, path: str) -> bool:
        return True

    def check(self, tree: ast.AST, source: str, path: str) -> list[Finding]:
        findings = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                continue
            name = dotted_name(node.func) or ""
            attr = node.func.attr
            if name in {f"torch.{d}" for d in _TORCH_DRAWS}:
                pass
            elif attr in _METHOD_DRAWS and not name.startswith(("torch.", "np.", "numpy.")):
                if "rng" in name.split(".")[0] or name.startswith("random."):
                    continue  # numpy / stdlib generators own their state
            else:
                continue
            if "generator" in keyword_names(node):
                continue
            findings.append(Finding(
                rule=self.rule_id, path=path, line=node.lineno,
                message=(
                    f"{name or attr} draws from torch's process-wide default generator — "
                    "a request's draws then depend on every other draw in the process "
                    "and on the order requests were served (the correlated-draw "
                    "bug class); pass generator= a torch.Generator seeded for this "
                    "stream"
                ),
            ))
        return findings
