"""Violation reporting + `# ctpulint: allow(...)` suppression policy.

A violation pins one defect to one `file:line`. Suppressions are inline
comments on the violating line (or the line directly above it):

    # ctpulint: allow(<check>, reason=<why this is safe>)

The reason is MANDATORY — an allow without one is itself reported (the
allowlist is documentation, not an off switch), and `python -m
cassandra_tpu_torch.analysis --explain` prints every active suppression with its reason so the
allowlist stays auditable.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

# the closing paren is anchored at end-of-line so a reason may itself
# contain parentheses
_ALLOW_RE = re.compile(
    r"#\s*ctpulint:\s*allow\(\s*(?P<check>[a-z][a-z0-9-]*)\s*"
    r"(?:,\s*reason\s*=\s*(?P<reason>.*\S))?\s*\)\s*$")


@dataclass
class Violation:
    check: str
    path: str          # repo-relative
    line: int
    message: str
    suppressed_by: "Suppression | None" = None

    def __str__(self) -> str:
        return f"{self.path}:{self.line}  [{self.check}]  {self.message}"


@dataclass
class Suppression:
    check: str
    path: str
    line: int          # line the comment sits on
    reason: str | None
    used: bool = field(default=False, compare=False)

    def __str__(self) -> str:
        why = self.reason if self.reason else "<NO REASON GIVEN>"
        return f"{self.path}:{self.line}  allow({self.check}): {why}"


def parse_suppressions(path: str, text: str) -> list[Suppression]:
    out = []
    for i, line in enumerate(text.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            out.append(Suppression(m.group("check"), path, i,
                                   m.group("reason")))
    return out


def apply_suppressions(violations: list[Violation],
                       supps: list[Suppression]) -> list[Violation]:
    """Mark violations covered by an allow comment on the same line or
    the line directly above; returns the UNSUPPRESSED remainder. A
    reasonless allow never suppresses (it is reported separately by
    reasonless())."""
    by_site = {}
    for s in supps:
        if s.reason:
            by_site[(s.path, s.check, s.line)] = s
    remaining = []
    for v in violations:
        s = by_site.get((v.path, v.check, v.line)) \
            or by_site.get((v.path, v.check, v.line - 1))
        if s is not None:
            v.suppressed_by = s
            s.used = True
        else:
            remaining.append(v)
    return remaining


def reasonless(supps: list[Suppression]) -> list[Violation]:
    """Every allow() missing its reason, as violations of the
    `suppression` meta-check."""
    return [Violation("suppression", s.path, s.line,
                      f"allow({s.check}) carries no reason= — the "
                      "allowlist is documentation, write down why this "
                      "site is safe")
            for s in supps if not s.reason]
