"""The finding record and its JSON form (the port's copy of what the graph
check uses of ``tpu9/analysis/findings.py``): the same fields, the same
line-number-independent fingerprint and the same ``--format json`` record,
schema version 1, so one consumer parses both packages' reports."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

# a version bump is a reviewed change: adding keys is compatible,
# renaming or removing one is not
JSON_SCHEMA_VERSION = 1


@dataclass
class Finding:
    rule: str
    path: str            # repo-relative, posix separators
    line: int            # 1-based
    col: int
    message: str
    symbol: str = "<module>"   # enclosing function/class qualname
    occurrence: int = 0        # k-th finding of (rule, path, symbol)

    @property
    def fingerprint(self) -> str:
        """``rule | path | symbol | occurrence``: an edit above the flagged
        site does not change it, a second occurrence does."""
        key = f"{self.rule}|{self.path}|{self.symbol}|{self.occurrence}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.symbol}] {self.message}")


def finding_json(f: Finding, status: str = "new") -> dict:
    """The stable ``--format json`` record of one finding. ``status`` is
    ``new`` (a Pass B finding) or ``graph`` (Pass A: not anchored in a
    file, so line and col are 0 and ``file`` is ``graph://<cell>``)."""
    return {"file": f.path, "line": f.line, "col": f.col, "rule": f.rule,
            "symbol": f.symbol, "occurrence": f.occurrence,
            "message": f.message, "fingerprint": f.fingerprint,
            "status": status}
