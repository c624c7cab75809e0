"""The port's static analysis (counterpart of the ``run_analysis`` part of
``paddle_tpu/analysis/__init__.py``): the capture lint
(:mod:`~paddle_tpu_torch.analysis.capture`) over ``paddle_tpu_torch/``.

    python3 -m paddle_tpu_torch.analysis       # from the repository root

prints every unsuppressed finding and exits 1 if there is one. Findings
not covered by an inline ``# analysis: allow(<rule>) — <reason>`` fail the
gate (``tests/test_torch_capture_lint.py``).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

from .capture import CAPTURED, CaptureAnalyzer
from .common import Finding, Report, SourceFile, load_corpus

__all__ = ["run_analysis", "CAPTURED", "CaptureAnalyzer", "Finding",
           "Report", "SourceFile", "DEFAULT_PATHS"]

#: the corpus, relative to the repository root
DEFAULT_PATHS = ("paddle_tpu_torch",)


def run_analysis(*, root: str, corpus: Optional[List[SourceFile]] = None,
                 captured: Sequence[str] = CAPTURED) -> Report:
    """Run the capture lint over :data:`DEFAULT_PATHS` under ``root`` (or
    over ``corpus``). The report's ``findings`` are those no inline
    suppression covers, plus one ``suppression-missing-reason`` for each
    suppression used without a reason; ``suppressed`` keeps the covered
    ones."""
    if corpus is None:
        corpus = load_corpus(DEFAULT_PATHS, root)
    by_path = {sf.relpath: sf for sf in corpus}
    report = Report(files=len(corpus))
    for sf in corpus:
        if sf.parse_error is not None:
            report.parse_errors[sf.relpath] = sf.parse_error
    raw = CaptureAnalyzer(captured).analyze(corpus)
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        sup = by_path[f.path].suppression_for(f.rule, f.line)
        if sup is None:
            report.findings.append(f)
            continue
        report.suppressed.append(f)
        if not sup.reason:
            report.findings.append(Finding(
                "suppression-missing-reason", f.path, sup.line, f.scope,
                f"allow({f.rule}) has no reason: say why "
                f"(`# analysis: allow({f.rule}) — <reason>`)"))
    return report


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    report = run_analysis(root=root)
    for f in report.findings:
        print(f)
    for path, err in report.parse_errors.items():
        print(f"{path}: parse error: {err}")
    print(f"{report.files} files, {len(report.findings)} findings, "
          f"{len(report.suppressed)} suppressed")
    return 1 if report.findings or report.parse_errors else 0
