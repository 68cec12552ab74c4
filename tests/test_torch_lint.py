"""reprolint's engine checkers over the port's engine.

``sync-point`` and ``retrace-hazard`` apply to the JAX engine's path
alone (``is_engine_file``), so the whole-repo lint never visits
``src/repro_torch/serving/engine.py``. These tests call each checker's
``check`` on that file directly: the port's run-execution hot paths carry
the same names as ``JaxEngine``'s, and each host read there (an upload of
host ints, a numpy row after the run's one sync) is annotated with its
reason.
"""
import re
from pathlib import Path

import pytest

from repro.analysis.base import SourceFile
from repro.analysis.retrace import RetraceHazardChecker
from repro.analysis.sync_points import SyncPointChecker

ENGINE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "serving" / "engine.py"


@pytest.mark.parametrize("checker", [SyncPointChecker, RetraceHazardChecker],
                         ids=lambda c: c.name)
def test_port_engine_has_no_unsuppressed_finding(checker):
    findings = list(checker().check(SourceFile(ENGINE)))
    assert findings == [], "\n".join(str(f) for f in findings)


def test_sync_point_checker_visits_the_port_engine():
    """With its suppressions stripped, the port's engine gives the
    sync-point checker the host reads it annotates: the check above is not
    vacuous (the checker reaches the port's hot paths)."""
    text = ENGINE.read_text()
    bare = re.sub(r"#\s*reprolint:\s*disable=sync-point", "#", text)
    lines = sorted(f.line for f in SyncPointChecker().check(
        SourceFile(ENGINE, text=bare)))
    annotated = [i + 2 for i, line in enumerate(text.splitlines())
                 if "reprolint: disable=sync-point" in line]
    assert lines == annotated
