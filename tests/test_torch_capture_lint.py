"""The port's capture lint (``paddle_tpu_torch/analysis``) on the CPU.

For each rule a bad fixture it flags and a good one it passes (source
strings, handed to the step-program helper as a step function the way the
engine does); suppressions; reachability; every name of ``CAPTURED``
resolving to a function of the port; the code this slice repaired
(``GPTModel.forward``'s host copy of the start position and the quantizer's
host-made constant) flagged as it was; and the gate: zero unsuppressed
findings over ``paddle_tpu_torch/``.
"""
import pathlib
import textwrap

import pytest

from paddle_tpu_torch.analysis import CAPTURED, run_analysis
from paddle_tpu_torch.analysis.capture import CaptureAnalyzer
from paddle_tpu_torch.analysis.common import SourceFile, load_corpus

ROOT = pathlib.Path(__file__).resolve().parents[1]

# a module whose step function the engine-style call hands to the helper
HEADER = """
import torch
import numpy as np

class Engine:
    def step(self):
        return self._graphs.program("key", step_fn, None)
"""

CASES = {
    "traced-branch": (
        """
        def step_fn(x, n: int):
            if x.sum() > 0:
                return x
            return -x
        """,
        """
        def step_fn(x, n: int):
            if x is None or x.dim() != 2 or n > 3:
                return x
            return torch.where(x.sum() > 0, x, -x)
        """),
    "traced-cast": (
        """
        def step_fn(x):
            return x[: int(x.max())] + x.item() + x.cpu().numpy()
        """,
        """
        def step_fn(x):
            return x[: int(x.shape[0]) - 1] * float(2)
        """),
    "mutable-global-capture": (
        """
        _CACHE = {}

        def step_fn(x):
            return x * _CACHE.get(x.device, 1)
        """,
        """
        import types
        _TABLE = types.MappingProxyType({"a": 1})
        _DIMS = (32, 64)

        def step_fn(x):
            return x * _TABLE["a"] + _DIMS[0]
        """),
    "shape-from-data": (
        """
        def step_fn(x, mask):
            return x.nonzero(), torch.where(mask), x[x > 0]
        """,
        """
        def step_fn(x, mask):
            return torch.where(mask, x, 0), x[:, 0]
        """),
    "host-transfer": (
        """
        def step_fn(x, n: int):
            dev = x.device
            return (x + torch.tensor([1, 2], device=dev)
                    + torch.as_tensor(n, device=dev) + x.to(dev) + x.cuda())
        """,
        """
        def step_fn(x, n: int):
            return x + torch.full((1,), n, device=x.device) + x.to(
                torch.int32)
        """),
}


def _report(body, captured=(), header=HEADER):
    text = header + textwrap.dedent(body)
    sf = SourceFile("fixture.py", "fixture.py", text)
    assert sf.parse_error is None, sf.parse_error
    return run_analysis(root=str(ROOT), corpus=[sf], captured=captured)


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_flags_bad_fixture(rule):
    report = _report(CASES[rule][0])
    rules = {f.rule for f in report.findings}
    assert rule in rules, [str(f) for f in report.findings]


@pytest.mark.parametrize("rule", sorted(CASES))
def test_rule_passes_good_fixture(rule):
    report = _report(CASES[rule][1])
    assert report.findings == [], [str(f) for f in report.findings]


def test_each_host_transfer_form_is_flagged():
    lines = {f.line for f in _report(CASES["host-transfer"][0]).findings
             if f.rule == "host-transfer"}
    text = HEADER + textwrap.dedent(CASES["host-transfer"][0])
    want = {i for i, line in enumerate(text.splitlines(), 1)
            if "torch.tensor" in line or "as_tensor" in line
            or ".cuda()" in line}
    assert want <= lines and len(want) == 2


SUPPRESSED = """
_CACHE = {}

def step_fn(x):
    # analysis: allow(mutable-global-capture) — %s
    return x * _CACHE.get(x.device, 1)
"""


def test_suppression_needs_a_reason():
    ok = _report(SUPPRESSED % "filled before capture, kept for good")
    assert ok.findings == [] and len(ok.suppressed) == 1
    bare = _report(SUPPRESSED.replace(" — %s", ""))
    assert [f.rule for f in bare.findings] == ["suppression-missing-reason"]


def test_reachability_follows_calls_and_methods():
    """Module functions called by name and methods called through self are
    captured from an entry point; an unreached function is not linted."""
    body = """
    class Engine:
        def step(self):
            return self._graphs.program("key", self._fn, None)

        def _fn(self, x):
            return self._helper(x)

        def _helper(self, x):
            return lower(x)

        def host_side(self, x):
            return int(x.sum())

    def lower(x):
        return int(x.sum())
    """
    sf = SourceFile("fixture.py", "fixture.py", textwrap.dedent(body))
    fns = CaptureAnalyzer(()).reachable(sf)
    captured = {q for q, f in fns.items() if f.captured}
    assert captured == {"Engine._fn", "Engine._helper", "lower"}
    report = run_analysis(root=str(ROOT), corpus=[sf], captured=())
    assert [(f.rule, f.scope) for f in report.findings] \
        == [("traced-cast", "lower")]


def test_static_returns_and_annotations_keep_values_static():
    """A same-module helper returning a stride, and parameters annotated
    ``int`` / ``torch.dtype``, are static; a helper returning a tensor is
    not."""
    body = """
    def step_fn(x, bs: int, dt: torch.dtype):
        if stride_of(x) != bs or dt == torch.int8:
            return x
        if twice(x) > 0:
            return x
        return x

    def stride_of(t):
        return t.stride(0)

    def twice(t):
        return t * 2
    """
    report = _report(body)
    assert [(f.rule, f.line) for f in report.findings] == [
        ("traced-branch",
         (HEADER + textwrap.dedent(body)).splitlines().index(
             "    if twice(x) > 0:") + 1)]


# the two lines this slice repaired, as they read before it
BEFORE_REPAIR = {
    "paddle_tpu_torch/models/gpt.py:GPTModel.forward": """
    import torch

    class GPTModel:
        def forward(self, input_ids, caches=None, start_pos=0):
            b, s = input_ids.shape
            dev = input_ids.device
            steps = torch.arange(s, device=dev)
            off = torch.as_tensor(start_pos, device=dev).long()
            return off + steps
    """,
    "paddle_tpu_torch/quantization/__init__.py:quantize_kv": """
    import torch

    _Q_MAX = {}

    def _scale(amax):
        q_max = _Q_MAX.get(amax.device)
        if q_max is None:
            q_max = _Q_MAX[amax.device] = torch.tensor(127.0,
                                                       device=amax.device)
        return torch.clamp_min(amax, 1e-9) / q_max

    def quantize_kv(x):
        return _scale(x.float().abs().amax(dim=(-2, -1)))
    """,
}


@pytest.mark.parametrize("name", sorted(BEFORE_REPAIR))
def test_pre_repair_code_is_flagged(name):
    path = name.partition(":")[0]
    sf = SourceFile(path, path, textwrap.dedent(BEFORE_REPAIR[name]))
    report = run_analysis(root=str(ROOT), corpus=[sf])
    assert "host-transfer" in {f.rule for f in report.findings}


@pytest.mark.parametrize("name", CAPTURED)
def test_captured_names_resolve(name):
    path, _, qual = name.partition(":")
    (sf,) = load_corpus([path], str(ROOT))
    fns = CaptureAnalyzer().reachable(sf)
    assert qual in fns and fns[qual].captured


def test_engine_step_functions_are_entry_points():
    (sf,) = load_corpus(["paddle_tpu_torch/serving/engine.py"], str(ROOT))
    fns = CaptureAnalyzer().reachable(sf)
    for qual in ("ServingEngine._decode_fn", "ServingEngine._full_prefill_fn",
                 "ServingEngine._suffix_prefill_fn"):
        assert fns[qual].captured, qual
    # the host side: the step's caller and its build counters
    for qual in ("ServingEngine.decode_step", "ServingEngine._decode_built",
                 "ServingEngine._prefill_built"):
        assert not fns[qual].captured, qual


def test_gate_port_has_no_unsuppressed_findings():
    report = run_analysis(root=str(ROOT))
    assert report.files > 30 and report.parse_errors == {}
    assert report.findings == [], "\n".join(map(str, report.findings))
    # what stays on purpose carries its reason
    sfs = {sf.relpath: sf for sf in load_corpus(["paddle_tpu_torch"],
                                                str(ROOT))}
    for f in report.suppressed:
        assert sfs[f.path].suppression_for(f.rule, f.line).reason
