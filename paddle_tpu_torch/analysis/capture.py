"""Capture lint: the hazards that break a captured serving step (counterpart
of ``paddle_tpu/analysis/compiled.py``, the port's own copy).

The serving engine runs its decode step and prefill buckets as CUDA graphs
(``serving/graphs.py``): the Python of a step runs once, at capture, and
every later call replays the device work it recorded. So code reached from
a captured step must not read a tensor's value on the host, take a shape
from data, copy host data to the device, or read module state whose later
changes the graph would never see. Rules, under the JAX lint's names where
the meaning carries over:

* ``traced-branch`` -- a Python ``if``/``while`` on a tensor's value: at
  capture it syncs (which a capture refuses) or freezes one branch into
  the graph. ``is None`` checks, membership in a host container and static
  accessors (``.shape``, ``.ndim``, ``.dtype``, ``.device``, ``.dim()``,
  ``.stride()``, ``.data_ptr()``, ``len()``, ...) are fine.
* ``traced-cast`` -- ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``np.asarray()`` or ``int()``/``float()``/``bool()`` of a tensor (not of
  ``.shape``): a device-to-host copy, and a value frozen at capture.
* ``mutable-global-capture`` -- a module-level mutable (a dict, list or set
  literal or comprehension, or a name rebound through ``global``) read or
  written in captured code: the graph keeps the value, or the address,
  that it had at capture.
* ``shape-from-data`` -- ``nonzero``, ``unique``, ``argwhere``,
  ``masked_select``, one-argument ``where`` or boolean-mask indexing: an
  output shape that depends on data, which a graph cannot replay.
* ``host-transfer`` (new for PyTorch) -- ``torch.tensor(...)`` /
  ``torch.as_tensor(...)`` of host data, ``.to(<device>)`` or ``.cuda()``:
  a pageable host-to-device copy is not allowed while a stream captures,
  and its value would be frozen.

The JAX lint's ``use-after-donate`` has no counterpart: PyTorch has no
buffer donation.

Reachability is per module, as in ``compiled.py``. The entry points are
every step function a module hands to the step-program helper (the
``fn`` of ``StepGraphs.program(key, fn, on_build, ...)``, naming a function
or a method of the calling class) and the qualified names of :data:`CAPTURED`,
the functions the captured steps reach in other modules. From them the
lint follows calls of module functions by name and of methods through
``self``. Parameters are tensors unless annotated ``int``, ``float``,
``bool``, ``str``, ``torch.dtype`` or ``torch.device``; a call's value is a
tensor when its arguments are, unless the callee is a function of the same
module whose every return is static (a shape, stride, address or flag).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

from .common import Finding, SourceFile

#: functions the captured steps reach outside the engine's own step
#: functions, as ``path:qualname`` relative to the repository root
CAPTURED = (
    "paddle_tpu_torch/models/gpt.py:GPTModel.forward",
    "paddle_tpu_torch/models/gpt.py:GPTDecoderLayer.forward",
    "paddle_tpu_torch/models/gpt.py:GPTAttention.forward",
    "paddle_tpu_torch/models/gpt.py:GPTMLP.forward",
    "paddle_tpu_torch/models/gpt.py:_serving_linear",
    "paddle_tpu_torch/models/gpt.py:GPTForCausalLM._head_logits",
    "paddle_tpu_torch/ops/paged_attention.py:paged_decode_attention",
    "paddle_tpu_torch/ops/paged_attention.py:paged_prefill_attention",
    "paddle_tpu_torch/ops/paged_attention.py:paged_full_prefill_attention",
    "paddle_tpu_torch/ops/paged_attention.py:_launch",
    "paddle_tpu_torch/quantization/__init__.py:quantize_kv",
    "paddle_tpu_torch/serving/engine.py:_PagedCacheView.update_and_attend",
    "paddle_tpu_torch/serving/engine.py:_CapturePrefillView.update_and_attend",
    "paddle_tpu_torch/serving/engine.py:_PrefixPrefillView.update_and_attend",
    "paddle_tpu_torch/serving/engine.py:_scatter_rows",
    "paddle_tpu_torch/serving/sampling.py:sample_tokens",
    "paddle_tpu_torch/ops/sampling.py:sample",
    "paddle_tpu_torch/ops/sampling.py:_launch",
    "paddle_tpu_torch/ops/sampling.py:sample_ref",
    "paddle_tpu_torch/core/rng.py:prng_key",
    "paddle_tpu_torch/core/rng.py:fold_in",
    "paddle_tpu_torch/core/rng.py:uniform",
)

#: the step-program helper's method, whose second argument is the step
HELPER_CALLS = {"program"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "itemsize",
                 "layout", "type"}
_STATIC_METHODS = {"dim", "size", "stride", "numel", "nelement",
                   "element_size", "is_contiguous", "data_ptr",
                   "storage_offset", "is_floating_point", "get_device"}
_STATIC_CALLS = {"len", "isinstance", "getattr", "hasattr", "type",
                 "range", "enumerate", "zip"}
_STATIC_ANNOTATIONS = {"int", "float", "bool", "str", "dtype", "device"}
_CAST_CALLS = {"bool", "int", "float"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_SHAPE_FROM_DATA = {"nonzero", "unique", "unique_consecutive",
                    "flatnonzero", "argwhere", "masked_select"}
_MUTABLE_LITERALS = (ast.Dict, ast.List, ast.Set, ast.DictComp,
                     ast.ListComp, ast.SetComp)
_COMPREHENSIONS = (ast.GeneratorExp, ast.ListComp, ast.SetComp,
                   ast.DictComp)


def _callable_name(f: ast.AST) -> str:
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _target_names(targets) -> List[str]:
    """The names an assignment or loop binds (not those it indexes)."""
    out: List[str] = []
    for t in targets:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            out.extend(_target_names(t.elts))
        elif isinstance(t, ast.Starred):
            out.extend(_target_names([t.value]))
    return out


@dataclass
class _Fn:
    node: ast.FunctionDef
    qual: str
    cls: Optional[str]          # enclosing class, for self.method calls
    captured: bool = False
    params: Set[str] = field(default_factory=set)  # tensor parameters


class CaptureAnalyzer:
    def __init__(self, captured: Sequence[str] = CAPTURED):
        self.captured = tuple(captured)

    def analyze(self, corpus: Iterable[SourceFile]) -> List[Finding]:
        findings: List[Finding] = []
        for sf in corpus:
            if sf.tree is not None:
                findings.extend(self._analyze_module(sf))
        return findings

    # ------------------------------------------------------------- module

    @staticmethod
    def functions(sf: SourceFile) -> Dict[str, _Fn]:
        """Every function of the module by qualname (``f``, ``Cls.m``,
        ``f.inner``)."""
        fns: Dict[str, _Fn] = {}

        def visit(node: ast.AST, prefix: str, cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    visit(child, q, q)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    q = f"{prefix}.{child.name}" if prefix else child.name
                    fns.setdefault(q, _Fn(child, q, cls))
                    visit(child, q, None)

        visit(sf.tree, "", None)
        for fn in fns.values():
            a = fn.node.args
            for arg in list(a.posonlyargs) + list(a.args) + list(
                    a.kwonlyargs):
                ann = arg.annotation
                if arg.arg in ("self", "cls") or (
                        _callable_name(ann) in _STATIC_ANNOTATIONS
                        if ann is not None else False):
                    continue
                fn.params.add(arg.arg)
        return fns

    def reachable(self, sf: SourceFile) -> Dict[str, _Fn]:
        """The module's functions by qualname, each marked ``captured``
        when an entry point reaches it."""
        fns = self.functions(sf)
        for name in self.captured:
            path, _, qual = name.partition(":")
            if path == sf.relpath and qual in fns:
                fns[qual].captured = True
        for fn in fns.values():
            for sub in ast.walk(fn.node):
                if isinstance(sub, ast.Call) \
                        and _callable_name(sub.func) in HELPER_CALLS:
                    # program(key, fn, on_build, **buffers): the step is fn
                    steps = sub.args[1:2] + [k.value for k in sub.keywords
                                             if k.arg == "fn"]
                    for arg in steps:
                        target = self._resolve(fns, fn, arg)
                        if target is not None:
                            target.captured = True
        changed = True
        while changed:  # transitive closure over resolvable calls
            changed = False
            for fn in [f for f in fns.values() if f.captured]:
                for sub in ast.walk(fn.node):
                    if isinstance(sub, ast.Call):
                        target = self._resolve(fns, fn, sub.func)
                        if target is not None and not target.captured:
                            target.captured = changed = True
        return fns

    def _analyze_module(self, sf: SourceFile) -> List[Finding]:
        fns = self.reachable(sf)
        mutable: Set[str] = set()
        for node in sf.tree.body:
            targets = (node.targets if isinstance(node, ast.Assign) else
                       [node.target] if isinstance(node, ast.AnnAssign)
                       else [])
            if isinstance(getattr(node, "value", None), _MUTABLE_LITERALS):
                mutable.update(t.id for t in targets
                               if isinstance(t, ast.Name))
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Global):
                mutable.update(node.names)

        static_fns = self._static_returns(fns)
        findings: List[Finding] = []
        for fn in fns.values():
            if fn.captured:
                findings.extend(self._check(sf, fns, fn, mutable,
                                            static_fns))
        return findings

    @staticmethod
    def _resolve(fns: Dict[str, _Fn], caller: _Fn,
                 ref: ast.AST) -> Optional[_Fn]:
        """The module function ``ref`` names: ``f`` (a top-level function)
        or ``self.m`` / ``cls.m`` (a method of the caller's class)."""
        if isinstance(ref, ast.Name):
            return fns.get(ref.id)
        if isinstance(ref, ast.Attribute) and isinstance(ref.value, ast.Name) \
                and ref.value.id in ("self", "cls") and caller.cls:
            return fns.get(f"{caller.cls}.{ref.attr}")
        return None

    # ------------------------------------------------------ tensor values

    def _traced_names(self, fns, fn: _Fn, static_fns: Set[str]) -> Set[str]:
        """The parameters and every local assigned (or looped over) from a
        tensor value, to a fixpoint."""
        traced = set(fn.params)
        changed = True
        while changed:
            changed = False
            for sub in ast.walk(fn.node):
                if isinstance(sub, (ast.Assign, ast.AugAssign,
                                    ast.AnnAssign)):
                    value = sub.value
                    targets = (sub.targets if isinstance(sub, ast.Assign)
                               else [sub.target])
                elif isinstance(sub, (ast.For, ast.comprehension)):
                    value, targets = sub.iter, [sub.target]
                else:
                    continue
                if value is None or not self._is_traced(
                        value, traced, fns, fn, static_fns):
                    continue
                for name in _target_names(targets):
                    if name not in traced:
                        traced.add(name)
                        changed = True
        return traced

    def _is_traced(self, e: ast.AST, traced: Set[str], fns, fn: _Fn,
                   static_fns: Set[str]) -> bool:
        def walk(e: ast.AST, traced: Set[str]) -> bool:
            if isinstance(e, ast.Name):
                return e.id in traced
            if isinstance(e, ast.Attribute):
                return e.attr not in _STATIC_ATTRS and walk(e.value, traced)
            if isinstance(e, ast.Call):
                name = _callable_name(e.func)
                if name in _STATIC_CALLS or (
                        isinstance(e.func, ast.Attribute)
                        and name in _STATIC_METHODS):
                    return False
                target = self._resolve(fns, fn, e.func)
                if target is not None and target.qual in static_fns:
                    return False
                args = list(e.args) + [k.value for k in e.keywords]
                if any(walk(a, traced) for a in args):
                    return True
                return isinstance(e.func, ast.Attribute) \
                    and walk(e.func.value, traced)
            if isinstance(e, ast.Subscript):
                return walk(e.value, traced)
            if isinstance(e, (ast.Constant, ast.Lambda)):
                return False
            if isinstance(e, ast.Compare):
                if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                    return False  # identity, never a value
                if all(isinstance(op, (ast.In, ast.NotIn)) for op in e.ops):
                    # membership in a host container is static; in a
                    # tensor it reads the tensor
                    return any(walk(c, traced) for c in e.comparators)
            if isinstance(e, _COMPREHENSIONS):
                inner = set(traced)
                for gen in e.generators:
                    if walk(gen.iter, inner):
                        inner.update(_target_names([gen.target]))
                elts = ([e.key, e.value] if isinstance(e, ast.DictComp)
                        else [e.elt])
                return any(walk(x, inner) for x in elts)
            return any(walk(c, traced) for c in ast.iter_child_nodes(e))

        return walk(e, traced)

    def _static_returns(self, fns: Dict[str, _Fn]) -> Set[str]:
        """Functions whose every ``return`` value is static, to a
        fixpoint (a function returning only what such a function returns
        is static too)."""
        static: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for fn in fns.values():
                if fn.qual in static:
                    continue
                traced = self._traced_names(fns, fn, static)
                rets = [r.value for r in ast.walk(fn.node)
                        if isinstance(r, ast.Return) and r.value is not None]
                if not any(self._is_traced(r, traced, fns, fn, static)
                           for r in rets):
                    static.add(fn.qual)
                    changed = True
        return static

    # ------------------------------------------------ per-function checks

    def _check(self, sf: SourceFile, fns, fn: _Fn, mutable: Set[str],
               static_fns: Set[str]) -> List[Finding]:
        traced = self._traced_names(fns, fn, static_fns)
        local: Set[str] = set(fn.params)
        declared: Set[str] = set()
        for sub in ast.walk(fn.node):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
                local.add(sub.id)
            elif isinstance(sub, ast.Global):
                declared.update(sub.names)
        local -= declared

        def is_traced(e):
            return self._is_traced(e, traced, fns, fn, static_fns)

        out: List[Finding] = []
        globals_at: Dict[str, int] = {}  # name -> first line
        where = f"captured `{fn.qual}`"
        for sub in ast.walk(fn.node):
            if isinstance(sub, (ast.If, ast.While)) and is_traced(sub.test):
                kind = "while" if isinstance(sub, ast.While) else "if"
                out.append(sf.finding(
                    "traced-branch", sub.lineno,
                    f"Python `{kind}` on a tensor's value in {where}: the "
                    "capture syncs or freezes one branch into the graph; "
                    "use torch.where or make the value a static argument"))
            elif isinstance(sub, ast.Call):
                out.extend(self._check_call(sf, sub, is_traced, where))
            elif isinstance(sub, ast.Subscript) and isinstance(
                    sub.ctx, ast.Load) and is_traced(sub.value) \
                    and is_traced(sub.slice) and (
                        isinstance(sub.slice, ast.Compare)
                        or (isinstance(sub.slice, ast.Name) and any(
                            s in sub.slice.id.lower()
                            for s in ("mask", "cond", "bool")))):
                out.append(sf.finding(
                    "shape-from-data", sub.lineno,
                    f"boolean-mask indexing in {where}: the result's shape "
                    "depends on the mask's data; use torch.where"))
            elif isinstance(sub, ast.Name) and sub.id in mutable \
                    and sub.id not in local:
                first = globals_at.get(sub.id, sub.lineno)
                globals_at[sub.id] = min(first, sub.lineno)
        for name, line in sorted(globals_at.items(), key=lambda kv: kv[1]):
            out.append(sf.finding(
                "mutable-global-capture", line,
                f"module-level mutable `{name}` used in {where}: the graph "
                "keeps the value or address it had at capture; pass it in, "
                "make it immutable, or say why it holds"))
        return out

    @staticmethod
    def _check_call(sf: SourceFile, call: ast.Call, is_traced,
                    where: str) -> List[Finding]:
        name = _callable_name(call.func)
        recv = call.func.value if isinstance(call.func, ast.Attribute) \
            else None
        recv_name = recv.id if isinstance(recv, ast.Name) else ""
        arg0 = call.args[0] if call.args else None
        if isinstance(call.func, ast.Name) and name in _CAST_CALLS \
                and arg0 is not None and is_traced(arg0):
            return [sf.finding(
                "traced-cast", call.lineno,
                f"`{name}()` of a tensor in {where}: a device-to-host copy "
                "(refused while capturing) and a value frozen at capture")]
        if recv is not None and ((name in _HOST_METHODS and is_traced(recv))
                                 or (name == "asarray" and recv_name == "np"
                                     and arg0 is not None
                                     and is_traced(arg0))):
            return [sf.finding(
                "traced-cast", call.lineno,
                f"`.{name}()` of a tensor in {where}: a device-to-host copy "
                "(refused while capturing) and a value frozen at capture")]
        if name in _SHAPE_FROM_DATA and (
                (arg0 is not None and is_traced(arg0))
                or (recv is not None and is_traced(recv))) \
                or (name == "where" and len(call.args) == 1
                    and not call.keywords and is_traced(arg0)):
            return [sf.finding(
                "shape-from-data", call.lineno,
                f"`{name}` in {where}: its output shape depends on data, "
                "which a graph cannot replay; use a mask or "
                "torch.where(cond, a, b)")]
        to_device = name == "to" and recv is not None and (
            any(k.arg == "device" for k in call.keywords)
            or any(isinstance(a, ast.Constant) and isinstance(a.value, str)
                   or _callable_name(a) in ("device", "dev")
                   for a in call.args))
        if (recv_name == "torch" and name in ("tensor", "as_tensor")) \
                or (name == "cuda" and recv is not None and not call.args
                    and recv_name != "torch") or to_device:
            return [sf.finding(
                "host-transfer", call.lineno,
                f"`{name}(...)` in {where}: a host-to-device copy, not "
                "allowed while a stream captures (and its value would be "
                "frozen); use a static buffer or build it on the device")]
        return []
