"""Check: fold-body purity.

The port jits nothing, but it keeps the contract the reference's
trace-purity check guards: the bodies that fold a batch into the states
run once per batch on the main path, so they must be pure. They must not
read the wall clock, the environment or host randomness drawn without an
explicit generator, and must do no I/O: any of those makes two runs over
the same data fold differently. And they must not fetch to the host in
the middle of a pass (``.item()``, ``.tolist()``, ``.cpu()``,
``float``/``int``/``bool`` of a tensor expression, ``np.asarray``,
``torch.cuda.synchronize``): on the card each such fetch is a device sync
on the main path, against the pass's one packed state fetch.

Roots:

1. every method named in :data:`TRACED_METHOD_NAMES` on the state classes
   (the ``@dataclass`` classes of :data:`STATE_MODULES`);
2. the same methods on the ``ScanShareable`` analyzer hierarchy (the fold
   bodies; resolved through base classes anywhere in the scan);
3. the fused programs' per-batch and unpack methods,
   :data:`PROGRAM_METHODS` in ``runners/engine.py``.

On a fixture scan (explicit files) every scanned module counts as a state
and program module. A package scan on which a root kind resolves to
nothing reports that instead of passing.

Reachability is a name-level over-approximation: calls resolve to
same-module functions (any nesting), ``self.``/``cls.`` methods of the
enclosing class, names imported by relative import from scanned modules,
and, for the fold-method names, every root method of that name.
Over-approximation errs toward flagging; deliberate host-side helpers
caught in the net carry baseline entries with reasons.

The reference's roots (``tools/statlint/checks/trace_purity.py`` over
``deequ_tpu``: 48 functions, 53 registrations, since five are registered
twice), each with its counterpart among this check's roots or the reason
it has none. The counterpart names ``<module>:<qualname>`` under
``deequ_tpu_torch``; ``tests/test_torch_statlint.py`` parses the table and
holds every named counterpart to be a root of this check.

==================================================  ==================================================
reference root (``deequ_tpu/``)                     port counterpart (``deequ_tpu_torch/``) or reason
==================================================  ==================================================
analyzers/grouping.py:DeviceFrequencyScan.update    analyzers/grouping.py:DeviceFrequencyScan.update
analyzers/grouping.py:DeviceFrequencyTableScan      analyzers/grouping.py:DeviceFrequencyTableScan
  .update                                             .update
analyzers/simple.py:Size.update                     analyzers/simple.py:Size.fold_slot
analyzers/simple.py:Correlation.update              analyzers/simple.py:Correlation.fold_slot
analyzers/simple.py:DataType.update                 analyzers/simple.py:DataType.fold_slot
analyzers/sketches.py:ApproxCountDistinct.update    analyzers/sketches.py:ApproxCountDistinct.update
analyzers/sketches.py:_KLLBackedAnalyzer.update     analyzers/sketches.py:_KLLBackedAnalyzer.update
analyzers/grouping.py:DeviceFrequencyScan.merge     analyzers/grouping.py:DeviceFrequencyScan.merge
analyzers/grouping.py:DeviceFrequencyTableScan      analyzers/grouping.py:DeviceFrequencyTableScan
  .merge                                              .merge
analyzers/simple.py:Size.merge                      analyzers/simple.py:Size.merge
analyzers/simple.py:_RatioAnalyzer.merge            analyzers/simple.py:_RatioAnalyzer.merge
analyzers/simple.py:_LengthAnalyzer.merge           analyzers/simple.py:_ValueAnalyzer.merge
analyzers/simple.py:Correlation.merge               analyzers/simple.py:Correlation.merge
analyzers/simple.py:DataType.merge                  analyzers/simple.py:DataType.merge
analyzers/sketches.py:ApproxCountDistinct.merge     analyzers/sketches.py:ApproxCountDistinct.merge
analyzers/sketches.py:_KLLBackedAnalyzer.merge      analyzers/sketches.py:_KLLBackedAnalyzer.merge
analyzers/states.py:FrequencyCountsState.merge      analyzers/states.py:FrequencyCountsState.merge
analyzers/states.py:FrequencyTableState.merge       analyzers/states.py:FrequencyTableState.merge
analyzers/states.py:NumMatches.merge                analyzers/states.py:NumMatches.merge
analyzers/states.py:NumMatchesAndCount.merge        analyzers/states.py:NumMatchesAndCount.merge
analyzers/states.py:MeanState.merge                 analyzers/states.py:MeanState.merge
analyzers/states.py:SumState.merge                  analyzers/states.py:SumState.merge
analyzers/states.py:MinState.merge                  analyzers/states.py:MinState.merge
analyzers/states.py:MaxState.merge                  analyzers/states.py:MaxState.merge
analyzers/states.py:StandardDeviationState.merge    analyzers/states.py:StandardDeviationState.merge
analyzers/states.py:CorrelationState.merge          analyzers/states.py:CorrelationState.merge
analyzers/states.py:DataTypeHistogram.merge         analyzers/states.py:DataTypeHistogram.merge
analyzers/states.py:ApproxCountDistinctState.merge  analyzers/states.py:ApproxCountDistinctState.merge
ops/kll.py:KLLSketchState.merge                     ops/kll.py:KLLSketchState.merge
analyzers/states.py:FrequencyTableState.compacted   analyzers/states.py:FrequencyTableState.compacted
analyzers/states.py:FrequencyTableState             analyzers/states.py:FrequencyTableState
  .append_keys                                        .append_keys
analyzers/states.py:FrequencyTableState             none: a ``lax.cond`` branch of ``append_keys``;
  .append_keys.just_append                          the port's ``append_keys`` is one ``freq_keys``
                                                    launch, with no branch body
analyzers/base.py:merge_states_batched.fold         none: a ``lax.scan`` over stacked states; the port
                                                    folds them in one ``state_fold`` (K8) launch,
                                                    staged on the host between passes
analyzers/base.py:merge_states_batched.fold.body    none: the scan body of the row above
ops/kll.py:_compact_cascade.body (x2)               none: ``lax`` loops of the KLL compaction; the
                                                    port's cascade is a loop inside the
                                                    ``kll_compact`` (K5) kernel, with no Python body
ops/kll.py:_compact_cascade_from.body (x2)          none: as the row above
ops/kll.py:_compact_cascade_from.cond               none: as the row above
parallel/__init__.py:sharded_update.fused           runners/engine.py:BundledScanProgram.call_sharded
parallel/__init__.py:sharded_ingest_fold            none: a ``shard_map`` body; the port's
  .local_fold                                       ``sharded_ingest_fold`` stages one
                                                    ``state_fold_carry_stacked`` launch a chunk
parallel/__init__.py:collective_merge_states        none: a ``shard_map`` body; the port's merge is
  .merge_program                                    one ``state_fold_butterfly`` launch
runners/engine.py:_pack_leaves_f64                  none: jitted packing of the device tier's carry
                                                    into stacked vectors; the port's device tier
                                                    carries its states as they are
runners/engine.py:_pack_leaves_u64_u8               none: as the row above
runners/engine.py:_pack_leaves_u8                   none: as the row above
runners/engine.py:_ingest_program.fold              runners/engine.py:HostIngest.fold
runners/engine.py:make_flagged_ingest_body.body     none: the fault-probing variant of the row above;
                                                    the port probes faults outside the fold, so
                                                    ``HostIngest.fold`` is its one body
runners/engine.py:PackedScanProgram.unpack (x2)     runners/engine.py:HostIngest.states
runners/engine.py:BundledScanProgram.unpack (x2)    none: the port's ``BundledScanProgram`` carries a
                                                    list of states, so there is nothing to unpack
runners/engine.py:PackedScanProgram.__init__        runners/engine.py:BundledScanProgram.__call__
  .fused_update (x2)
==================================================  ==================================================
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import Finding, Module, ModuleIndex, attr_chain, pkg, unresolved

CHECK = "trace-purity"

#: modules whose ``@dataclass`` classes are analyzer states
STATE_MODULES = (pkg("analyzers/states.py"), pkg("ops/kll.py"))

#: the fold methods of the state classes and the ScanShareable analyzers:
#: the reference's names, plus the port's per-batch fold entries (a shared
#: ``scan_reduce`` launch's slot folded by ``fold_slot``, the mesh's
#: ``update_stacked``, the HLL battery's ``update_columns``, the host
#: tier's ``ingest_partial``)
TRACED_METHOD_NAMES = {
    "merge", "update", "compacted", "append_keys", "fold_slot",
    "update_stacked", "update_columns", "ingest_partial",
}

#: the module of the fused programs, and each program's per-batch and
#: unpack methods
ENGINE = pkg("runners/engine.py")
PROGRAM_METHODS = {
    "BundledScanProgram": ("__call__", "call_sharded"),
    "HostIngest": ("fold", "states"),
}

#: banned attribute-chain prefixes inside fold bodies
_BANNED_PREFIXES = (
    (("time",), "wall-clock read"),
    (("datetime",), "wall-clock read"),
    (("os", "environ"), "env read mid-pass"),
    (("os", "getenv"), "env read mid-pass"),
    (("torch", "cuda", "synchronize"), "host sync"),
    (("np", "asarray"), "host sync (np.asarray)"),
    (("numpy", "asarray"), "host sync (np.asarray)"),
)

#: random-number namespaces, and the constructors that take an explicit
#: generator (allowed when called with a seed)
_RANDOM_ROOTS = (("np", "random"), ("numpy", "random"), ("random",))
_SEEDED_CTORS = {"default_rng", "Generator", "RandomState", "SeedSequence", "Random"}
#: torch samplers: impure unless given ``generator=``
_TORCH_SAMPLERS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "multinomial", "bernoulli", "normal", "poisson",
}

_BANNED_METHODS = {
    "item": "host sync (.item())",
    "tolist": "host sync (.tolist())",
    "cpu": "host sync (.cpu())",
}
_BANNED_BUILTINS = {"open": "I/O", "print": "host I/O", "input": "host I/O"}

#: ``float``/``int``/``bool`` of one of these is a host fetch of a tensor
_SCALAR_BUILTINS = {"float", "int", "bool"}
_TENSOR_REDUCTIONS = {
    "sum", "max", "min", "amax", "amin", "any", "all", "count_nonzero",
    "mean", "prod", "norm", "argmax", "argmin",
}


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        chain = attr_chain(dec) or (
            attr_chain(dec.func) if isinstance(dec, ast.Call) else None
        )
        if chain and chain[-1] == "dataclass":
            return True
    return False


def _base_names(cls: ast.ClassDef) -> List[str]:
    out = []
    for base in cls.bases:
        node = base.value if isinstance(base, ast.Subscript) else base
        chain = attr_chain(node)
        if chain:
            out.append(chain[-1])
    return out


def _scan_shareable_classes(index: ModuleIndex) -> Set[str]:
    """Names of the classes in the ScanShareable hierarchy: a base whose
    name holds "ScanShareable", or a base that is itself one (by name,
    over the whole scan). Host-side accumulators (the host group-by) also
    define ``update``/``merge`` but never fold a pass's batches."""
    bases: Dict[str, List[str]] = {}
    for module in index.modules:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                bases.setdefault(node.name, []).extend(_base_names(node))
    found = {
        name for name, names in bases.items()
        if any("ScanShareable" in b for b in names)
    }
    changed = True
    while changed:
        changed = False
        for name, names in bases.items():
            if name not in found and any(b in found for b in names):
                found.add(name)
                changed = True
    return found


class _FuncInfo:
    __slots__ = ("module", "node", "qualname", "cls")

    def __init__(self, module: Module, node: ast.AST, qualname: str,
                 cls: Optional[ast.ClassDef]):
        self.module = module
        self.node = node
        self.qualname = qualname
        self.cls = cls


class _Graph:
    """Tables over the scan: per-module name -> functions (any nesting),
    per-class methods, the fold methods by name, the roots, and each
    module's relative imports."""

    def __init__(self, index: ModuleIndex):
        self.index = index
        self.by_module: Dict[str, Dict[str, List[_FuncInfo]]] = {}
        self.methods: Dict[Tuple[str, str], Dict[str, _FuncInfo]] = {}
        self.fold_methods: Dict[str, List[_FuncInfo]] = {}
        self.roots: List[_FuncInfo] = []
        #: per root kind: how many roots it found
        self.kinds: Dict[str, int] = {"state": 0, "scan-shareable": 0, "program": 0}
        self._imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        shareable = _scan_shareable_classes(index)
        for module in index.modules:
            self._index_module(module, shareable)

    def _index_module(self, module: Module, shareable: Set[str]) -> None:
        table: Dict[str, List[_FuncInfo]] = {}
        self.by_module[module.relpath] = table
        narrow = self.index.narrow
        state_module = not narrow or module.relpath.endswith(STATE_MODULES)
        engine = not narrow or module.relpath.endswith(ENGINE)

        def visit(node, cls, prefix, in_class_body):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info = _FuncInfo(module, child, f"{prefix}{child.name}", cls)
                    table.setdefault(child.name, []).append(info)
                    if in_class_body:
                        self.methods.setdefault(
                            (module.relpath, cls.name), {}
                        )[child.name] = info
                        self._classify(info, cls, state_module, engine, shareable)
                    visit(child, cls, f"{prefix}{child.name}.", False)
                elif isinstance(child, ast.ClassDef):
                    visit(child, child, f"{prefix}{child.name}.", True)
                else:
                    visit(child, cls, prefix, in_class_body)

        visit(module.tree, None, "", False)

    def _classify(self, info: _FuncInfo, cls: ast.ClassDef, state_module: bool,
                  engine: bool, shareable: Set[str]) -> None:
        name = info.node.name
        kind = None
        if name in TRACED_METHOD_NAMES:
            if state_module and _is_dataclass(cls):
                kind = "state"
            elif cls.name in shareable:
                kind = "scan-shareable"
            if kind is not None:
                self.fold_methods.setdefault(name, []).append(info)
        if engine and name in PROGRAM_METHODS.get(cls.name, ()):
            kind = "program"
        if kind is not None:
            self.roots.append(info)
            self.kinds[kind] += 1

    def imports(self, module: Module) -> Dict[str, Tuple[str, str]]:
        """Names bound by relative imports: name -> (target relpath
        without ``.py``, original name)."""
        cached = self._imports.get(module.relpath)
        if cached is not None:
            return cached
        out: Dict[str, Tuple[str, str]] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                base = module.relpath.rsplit("/", 1)[0]
                for _ in range(node.level - 1):
                    base = base.rsplit("/", 1)[0]
                dotted = (node.module or "").replace(".", "/")
                target = f"{base}/{dotted}".rstrip("/")
                for alias in node.names:
                    out[alias.asname or alias.name] = (target, alias.name)
        self._imports[module.relpath] = out
        return out

    def callees(self, info: _FuncInfo) -> List[_FuncInfo]:
        """Resolve the call sites inside one function body."""
        out: List[_FuncInfo] = []
        module = info.module
        table = self.by_module[module.relpath]
        imports = self.imports(module)
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Name):
                if func.id in table:
                    out.extend(table[func.id])
                elif func.id in imports:
                    target_rel, original = imports[func.id]
                    target = self.index.get(f"{target_rel}.py") or self.index.get(
                        f"{target_rel}/__init__.py"
                    )
                    if target is not None:
                        out.extend(self.by_module[target.relpath].get(original, []))
            elif isinstance(func, ast.Attribute):
                chain = attr_chain(func)
                if chain and chain[0] in ("self", "cls") and len(chain) == 2:
                    if info.cls is not None:
                        m = self.methods.get(
                            (module.relpath, info.cls.name), {}
                        ).get(chain[1])
                        if m is not None:
                            out.append(m)
                if func.attr in self.fold_methods and not (
                    chain and chain[0] in ("torch", "np", "numpy")
                ):
                    # fold-method dispatch: a.merge(b) on an unknown receiver
                    out.extend(self.fold_methods[func.attr])
        return out


def _tensorish(node: ast.AST) -> bool:
    """A tensor expression, as far as a name-level check can tell: a
    ``torch.*`` call, a tensor reduction method, or a subscript of one."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if not isinstance(node, ast.Call):
        return False
    chain = attr_chain(node.func)
    if chain and chain[0] == "torch":
        return True
    return isinstance(node.func, ast.Attribute) and node.func.attr in _TENSOR_REDUCTIONS


def _random_impurity(node: ast.Call, chain: List[str]) -> Optional[str]:
    for root in _RANDOM_ROOTS:
        if tuple(chain[: len(root)]) == root and len(chain) > len(root):
            if chain[-1] in _SEEDED_CTORS and (node.args or node.keywords):
                return None
            return f"{'.'.join(chain)} (host randomness)"
    if chain[0] == "torch" and chain[-1] in _TORCH_SAMPLERS and not any(
        k.arg == "generator" for k in node.keywords
    ):
        return f"{'.'.join(chain)} (randomness without a generator)"
    return None


def _impurities(info: _FuncInfo) -> List[Tuple[int, str]]:
    out: List[Tuple[int, str]] = []
    for node in ast.walk(info.node):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        chain = attr_chain(func)
        if chain:
            for prefix, why in _BANNED_PREFIXES:
                exact_call = len(prefix) > 1 and prefix != ("os", "environ")
                if tuple(chain[: len(prefix)]) == prefix and (
                    len(chain) > len(prefix) or exact_call
                ):
                    out.append((node.lineno, f"{'.'.join(chain)} ({why})"))
                    break
            else:
                why = _random_impurity(node, chain)
                if why is not None:
                    out.append((node.lineno, why))
        if isinstance(func, ast.Attribute) and func.attr in _BANNED_METHODS and not (
            chain and chain[0] in ("np", "numpy")
        ):
            out.append((node.lineno, _BANNED_METHODS[func.attr]))
        if isinstance(func, ast.Name):
            if func.id in _BANNED_BUILTINS:
                out.append(
                    (node.lineno, f"{func.id}() ({_BANNED_BUILTINS[func.id]})")
                )
            elif (
                func.id in _SCALAR_BUILTINS
                and len(node.args) == 1
                and _tensorish(node.args[0])
            ):
                out.append(
                    (node.lineno, f"{func.id}() of a tensor (host sync)")
                )
    return out


def roots(index: ModuleIndex) -> List[str]:
    """The roots the check walks from, as ``relpath:qualname``."""
    return sorted({
        f"{r.module.relpath}:{r.qualname}" for r in _Graph(index).roots
    })


def run(index: ModuleIndex) -> List[Finding]:
    graph = _Graph(index)
    findings: List[Finding] = []
    if index.narrow:
        for kind, where in (("state", STATE_MODULES[0]),
                            ("scan-shareable", pkg("analyzers/")),
                            ("program", ENGINE)):
            if not graph.kinds[kind]:
                findings.append(unresolved(CHECK, where, f"{kind} roots in {where}"))
    seen: Set[Tuple[str, str]] = set()
    visited: Set[int] = set()
    stack: List[Tuple[_FuncInfo, str]] = [
        (r, f"{r.module.relpath}:{r.qualname}") for r in graph.roots
    ]
    while stack:
        info, origin = stack.pop()
        if id(info.node) in visited:
            continue
        visited.add(id(info.node))
        for line, what in _impurities(info):
            ident = (f"{info.module.relpath}:{info.qualname}", what)
            if ident in seen:
                continue
            seen.add(ident)
            findings.append(Finding(
                check=CHECK, path=info.module.relpath, line=line,
                message=(
                    f"{info.qualname} is reachable from a fold body "
                    f"(root: {origin}) but calls {what}"
                ),
                key=f"{info.qualname}:{what}",
            ))
        for callee in graph.callees(info):
            stack.append((callee, origin))
    return findings
