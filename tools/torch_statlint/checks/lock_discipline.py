"""Check: lock discipline in the service plane.

The scheduler/coalescer/streaming/fleet contracts are enforced by hand-held
locks, exactly where the reference's flake hunts found real bugs. Three
machine-checked properties per class that owns ``threading`` locks:

1. **Unguarded shared writes** (the cross-key commit-inversion
   shape): an instance attribute written (or mutated via
   ``append``/``pop``/...) both while holding the owning lock and on some
   path that provably does not hold it. A method documented "call me under
   the lock" counts as guarded when every same-class call site holds the
   lock; a method called both ways keeps its unguarded writes visible.
2. **Same-lock re-acquisition**: while holding a non-reentrant
   ``threading.Lock`` (or a Condition wrapping one), calling a same-class
   method that lexically acquires that same lock — a guaranteed deadlock.
   ``threading.Condition()`` with no argument wraps an RLock and is
   exempt; ``Condition(self._lock)`` aliases the wrapped lock.
3. **Acquisition-order cycles** across classes: an edge A→B is recorded
   when lock A is held while acquiring lock B (lexically, through a
   same-class method, or through a call into another scanned class —
   resolved by constructor-typed attributes or a package-unique method
   name). A cycle means two threads can deadlock by arriving in opposite
   orders.

All resolution is a name-level heuristic over the shared parse cache;
deliberate exceptions carry baseline entries with reasons.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import Finding, Module, ModuleIndex, attr_chain

CHECK = "lock-discipline"

_MUTATORS = {
    "append", "appendleft", "add", "pop", "popleft", "popitem", "update",
    "discard", "remove", "clear", "insert", "extend", "setdefault",
}

#: attribute names assigned these literal types in __init__ are builtin
#: containers — calls through them never take a scanned class's lock
_BUILTIN_LITERALS = (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.DictComp)


class _LockInfo:
    __slots__ = ("name", "kind", "alias_of")

    def __init__(self, name: str, kind: str, alias_of: Optional[str] = None):
        self.name = name
        self.kind = kind        # "lock" | "rlock" | "cond-own"
        self.alias_of = alias_of


class _ClassModel:
    def __init__(self, module: Module, node: ast.ClassDef):
        self.module = module
        self.node = node
        self.name = node.name
        self.locks: Dict[str, _LockInfo] = {}
        #: attr -> constructor class name (self.x = ClassName(...))
        self.attr_types: Dict[str, str] = {}
        #: attrs assigned builtin container literals in __init__
        self.builtin_attrs: Set[str] = set()
        #: method name -> analysis
        self.methods: Dict[str, "_MethodModel"] = {}

    def canonical(self, lock_attr: str) -> str:
        seen = set()
        while True:
            info = self.locks.get(lock_attr)
            if info is None or info.alias_of is None or lock_attr in seen:
                return lock_attr
            seen.add(lock_attr)
            lock_attr = info.alias_of

    def kind(self, lock_attr: str) -> str:
        info = self.locks.get(self.canonical(lock_attr))
        return info.kind if info else "lock"


class _MethodModel:
    def __init__(self, name: str):
        self.name = name
        #: locks (canonical) acquired lexically anywhere inside
        self.acquires: Set[str] = set()
        #: (attr, held: bool, line)
        self.writes: List[Tuple[str, bool, int]] = []
        #: (method_name, frozenset held, line) same-class calls
        self.self_calls: List[Tuple[str, frozenset, int]] = []
        #: (receiver_attr_chain, method_name, frozenset held, line)
        self.foreign_calls: List[Tuple[Tuple[str, ...], str, frozenset, int]] = []


def _lock_ctor(node: ast.AST) -> Optional[Tuple[str, Optional[str]]]:
    """(kind, aliased_attr) when ``node`` constructs a threading primitive."""
    if not isinstance(node, ast.Call):
        return None
    chain = attr_chain(node.func)
    if not chain:
        return None
    leaf = chain[-1]
    if leaf == "Lock":
        return "lock", None
    if leaf == "RLock":
        return "rlock", None
    if leaf == "Condition":
        if node.args:
            arg_chain = attr_chain(node.args[0])
            if arg_chain and arg_chain[0] == "self" and len(arg_chain) == 2:
                return "cond", arg_chain[1]
            return "lock", None  # wraps something we can't see: assume Lock
        return "rlock", None  # bare Condition() wraps an RLock
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for ``self.x`` (exactly one level)."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _build_class(module: Module, node: ast.ClassDef,
                 class_names: Set[str]) -> _ClassModel:
    model = _ClassModel(module, node)
    # pass 1: lock attrs + constructor-typed attrs, from ANY method (some
    # classes create locks lazily outside __init__)
    for body_node in ast.walk(node):
        if not isinstance(body_node, ast.Assign):
            continue
        for target in body_node.targets:
            attr = _self_attr(target)
            if attr is None:
                continue
            ctor = _lock_ctor(body_node.value)
            if ctor is not None:
                kind, alias = ctor
                if alias is not None:
                    model.locks[attr] = _LockInfo(attr, "cond", alias_of=alias)
                else:
                    model.locks[attr] = _LockInfo(attr, kind)
                continue
            if isinstance(body_node.value, _BUILTIN_LITERALS) or (
                isinstance(body_node.value, ast.Call)
                and isinstance(body_node.value.func, ast.Name)
                and body_node.value.func.id in
                ("dict", "list", "set", "deque", "OrderedDict", "defaultdict")
            ):
                model.builtin_attrs.add(attr)
                continue
            for call in ast.walk(body_node.value):
                if (
                    isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Name)
                    and call.func.id in class_names
                ):
                    model.attr_types[attr] = call.func.id
                    break
    # pass 2: per-method lock-flow analysis
    for child in node.body:
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            method = _MethodModel(child.name)
            _walk_method(model, method, child.body, frozenset())
            model.methods[child.name] = method
    return model


def _walk_method(model: _ClassModel, method: _MethodModel,
                 body, held: frozenset) -> None:
    for node in body:
        _walk_stmt(model, method, node, held)


def _walk_stmt(model: _ClassModel, method: _MethodModel,
               node: ast.AST, held: frozenset) -> None:
    if isinstance(node, ast.With):
        inner = held
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr in model.locks:
                canonical = model.canonical(attr)
                method.acquires.add(canonical)
                inner = inner | {canonical}
        _walk_method(model, method, node.body, inner)
        return
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        # a nested function/closure runs LATER, possibly without the lock:
        # analyze its body with nothing held
        inner_body = node.body if isinstance(node.body, list) else [
            ast.Expr(value=node.body)
        ]
        _walk_method(model, method, inner_body, frozenset())
        return
    # expressions/targets at this level
    _scan_exprs(model, method, node, held)
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.expr, ast.keyword, ast.arguments)):
            continue  # handled by _scan_exprs on the parent
        _walk_stmt(model, method, child, held)


def _scan_exprs(model: _ClassModel, method: _MethodModel,
                node: ast.AST, held: frozenset) -> None:
    if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for target in targets:
            base = target
            while isinstance(base, (ast.Subscript, ast.Starred)):
                base = base.value
            attr = _self_attr(base)
            if attr is not None and attr not in model.locks:
                method.writes.append((attr, bool(held), node.lineno))
        value = getattr(node, "value", None)
        if value is not None:
            _scan_calls(model, method, value, held)
        return
    # statements that carry expressions (Expr, Return, If tests, etc.)
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.expr):
            _scan_calls(model, method, child, held)


def _scan_calls(model: _ClassModel, method: _MethodModel,
                node: ast.AST, held: frozenset) -> None:
    for call in ast.walk(node):
        if isinstance(call, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if not isinstance(call, ast.Call):
            continue
        chain = attr_chain(call.func)
        if not chain or chain[0] != "self":
            continue
        if len(chain) == 2:
            method.self_calls.append((chain[1], held, call.lineno))
        elif len(chain) >= 3:
            receiver = tuple(chain[1:-1])
            leaf = chain[-1]
            if receiver[0] in model.builtin_attrs:
                continue  # dict/list/deque method, takes no scanned lock
            if receiver[0] in model.locks:
                continue  # lock.acquire()/notify()/wait(): not a class call
            if leaf in _MUTATORS and receiver[-1] in model.builtin_attrs:
                continue
            # a mutator through a plain self attr is a WRITE to that attr
            if len(receiver) == 1 and leaf in _MUTATORS:
                method.writes.append((receiver[0], bool(held), call.lineno))
                continue
            method.foreign_calls.append((receiver, leaf, held, call.lineno))


def _collect_models(index: ModuleIndex) -> List[_ClassModel]:
    class_names: Set[str] = set()
    pending: List[Tuple[Module, ast.ClassDef]] = []
    for module in index.modules:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                class_names.add(node.name)
                pending.append((module, node))
    return [
        _build_class(module, node, class_names) for module, node in pending
    ]


def run(index: ModuleIndex) -> List[Finding]:
    findings: List[Finding] = []
    models = [m for m in _collect_models(index) if m.locks]
    by_name: Dict[str, List[_ClassModel]] = {}
    method_owner: Dict[str, List[_ClassModel]] = {}
    for model in models:
        by_name.setdefault(model.name, []).append(model)
        for name in model.methods:
            method_owner.setdefault(name, []).append(model)

    # ---- property 1: unguarded shared writes -----------------------------
    for model in models:
        # HELD-ONLY methods: take no lock themselves and every same-class
        # call site is lexically under a lock or inside another held-only
        # method (the `_foo_locked` helper convention) — computed as a
        # fixpoint so lock->helper->helper chains count
        call_sites: Dict[str, List[Tuple[str, bool]]] = {}
        for method in model.methods.values():
            for name, held, _ in method.self_calls:
                if name in model.methods:
                    call_sites.setdefault(name, []).append(
                        (method.name, bool(held))
                    )
        held_only: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for name, method in model.methods.items():
                if name in held_only or method.acquires:
                    continue
                sites = call_sites.get(name)
                if not sites:
                    continue
                if all(h or caller in held_only for caller, h in sites):
                    held_only.add(name)
                    changed = True
        write_map: Dict[str, Dict[bool, List[Tuple[str, int]]]] = {}
        for method in model.methods.values():
            if method.name == "__init__":
                continue
            for attr, held, line in method.writes:
                effective = held or method.name in held_only
                write_map.setdefault(attr, {}).setdefault(
                    effective, []
                ).append((method.name, line))
        for attr, contexts in sorted(write_map.items()):
            if True in contexts and False in contexts:
                guarded = sorted({m for m, _ in contexts[True]})
                naked = sorted({m for m, _ in contexts[False]})
                line = contexts[False][0][1]
                findings.append(Finding(
                    check=CHECK, path=model.module.relpath, line=line,
                    message=(
                        f"{model.name}.{attr} is written under a lock in "
                        f"{guarded} but without one in {naked} — the "
                        "commit-inversion shape (shared-field write "
                        "reachable with and without the owning lock)"
                    ),
                    key=f"unguarded-write:{model.name}.{attr}",
                ))

    # ---- properties 2+3: re-acquisition and order cycles -----------------
    edges: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
    edge_sites: Dict[Tuple[Tuple[str, str], Tuple[str, str]], Tuple[str, int]] = {}

    def resolve_foreign(model: _ClassModel, receiver: Tuple[str, ...],
                        leaf: str) -> Optional[_ClassModel]:
        cls_name = model.attr_types.get(receiver[0]) if len(receiver) == 1 else None
        if cls_name and cls_name in by_name and len(by_name[cls_name]) == 1:
            target = by_name[cls_name][0]
            if leaf in target.methods:
                return target
        owners = method_owner.get(leaf, [])
        if len(owners) == 1 and owners[0] is not model:
            return owners[0]
        return None

    for model in models:
        node_of = lambda lock: (model.name, lock)  # noqa: E731
        for method in model.methods.values():
            for name, held, line in method.self_calls:
                callee = model.methods.get(name)
                if callee is None or not held:
                    continue
                for lock in callee.acquires:
                    for held_lock in held:
                        if lock == held_lock:
                            if model.kind(lock) != "rlock":
                                findings.append(Finding(
                                    check=CHECK, path=model.module.relpath,
                                    line=line,
                                    message=(
                                        f"{model.name}.{method.name} holds "
                                        f"self.{held_lock} and calls "
                                        f"self.{name}() which re-acquires "
                                        "it — non-reentrant deadlock"
                                    ),
                                    key=(
                                        f"reacquire:{model.name}."
                                        f"{method.name}->{name}:{lock}"
                                    ),
                                ))
                        else:
                            a, b = node_of(held_lock), node_of(lock)
                            edges.setdefault(a, set()).add(b)
                            edge_sites.setdefault(
                                (a, b), (model.module.relpath, line)
                            )
            for receiver, leaf, held, line in method.foreign_calls:
                if not held:
                    continue
                target = resolve_foreign(model, receiver, leaf)
                if target is None:
                    continue
                callee = target.methods.get(leaf)
                if callee is None:
                    continue
                for lock in callee.acquires:
                    b = (target.name, lock)
                    for held_lock in held:
                        a = (model.name, held_lock)
                        if a == b:
                            continue
                        edges.setdefault(a, set()).add(b)
                        edge_sites.setdefault(
                            (a, b), (model.module.relpath, line)
                        )

    # lexical nested with-blocks: with self.A: ... with self.B: -> edge
    for model in models:
        for child in model.node.body:
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            _nested_with_edges(model, child, frozenset(), edges, edge_sites)

    # cycle detection over the acquisition graph
    reported: Set[frozenset] = set()
    for start in sorted(edges):
        cycle = _find_cycle(start, edges)
        if cycle is None:
            continue
        ident = frozenset(cycle)
        if ident in reported:
            continue
        reported.add(ident)
        pretty = " -> ".join(f"{c}.{l}" for c, l in cycle + [cycle[0]])
        path, line = edge_sites.get(
            (cycle[0], cycle[1 % len(cycle)]), ("", 0)
        )
        findings.append(Finding(
            check=CHECK, path=path or "statlint", line=line,
            message=(
                f"lock acquisition-order cycle: {pretty} — two threads "
                "arriving in opposite orders deadlock"
            ),
            key="cycle:" + "|".join(sorted(f"{c}.{l}" for c, l in cycle)),
        ))
    return findings


def _nested_with_edges(model, node, held, edges, edge_sites):
    if isinstance(node, ast.With):
        inner = held
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr in model.locks:
                canonical = model.canonical(attr)
                for held_lock in inner:
                    if held_lock != canonical:
                        a = (model.name, held_lock)
                        b = (model.name, canonical)
                        edges.setdefault(a, set()).add(b)
                        edge_sites.setdefault(
                            (a, b), (model.module.relpath, node.lineno)
                        )
                inner = inner | {canonical}
        for child in node.body:
            _nested_with_edges(model, child, inner, edges, edge_sites)
        return
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        body = node.body if isinstance(node.body, list) else []
        for child in body:
            _nested_with_edges(model, child, frozenset(), edges, edge_sites)
        return
    for child in ast.iter_child_nodes(node):
        _nested_with_edges(model, child, held, edges, edge_sites)


def _find_cycle(start, edges):
    """A simple DFS cycle through ``start``, or None."""
    stack = [(start, [start])]
    seen = set()
    while stack:
        node, path = stack.pop()
        for nxt in sorted(edges.get(node, ())):
            if nxt == start:
                return path
            if nxt in seen or nxt in path:
                continue
            stack.append((nxt, path + [nxt]))
        seen.add(node)
    return None
