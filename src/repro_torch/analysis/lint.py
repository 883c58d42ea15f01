"""qlint for the PyTorch port — AST-based static analysis of the serving
stack (the twin of the reference package's ``analysis/lint.py``).

CLI::

    python -m repro_torch.analysis.lint src/repro_torch [--json report.json]
        [--baseline qlint_baseline.json] [--write-baseline] [--self-test]

Rules:

  host-sync-in-hot-path   host/device syncs inside functions reachable
                          from the engine round entry points (steps/step/
                          _decode_round/_prefill_chunk_round/
                          _decode_burst_round): .item(), .tolist(),
                          .cpu(), .numpy(), .to("cpu"),
                          torch.cuda.synchronize / .synchronize(),
                          np.asarray / np.array, int()/float()/bool() of a
                          tensor, and blocking host->device copies
                          (torch.tensor / torch.as_tensor with a device,
                          .to(dev) / .cuda() without non_blocking=True),
                          which wait for all the work queued on the stream
  retrace-hazard          torch.compile, torch.cuda.graph or
                          torch.cuda.CUDAGraph called inside a loop body or
                          in a hot-path function: a capture (or compile) per
                          iteration or round instead of once
  blocking-in-async       time.sleep, torch.cuda.synchronize, sync
                          engine/agent calls, blocking queue.Queue ops
                          inside ``async def``
  unguarded-div           ratio statistics dividing by a possibly-zero
                          counter without a guard
  waiver-missing-reason   a ``# qlint: disable=`` comment without
                          ``-- <reason>`` (waivers must be justified)

Two rules of the reference have no counterpart here: ``use-after-donate``
(torch has no buffer donation; the port updates its caches in place) and
``pallas-traced-branch`` (the port's kernels are CUDA C++, with no Python
kernel body to lint).  The other three rules, the findings' fingerprints,
the waiver syntax and the baseline gate are the reference's, so a waiver
reads the same under both lints.

Waivers: ``# qlint: disable=<rule>[,rule] -- <reason>`` on the offending
line, or on its own line directly above.  The baseline file (JSON list of
fingerprints) makes the gate *zero NEW findings*; fingerprints are
line-number-free (``rule|path|message``) so unrelated edits don't churn
it.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import hashlib
import json
import os
import re
import sys
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES = {
    "host-sync-in-hot-path":
        "host/device sync inside the engine's hot round loop",
    "retrace-hazard":
        "graph capture or compile repeated per loop iteration or round",
    "blocking-in-async":
        "blocking call inside a coroutine",
    "unguarded-div":
        "ratio statistic dividing by a possibly-zero counter",
    "waiver-missing-reason":
        "qlint waiver without a stated reason",
}

HOT_ENTRIES = {"step", "steps", "_decode_round", "_prefill_chunk_round",
               "_decode_burst_round"}
HOT_ANCHORS = {"_decode_round", "_prefill_chunk_round"}

# torch calls that capture a graph or compile: once per shape, never per
# round
CAPTURES = ("torch.compile", "torch.cuda.graph", "torch.cuda.CUDAGraph")
# torch calls that return no tensor
_NOT_TENSOR = re.compile(r"^torch\.(cuda\.|device$|Size$|get_default_dtype$|"
                         r"is_tensor$|no_grad$|inference_mode$|compile$)")

_COUNTERISH = re.compile(
    r"(count|total|scored|served|reject|complet|finish|sample|request|"
    r"tick|round|seen|done|queued|pending|arrived|attempt|admitted|shed|"
    r"expired|cancel)", re.I)

_WAIVER_RE = re.compile(
    r"#\s*qlint:\s*disable=([A-Za-z0-9_\-, ]+?)\s*(?:--\s*(.*\S))?\s*$")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    waived: bool = False
    waive_reason: str = ""
    baselined: bool = False

    @property
    def fingerprint(self) -> str:
        raw = f"{self.rule}|{self.path}|{self.message}"
        return hashlib.sha1(raw.encode()).hexdigest()[:12]

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d

    def render(self) -> str:
        tag = ""
        if self.waived:
            tag = f"  [waived: {self.waive_reason}]"
        elif self.baselined:
            tag = "  [baselined]"
        return (f"{self.path}:{self.line}:{self.col}: {self.rule}: "
                f"{self.message}{tag}")


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------
def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _own_walk(fn: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested defs."""
    stack: List[ast.AST] = [fn]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if node is not fn and isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is fn and child is not fn:
                continue
            stack.append(child)


def _write_targets(t: ast.AST) -> List[str]:
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, ast.Attribute):
        d = _dotted(t)
        return [d] if d else []
    if isinstance(t, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in t.elts:
            out.extend(_write_targets(e))
        return out
    if isinstance(t, ast.Starred):
        return _write_targets(t.value)
    return []  # Subscript store mutates, doesn't rebind


class FileCtx:
    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[int, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[id(child)] = node
        self.aliases: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        self.waivers: Dict[int, Tuple[Set[str], str]] = {}
        self.findings: List[Finding] = []
        self._collect_waivers()

    def _collect_waivers(self) -> None:
        try:
            toks = list(tokenize.generate_tokens(
                iter(self.source.splitlines(True)).__next__))
        except tokenize.TokenizeError:
            return
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            m = _WAIVER_RE.search(tok.string)
            if not m:
                continue
            line = tok.start[0]
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            reason = (m.group(2) or "").strip()
            if not reason:
                self.add("waiver-missing-reason", line, tok.start[1],
                         "waiver must state a reason: "
                         "`# qlint: disable=<rule> -- <why>`")
                continue
            standalone = self.source.splitlines()[line - 1].lstrip() \
                .startswith("#")
            target = line + 1 if standalone else line
            self.waivers.setdefault(target, (set(), reason))[0].update(rules)
            if not standalone:
                # trailing comment also covers a continuation line
                self.waivers.setdefault(line, (rules, reason))

    def resolve(self, dotted: Optional[str]) -> Optional[str]:
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        head = self.aliases.get(head, head)
        return f"{head}.{rest}" if rest else head

    def add(self, rule: str, line: int, col: int, message: str) -> None:
        f = Finding(rule, self.rel, line, col, message)
        waiver = self.waivers.get(line)
        if waiver and rule in waiver[0] and rule != "waiver-missing-reason":
            f.waived, f.waive_reason = True, waiver[1]
        self.findings.append(f)


# ---------------------------------------------------------------------------
# the hot path: functions reachable from the round entry points
# ---------------------------------------------------------------------------
def _module_functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _called_names(fn: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(self-method names, bare function names) called from fn."""
    methods: Set[str] = set()
    bare: Set[str] = set()
    for n in _own_walk(fn):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self":
            methods.add(f.attr)
        elif isinstance(f, ast.Name):
            bare.add(f.id)
    return methods, bare


def _hot_functions(ctx: FileCtx) -> List[Tuple[str, ast.FunctionDef]]:
    """(name, def) of every function reachable from a hot entry of a
    class that has a hot anchor, through self-calls and bare calls of
    module functions."""
    mod_fns = _module_functions(ctx.tree)
    hot: Dict[int, Tuple[str, ast.FunctionDef]] = {}
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {n.name: n for n in cls.body
                   if isinstance(n, ast.FunctionDef)}
        if not (HOT_ANCHORS & set(methods)):
            continue
        work = [methods[m] for m in HOT_ENTRIES & set(methods)]
        for fn in work:
            hot[id(fn)] = (fn.name, fn)
        while work:
            fn = work.pop()
            m_calls, b_calls = _called_names(fn)
            for name in m_calls:
                tgt = methods.get(name)
                if tgt is not None and id(tgt) not in hot:
                    hot[id(tgt)] = (name, tgt)
                    work.append(tgt)
            for name in b_calls:
                tgt = mod_fns.get(name)
                if tgt is not None and id(tgt) not in hot:
                    hot[id(tgt)] = (name, tgt)
                    work.append(tgt)
    return list(hot.values())


# ---------------------------------------------------------------------------
# rule: host-sync-in-hot-path
# ---------------------------------------------------------------------------
def rule_host_sync(ctx: FileCtx) -> None:
    for name, fn in _hot_functions(ctx):
        _scan_hot_fn(ctx, name, fn)


def _tensor_call(ctx: FileCtx, call: ast.AST) -> bool:
    """Whether ``call`` is a call of a ``torch.*`` function that returns
    a tensor (not a ``torch.cuda`` helper or a constructor of a
    non-tensor)."""
    if not isinstance(call, ast.Call):
        return False
    rd = ctx.resolve(_dotted(call.func)) or ""
    return rd.startswith("torch.") and not _NOT_TENSOR.match(rd)


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _non_blocking(call: ast.Call) -> bool:
    v = _kw(call, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True


def _is_cpu(ctx: FileCtx, e: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(e, ast.Constant):
        return e.value == "cpu"
    if isinstance(e, ast.Call) \
            and ctx.resolve(_dotted(e.func)) == "torch.device" and e.args:
        return _is_cpu(ctx, e.args[0])
    return False


def _to_target(ctx: FileCtx, call: ast.Call) -> Optional[str]:
    """What ``x.to(...)`` moves to: ``"cpu"``, ``"device"`` (a device
    other than the CPU), or None (a dtype cast, or a target the source
    does not show)."""
    e = _kw(call, "device") or (call.args[0] if call.args else None)
    if e is None:
        return None
    if _is_cpu(ctx, e):
        return "cpu"
    if isinstance(e, ast.Constant) and isinstance(e.value, str):
        return "device"
    if isinstance(e, ast.Call) and ctx.resolve(_dotted(e.func)) \
            == "torch.device":
        return "device"
    d = _dotted(e) or ""
    if re.search(r"dev", d.split(".")[-1]) and not d.endswith("dtype"):
        return "device"
    return None


def _scan_hot_fn(ctx: FileCtx, name: str, fn: ast.FunctionDef) -> None:
    # names holding tensors (local dataflow)
    device: Set[str] = set()
    for n in _own_walk(fn):
        if isinstance(n, ast.Assign) and _tensor_call(ctx, n.value):
            for t in n.targets:
                device.update(_write_targets(t))
    where = f"in hot-path function `{name}`"
    upload = (f"is a blocking host->device copy: it waits for all the work "
              f"queued on the stream {where} — upload from pinned memory "
              f"with non_blocking=True")
    for n in _own_walk(fn):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        rd = ctx.resolve(_dotted(f)) or ""
        attr = f.attr if isinstance(f, ast.Attribute) else None
        if attr == "item" and not n.args:
            ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                    f".item() forces a device->host sync {where}")
        elif attr == "tolist" and not n.args:
            ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                    f".tolist() copies a tensor to the host {where}")
        elif attr == "cpu" and not n.args:
            ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                    f".cpu() copies device memory to the host and waits "
                    f"for it {where}")
        elif attr == "numpy" and not n.args:
            inner = f.value
            if isinstance(inner, ast.Call) and isinstance(
                    inner.func, ast.Attribute) and (
                    inner.func.attr == "cpu"
                    or (inner.func.attr == "to"
                        and _to_target(ctx, inner) == "cpu")):
                continue        # the copy before it is the finding
            ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                    f".numpy() reads a tensor on the host {where}")
        elif attr == "to" and _to_target(ctx, n) == "cpu":
            ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                    f'.to("cpu") copies device memory to the host and '
                    f'waits for it {where}')
        elif rd == "torch.cuda.synchronize":
            ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                    f"torch.cuda.synchronize() waits for the whole device "
                    f"{where}")
        elif attr == "synchronize":
            ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                    f".synchronize() blocks the host on the device {where}")
        elif rd in ("numpy.asarray", "numpy.array"):
            ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                    f"{rd}() copies device memory to host {where}")
        elif rd in ("torch.tensor", "torch.as_tensor") \
                and _kw(n, "device") is not None \
                and not _is_cpu(ctx, _kw(n, "device")):
            ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                    f"{rd}(..., device=...) {upload}")
        elif ((attr == "to" and _to_target(ctx, n) == "device")
              or attr == "cuda") and not _non_blocking(n):
            ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                    f".{attr}(<device>) without non_blocking=True {upload}")
        elif isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
                and len(n.args) == 1:
            a = n.args[0]
            k = _dotted(a)
            if k in device:
                ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                        f"{f.id}({k}) forces a device->host sync on a "
                        f"tensor {where}")
            elif _tensor_call(ctx, a):
                ctx.add("host-sync-in-hot-path", n.lineno, n.col_offset,
                        f"{f.id}({_dotted(a.func)}(...)) forces a "
                        f"device->host sync on a tensor {where}")


# ---------------------------------------------------------------------------
# rule: retrace-hazard (torch meaning: capture or compile per iteration)
# ---------------------------------------------------------------------------
def rule_retrace(ctx: FileCtx) -> None:
    hot = {id(fn): name for name, fn in _hot_functions(ctx)}
    for n in ast.walk(ctx.tree):
        if not isinstance(n, ast.Call):
            continue
        rd = ctx.resolve(_dotted(n.func))
        if rd not in CAPTURES:
            continue
        p = ctx.parents.get(id(n))
        in_loop = False
        while p is not None and not isinstance(
                p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
            in_loop = in_loop or isinstance(p, (ast.For, ast.While,
                                                ast.AsyncFor))
            p = ctx.parents.get(id(p))
        if id(p) in hot:
            ctx.add("retrace-hazard", n.lineno, n.col_offset,
                    f"{rd}() in hot-path function `{hot[id(p)]}` — "
                    f"captures (or compiles) every round; capture once "
                    f"per (backend, max_slots) and replay")
        elif in_loop:
            ctx.add("retrace-hazard", n.lineno, n.col_offset,
                    f"{rd}() called inside a loop — captures (or "
                    f"compiles) anew every iteration; hoist it out")


# ---------------------------------------------------------------------------
# rule: blocking-in-async
# ---------------------------------------------------------------------------
def rule_blocking_in_async(ctx: FileCtx) -> None:
    queue_objs: Set[str] = set()
    for n in ast.walk(ctx.tree):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                and ctx.resolve(_dotted(n.value.func)) == "queue.Queue":
            for t in n.targets:
                queue_objs.update(_write_targets(t))

    def in_executor(node: ast.AST) -> bool:
        p = ctx.parents.get(id(node))
        while p is not None and not isinstance(p, ast.AsyncFunctionDef):
            if isinstance(p, ast.Call):
                fa = p.func
                name = fa.attr if isinstance(fa, ast.Attribute) else \
                    getattr(fa, "id", "")
                if name in ("run_in_executor", "to_thread"):
                    return True
            p = ctx.parents.get(id(p))
        return False

    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        for n in _own_walk(fn):
            if not isinstance(n, ast.Call):
                continue
            rd = ctx.resolve(_dotted(n.func)) or ""
            if rd == "time.sleep":
                ctx.add("blocking-in-async", n.lineno, n.col_offset,
                        f"time.sleep() blocks the event loop in coroutine "
                        f"`{fn.name}` — use `await asyncio.sleep(...)`")
                continue
            if rd == "torch.cuda.synchronize" and not in_executor(n):
                ctx.add("blocking-in-async", n.lineno, n.col_offset,
                        f"torch.cuda.synchronize() blocks the event loop "
                        f"until the device drains in coroutine "
                        f"`{fn.name}` — offload via run_in_executor")
                continue
            if not isinstance(n.func, ast.Attribute):
                continue
            base = _dotted(n.func.value)
            attr = n.func.attr
            if attr in ("get", "put") and base in queue_objs \
                    and not in_executor(n):
                ctx.add("blocking-in-async", n.lineno, n.col_offset,
                        f"blocking queue.Queue.{attr}() on `{base}` in "
                        f"coroutine `{fn.name}` — use asyncio.Queue or an "
                        f"executor")
            elif attr in ("run_iteration", "step", "steps") and base \
                    and re.search(r"(agent|engine)", base.split(".")[-1]) \
                    and not in_executor(n):
                ctx.add("blocking-in-async", n.lineno, n.col_offset,
                        f"synchronous `{base}.{attr}()` in coroutine "
                        f"`{fn.name}` blocks the event loop for a full "
                        f"engine round — offload via run_in_executor or "
                        f"keep rounds bounded")


# ---------------------------------------------------------------------------
# rule: unguarded-div
# ---------------------------------------------------------------------------
def _mentions(e: ast.AST, keys: Set[str]) -> bool:
    for n in ast.walk(e):
        if isinstance(n, (ast.Name, ast.Attribute)):
            d = _dotted(n)
            if d in keys:
                return True
    return False


def _terminal(stmt_list: Sequence[ast.stmt]) -> bool:
    return bool(stmt_list) and isinstance(
        stmt_list[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def rule_unguarded_div(ctx: FileCtx) -> None:
    funcs = [n for n in ast.walk(ctx.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in funcs:
        for n in _own_walk(fn):
            if not (isinstance(n, ast.BinOp)
                    and isinstance(n.op, (ast.Div, ast.FloorDiv))):
                continue
            denom = n.right
            keys: Set[str] = set()
            label = None
            if isinstance(denom, (ast.Name, ast.Attribute)):
                d = _dotted(denom)
                if not d:
                    continue
                last = d.split(".")[-1]
                if not _COUNTERISH.search(last):
                    continue
                label = d
                keys = {d}
            elif isinstance(denom, ast.Call) \
                    and isinstance(denom.func, ast.Name) \
                    and denom.func.id == "len" and denom.args:
                inner = _dotted(denom.args[0])
                if not inner:
                    continue
                label = f"len({inner})"
                keys = {inner, label}
            else:
                continue  # max()/or-guards/arithmetic denominators are safe
            if _div_guarded(ctx, fn, n, keys):
                continue
            ctx.add("unguarded-div", n.lineno, n.col_offset,
                    f"division by possibly-zero `{label}` — guard with "
                    f"`max({label}, 1)`, `... if {label} else ...`, or an "
                    f"early return (zero-request / all-rejected runs hit "
                    f"this)")


def _div_guarded(ctx: FileCtx, fn: ast.AST, div: ast.BinOp,
                 keys: Set[str]) -> bool:
    # ancestor if/while/ternary whose test mentions the denominator
    p = ctx.parents.get(id(div))
    while p is not None and p is not fn:
        if isinstance(p, (ast.If, ast.While, ast.IfExp)) \
                and _mentions(p.test, keys):
            return True
        if isinstance(p, ast.Assert) and _mentions(p.test, keys):
            return True
        p = ctx.parents.get(id(p))
    # earlier early-return guard or assert in the same function
    for s in _own_walk(fn):
        if getattr(s, "lineno", 10**9) >= div.lineno:
            continue
        if isinstance(s, ast.If) and _mentions(s.test, keys) \
                and _terminal(s.body):
            return True
        if isinstance(s, ast.Assert) and _mentions(s.test, keys):
            return True
        if isinstance(s, ast.Assign):
            # denom rebound through a guard: d = max(d, 1) / d = x or 1
            tgts = {k for t in s.targets for k in _write_targets(t)}
            if tgts & keys and (isinstance(s.value, ast.BoolOp) or (
                    isinstance(s.value, ast.Call)
                    and isinstance(s.value.func, ast.Name)
                    and s.value.func.id in ("max", "min"))):
                return True
    return False


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------
_ALL_RULES = (rule_host_sync, rule_retrace, rule_blocking_in_async,
              rule_unguarded_div)


def lint_file(path: str, rel: Optional[str] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    try:
        ctx = FileCtx(path, rel or path, source)
    except SyntaxError as e:
        return [Finding("syntax-error", rel or path, e.lineno or 0, 0,
                        str(e))]
    for rule in _ALL_RULES:
        rule(ctx)
    ctx.findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return ctx.findings


def iter_py(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_py(paths):
        findings.extend(lint_file(path, os.path.relpath(path)))
    return findings


def _self_test(paths: Sequence[str]) -> int:
    """Copy the engine, inject a known hot-path violation, assert it is
    flagged."""
    import shutil
    import tempfile
    engine = None
    for path in iter_py(paths):
        if path.replace(os.sep, "/").endswith("serving/engine.py"):
            engine = path
            break
    if engine is None:
        print("qlint self-test: no serving/engine.py under target",
              file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "engine.py")
        shutil.copy(engine, dst)
        with open(dst, encoding="utf-8") as fh:
            lines = fh.readlines()
        for i, line in enumerate(lines):
            m = re.match(r"(\s*)def _decode_round\(", line)
            if m:
                indent = m.group(1) + "    "
                lines.insert(i + 1, f"{indent}torch.cuda.synchronize()\n")
                break
        else:
            print("qlint self-test: _decode_round not found",
                  file=sys.stderr)
            return 1
        with open(dst, "w", encoding="utf-8") as fh:
            fh.writelines(lines)
        hits = [f for f in lint_file(dst, "self-test/engine.py")
                if f.rule == "host-sync-in-hot-path" and not f.waived
                and f.line == i + 2 and "synchronize" in f.message]
    if hits:
        print(f"qlint self-test OK: injected torch.cuda.synchronize() in "
              f"_decode_round was flagged ({hits[0].render()})")
        return 0
    print("qlint self-test FAILED: injected hot-path sync was NOT flagged",
          file=sys.stderr)
    return 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="PyTorch-aware static analysis for the port's serving "
                    "stack")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint "
                         "(default: src/repro_torch)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full report (incl. waived/baselined) "
                         "as JSON")
    ap.add_argument("--baseline", metavar="PATH",
                    default="qlint_baseline.json",
                    help="fingerprint baseline; gate is zero NEW findings")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current unwaived findings to the baseline "
                         "and exit 0")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print waived and baselined findings")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--self-test", action="store_true",
                    help="inject a known violation and assert a nonzero "
                         "gate")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule:24s} {desc}")
        return 0
    if args.self_test:
        return _self_test(args.paths or ["src/repro_torch"])

    findings = lint_paths(args.paths or ["src/repro_torch"])

    baseline: Set[str] = set()
    if args.baseline and os.path.exists(args.baseline) \
            and not args.write_baseline:
        with open(args.baseline, encoding="utf-8") as fh:
            baseline = set(json.load(fh).get("fingerprints", []))
    for f in findings:
        if not f.waived and f.fingerprint in baseline:
            f.baselined = True

    active = [f for f in findings if not f.waived and not f.baselined]

    if args.write_baseline:
        payload = {"fingerprints": sorted({f.fingerprint for f in active})}
        with open(args.baseline, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2)
            fh.write("\n")
        print(f"wrote {len(payload['fingerprints'])} fingerprint(s) to "
              f"{args.baseline}")
        return 0

    shown = findings if args.show_waived else active
    for f in shown:
        print(f.render())
    n_waived = sum(f.waived for f in findings)
    n_base = sum(f.baselined for f in findings)
    print(f"qlint: {len(active)} finding(s) "
          f"({n_waived} waived, {n_base} baselined)")

    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump({
                "findings": [f.to_json() for f in findings],
                "summary": {"active": len(active), "waived": n_waived,
                            "baselined": n_base},
            }, fh, indent=2)
            fh.write("\n")

    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
