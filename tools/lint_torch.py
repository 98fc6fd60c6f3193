#!/usr/bin/env python
"""Static-analysis entry point of the port — the twin of ``tools/lint.py``
over ``veles/simd_tpu_torch/`` and the port's scripts.

Two passes, and the exit status is the gate:

* the **base pass** (``tools/lint.py``'s dependency-free fallback):
  ``py_compile`` on every source, then an AST scan for unused imports,
  lines over 79 columns and trailing whitespace, over
  ``veles/simd_tpu_torch/**/*.py``, the port's tests
  (``tests/*torch*.py``), tools (``tools/*torch*.py``), examples
  (``examples/*_torch.py``), ``bench_torch.py``,
  ``graft_entry_torch.py`` and ``chip_smoke.py``;
* the **project rules** of ``tools/lint.py``, with the port's module
  names and directories as this file's own constants, on the port's
  package.  Rules whose JAX form names a JAX construct take a torch
  form here:

  - *telemetry and clocks* (``ops/``, ``parallel/``, ``pipeline/``):
    obs only through the approved facade helpers (``tools/lint.py``'s
    set, plus the port's two compile-event helpers, which carry the
    nvcc build's and the graph capture's timings into ``obs.compile``
    so that no compute module reads a clock), no raw ``time.*``
    clocks, no import of ``obs`` internals;
  - *compile sites* (the whole package): ``torch.compile``,
    ``torch.jit.*`` and CUDA-graph capture (``torch.cuda.graph``,
    ``CUDAGraph``, ``make_graphed_callables``) only in
    ``pipeline/compiler.py``; ``ctypes.CDLL`` only in
    ``ops/cuda_kernels.load_library``, ``cabi/`` and
    ``utils/devtrace.py`` — a compile or a library load anywhere else
    is one the resource and compile axes cannot see;
  - *fault handler* (``ops/``, ``parallel/``, ``pipeline/``): no broad
    ``except`` whose try body reaches an ``ops.cuda_kernels`` alias or
    an ``obs.instrumented_jit`` function — failure policy belongs to
    ``runtime/faults.py``;
  - *precision* (the whole package): ``torch.set_float32_matmul_
    precision``, ``torch.backends.cuda.matmul.allow_tf32`` (and its
    reduced-precision-reduction kin), ``torch.backends.cudnn.
    allow_tf32`` and ``cudnn.flags`` only in ``runtime/precision.py``
    (``ops/cuda_kernels.py`` is exempt, as ``pallas_kernels.py`` is in
    the JAX package: the kernels pin their own arithmetic);
  - *artifacts* (``ops/``, ``parallel/``, ``serve/``, ``pipeline/``):
    no ``torch.save``/``torch.load`` and no ``pickle`` dumps or loads;
    the port's store is ``runtime/artifacts.py``;
  - *pipeline*: the compiled step — any handle bound from an
    ``obs.instrumented_jit(...)`` call, and the graph step
    (``_GraphStep``: its construction, which warms up and captures the
    stages, its ``run``, a graph's ``replay()``) — runs only inside a
    ``faults.guarded``/``breaker_guarded`` region, followed through
    the functions a guarded handle wraps;
  - the routing-selector, spectral-dispatch, serve-layer,
    request-trace, cluster-router, RPC-transport, scaler-control,
    fleet-funnel, journal-funnel, parallel-guard and segment-dispatch
    rules keep their semantics (``tools/lint.py`` gives each one's
    reason) on the port's counterpart files.

Every alias form counts (``import torch as t``, ``from torch.backends
import cudnn as c``, ``from ctypes import CDLL as L``), and each rule
body takes a parsed module and a file name, so tests can feed it
synthetic sources.

Run:  python tools/lint_torch.py [paths...]
"""

from __future__ import annotations

import ast
import py_compile
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MAX_LINE = 79
PKG = "veles.simd_tpu_torch"
PKG_DIR = "veles/simd_tpu_torch"
# dunder/side-effect imports the AST pass must not flag
_SIDE_EFFECT_IMPORTS = {"__future__"}
# the base pass's sources (repo-relative globs)
SOURCE_GLOBS = (f"{PKG_DIR}/**/*.py", "tests/*torch*.py",
                "tools/*torch*.py", "examples/*_torch.py",
                "bench_torch.py", "graft_entry_torch.py",
                "chip_smoke.py")


def python_sources(paths=None):
    if paths:
        for p in paths:
            p = Path(p)
            yield from (p.rglob("*.py") if p.is_dir() else [p])
        return
    for pat in SOURCE_GLOBS:
        yield from ROOT.glob(pat)


def _rel(fname) -> str:
    """``fname`` as a repo-relative posix path where it lies in the
    repo, else as given (synthetic sources name the file they
    stand for)."""
    p = Path(fname)
    try:
        return p.resolve().relative_to(ROOT).as_posix()
    except (ValueError, OSError):
        return p.as_posix()


# --- the base pass ----------------------------------------------------------

class _ImportScan(ast.NodeVisitor):
    def __init__(self):
        self.imported: dict[str, int] = {}
        self.used: set[str] = set()

    def visit_Import(self, node):
        for a in node.names:
            name = (a.asname or a.name).split(".")[0]
            self.imported.setdefault(name, node.lineno)

    def visit_ImportFrom(self, node):
        if node.module in _SIDE_EFFECT_IMPORTS:
            return
        for a in node.names:
            if a.name == "*":
                continue
            self.imported.setdefault(a.asname or a.name, node.lineno)

    def visit_Name(self, node):
        self.used.add(node.id)


def base_errors(path) -> list:
    """``tools/lint.py``'s fallback pass on one file: compile error,
    unused imports, long lines, trailing whitespace."""
    errors = []
    src = Path(path).read_text()
    try:
        py_compile.compile(str(path), doraise=True)
    except py_compile.PyCompileError as e:
        return [f"{path}: compile error: {e.msg}"]
    tree = ast.parse(src, str(path))
    scan = _ImportScan()
    scan.visit(tree)
    src_lines = src.splitlines()
    for name, lineno in sorted(scan.imported.items(), key=lambda kv: kv[1]):
        if name not in scan.used and f"{name}." not in src:
            # __all__ strings count as use (re-exports); honor noqa
            if f'"{name}"' in src or f"'{name}'" in src:
                continue
            if "noqa" in src_lines[lineno - 1]:
                continue
            errors.append(f"{path}:{lineno}: unused import '{name}'")
    for i, line in enumerate(src_lines, 1):
        if len(line) > MAX_LINE:
            errors.append(
                f"{path}:{i}: line too long ({len(line)} > {MAX_LINE})")
        if line != line.rstrip():
            errors.append(f"{path}:{i}: trailing whitespace")
    return errors


# --- shared helpers ---------------------------------------------------------

def _dotted_chain(node) -> str | None:
    """``a.b.c`` attribute chains as a dotted string (None when the
    chain's root is not a plain name)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _import_aliases(tree) -> dict:
    """Local name -> the dotted module or object it is bound to, for
    every absolute import of the module (``import torch as t`` binds
    ``t`` to ``torch``; ``import torch.backends.cudnn`` binds ``torch``;
    ``from torch.backends import cudnn as c`` binds ``c`` to
    ``torch.backends.cudnn``)."""
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    aliases[root] = root
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for a in node.names:
                if a.name != "*":
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _canonical(node, aliases) -> str | None:
    """The dotted name an attribute chain or a name refers to, with its
    root resolved through the module's imports (None when the root is
    not an imported name)."""
    chain = _dotted_chain(node)
    if chain is None:
        return None
    head, _, rest = chain.partition(".")
    if head not in aliases:
        return None
    return aliases[head] + ("." + rest if rest else "")


def _canonical_hits(tree, aliases, forbidden) -> list:
    """``(lineno, canonical, entry)`` for every name or attribute chain
    that refers to an entry of ``forbidden`` (or below it), one per
    line and entry."""
    seen, hits = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and not isinstance(node.ctx,
                                                         ast.Load):
            continue
        if not isinstance(node, (ast.Name, ast.Attribute)):
            continue
        canon = _canonical(node, aliases)
        if canon is None:
            continue
        for entry in forbidden:
            if canon == entry or canon.startswith(entry + "."):
                if (node.lineno, entry) not in seen:
                    seen.add((node.lineno, entry))
                    hits.append((node.lineno, canon, entry))
    return sorted(hits)


def _enclosing_functions(tree) -> dict:
    """``id(node) -> name of the module-level function it lies in``."""
    owner = {}
    for fn in tree.body:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for w in ast.walk(fn):
                owner[id(w)] = fn.name
    return owner


# --- telemetry-usage rule (ops/, parallel/, pipeline/) ----------------------
# the only obs entry points compute modules may call: tools/lint.py's
# set (pure Python-dispatch helpers), plus the port's compile-event
# helpers — the port compiles in two compute modules (the nvcc build in
# ops/cuda_kernels.load_library, the graph capture in
# pipeline/compiler.py), and these helpers let them announce it while
# the clock stays in obs/compile.py
_OBS_APPROVED = {"record_decision", "count", "span", "instrumented_jit",
                 "register_cache", "LRUSet"}
_OBS_PORT_APPROVED = {"compile_event", "compile_timer"}
_OBS_PKG = f"{PKG}.obs"
_OBS_RULE_DIRS = (f"{PKG_DIR}/ops", f"{PKG_DIR}/parallel")
_TIME_FORBIDDEN = {"time", "monotonic", "perf_counter",
                   "perf_counter_ns", "monotonic_ns"}


def telemetry_errors(tree, fname) -> list:
    """The telemetry and clock rule on a parsed module."""
    errors = []
    approved = _OBS_APPROVED | _OBS_PORT_APPROVED
    obs_names, time_names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _OBS_PKG or a.name.startswith(_OBS_PKG + "."):
                    errors.append(
                        f"{fname}:{node.lineno}: import telemetry via "
                        f"'from {PKG} import obs', not 'import {a.name}'")
                elif a.name == "time":
                    time_names.add(a.asname or "time")
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module == PKG:
                for a in node.names:
                    if a.name == "obs":
                        obs_names.add(a.asname or "obs")
            elif node.module == _OBS_PKG or \
                    node.module.startswith(_OBS_PKG + "."):
                errors.append(
                    f"{fname}:{node.lineno}: compute modules must not "
                    f"import telemetry internals ({node.module}); use "
                    "the obs facade's approved helpers")
            elif node.module == "time":
                names = [a.name for a in node.names
                         if a.name in _TIME_FORBIDDEN]
                if names:
                    errors.append(
                        f"{fname}:{node.lineno}: importing "
                        f"{', '.join(names)} from time in a compute "
                        "module — use obs.span for dispatch latency")
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)):
            continue
        if node.value.id in obs_names and node.attr not in approved:
            errors.append(
                f"{fname}:{node.lineno}: obs.{node.attr} is not an "
                "approved telemetry helper for compute modules "
                f"(allowed: {', '.join(sorted(approved))})")
        elif node.value.id in time_names and \
                node.attr in _TIME_FORBIDDEN:
            errors.append(
                f"{fname}:{node.lineno}: raw {node.value.id}."
                f"{node.attr} in a compute module — use obs.span for "
                "dispatch latency (utils/benchmark.py owns measurement, "
                "obs.compile_timer a compile's seconds)")
    return errors


# --- compile-site rule (the whole package) ----------------------------------
# The torch form of tools/lint.py's _JIT_FORBIDDEN: a program compiled
# or captured outside its one home is one the resource and compile
# axes cannot see.  CUDA-graph capture belongs to pipeline/compiler.py
# (which announces it through obs.compile_timer); torch.compile and
# TorchScript have no home in the port.  A shared library opened
# outside its loaders is a second, unstamped build the artifact store
# and the compile counters know nothing of.

_COMPILE_FORBIDDEN = ("torch.compile", "torch.jit",
                      "torch.cuda.graph", "torch.cuda.CUDAGraph",
                      "torch.cuda.graphs",
                      "torch.cuda.make_graphed_callables")
_COMPILE_HOME = f"{PKG_DIR}/pipeline/compiler.py"
_CDLL_FORBIDDEN = ("ctypes.CDLL", "ctypes.cdll", "ctypes.PyDLL")
_CDLL_HOMES = {f"{PKG_DIR}/ops/cuda_kernels.py": "load_library"}
_CDLL_HOME_PATHS = (f"{PKG_DIR}/cabi/", f"{PKG_DIR}/utils/devtrace.py")


def compile_site_errors(tree, fname) -> list:
    """The compile-site rule on a parsed module."""
    errors = []
    rel = _rel(fname)
    aliases = _import_aliases(tree)
    if not rel.endswith(_COMPILE_HOME):
        for lineno, canon, _entry in _canonical_hits(
                tree, aliases, _COMPILE_FORBIDDEN):
            errors.append(
                f"{fname}:{lineno}: {canon} outside "
                f"{_COMPILE_HOME} — torch.compile/TorchScript have no "
                "home in the port, and CUDA-graph capture belongs to "
                "the pipeline compiler, which the compile axis sees")
    if rel.startswith(_CDLL_HOME_PATHS) or any(
            rel.endswith(p) for p in _CDLL_HOME_PATHS):
        return errors
    home = next((fn for path, fn in _CDLL_HOMES.items()
                 if rel.endswith(path)), None)
    owner = _enclosing_functions(tree) if home else {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        canon = _canonical(node.func, aliases)
        if canon is None or not any(
                canon == e or canon.startswith(e + ".")
                for e in _CDLL_FORBIDDEN):
            continue
        if home and owner.get(id(node)) == home:
            continue
        errors.append(
            f"{fname}:{node.lineno}: {canon}(...) outside the library "
            "loaders (ops/cuda_kernels.load_library, cabi/, "
            "utils/devtrace.py) — a shared library opened elsewhere is "
            "a build the compile counters and the artifact store "
            "cannot see")
    return errors


# --- fault-policy rule (ops/, parallel/, pipeline/) -------------------------
# tools/lint.py's rule with the CUDA kernel module in place of the
# Pallas one: a broad exception handler whose try body reaches a kernel
# wrapper or an obs.instrumented_jit-compiled function is a hand-copied
# demote block — failure policy belongs to faults.demote_and_remember /
# faults.guarded.

_BROAD_EXC_NAMES = {"Exception", "BaseException"}


def _kernel_aliases(tree) -> set:
    """Names the module binds to the CUDA kernel module."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "cuda_kernels":
                    names.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith("cuda_kernels") and a.asname:
                    names.add(a.asname)
    return names


def _broad_handler(handler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name):
        return t.id in _BROAD_EXC_NAMES
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in _BROAD_EXC_NAMES
                   for e in t.elts)
    return False


def _is_instrumented_decorator(dec) -> bool:
    """``@obs.instrumented_jit`` or ``@functools.partial(
    obs.instrumented_jit, ...)`` (either spelling of the helper), or
    ``@obs.instrumented_jit(op=..., ...)``."""
    def is_helper(node):
        return ((isinstance(node, ast.Attribute)
                 and node.attr == "instrumented_jit")
                or (isinstance(node, ast.Name)
                    and node.id == "instrumented_jit"))

    if is_helper(dec):
        return True
    return (isinstance(dec, ast.Call)
            and (is_helper(dec.func)
                 or (dec.args and is_helper(dec.args[0]))))


def fault_handler_errors(tree, fname) -> list:
    """The fault-policy rule on a parsed module."""
    errors = []
    aliases = _kernel_aliases(tree)
    instrumented = {
        node.name for node in tree.body
        if isinstance(node, ast.FunctionDef)
        and any(_is_instrumented_decorator(d)
                for d in node.decorator_list)}

    def touches_compile_site(body) -> bool:
        for n in body:
            for w in ast.walk(n):
                if (isinstance(w, ast.Attribute)
                        and isinstance(w.value, ast.Name)
                        and w.value.id in aliases):
                    return True
                if (isinstance(w, ast.Call)
                        and isinstance(w.func, ast.Name)
                        and w.func.id in instrumented):
                    return True
        return False

    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        if not any(_broad_handler(h) for h in node.handlers):
            continue
        if touches_compile_site(node.body):
            errors.append(
                f"{fname}:{node.lineno}: raw 'except Exception' around "
                "a CUDA-kernel/instrumented call site in a compute "
                "module — route the failure through the fault-policy "
                "engine (runtime/faults.demote_and_remember or "
                "faults.guarded)")
    return errors


# --- precision rule (the whole package) -------------------------------------
# runtime/precision.py is the ONE home of the process-wide matmul and
# convolution precision switches (prx.fp32_matmul / fp32_conv /
# p_einsum / p_matmul): every contraction's precision is a route the
# engine can select and the parity suites can budget, and a stray
# switch elsewhere changes every other thread's arithmetic.
# ops/cuda_kernels.py is exempt, as ops/pallas_kernels.py is in the
# JAX package: the kernels pin their own arithmetic.

_PRECISION_FORBIDDEN = (
    "torch.set_float32_matmul_precision",
    "torch.backends.cuda.matmul.allow_tf32",
    "torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction",
    "torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction",
    "torch.backends.cudnn.allow_tf32",
    "torch.backends.cudnn.flags")
_PRECISION_HOME = f"{PKG_DIR}/runtime/precision.py"
_PRECISION_RULE_EXEMPT = (_PRECISION_HOME,
                          f"{PKG_DIR}/ops/cuda_kernels.py")


def precision_errors(tree, fname) -> list:
    """The precision rule on a parsed module."""
    rel = _rel(fname)
    if any(rel.endswith(p) for p in _PRECISION_RULE_EXEMPT):
        return []
    return [
        f"{fname}:{lineno}: raw precision switch {canon} in the port "
        "— precision is a routed decision; go through the precision "
        "layer (runtime/precision.py: prx.fp32_matmul / fp32_conv / "
        "p_einsum)"
        for lineno, canon, _entry in _canonical_hits(
            tree, _import_aliases(tree), _PRECISION_FORBIDDEN)]


# --- artifact-serialization rule (ops/, parallel/, serve/, pipeline/) ------
# runtime/artifacts.py is the ONE home of serialized programs and their
# stamps (schema, device name, sha256): a raw torch.save/torch.load or
# pickle round trip in these layers bypasses every stamp and counter
# that keeps a stale pack from loading into the wrong runtime (and a
# pickle load executes what it reads).

_ARTIFACT_FORBIDDEN = ("torch.save", "torch.load", "pickle.dump",
                       "pickle.dumps", "pickle.load", "pickle.loads")


def artifact_serialization_errors(tree, fname) -> list:
    """The artifact rule on a parsed module."""
    return [
        f"{fname}:{lineno}: raw {canon} in a compute/serving module — "
        "serialization belongs to the artifact store "
        "(runtime/artifacts.py), whose stamps and counters a raw call "
        "bypasses"
        for lineno, canon, _entry in _canonical_hits(
            tree, _import_aliases(tree), _ARTIFACT_FORBIDDEN)]


# --- routing-engine rule (ops/, parallel/) ----------------------------------
# The route choice has one home, runtime/routing.py.  A module-level
# selector (``_use_*`` / ``_select_*`` / ``select_*``) must reference
# the routing engine — a name bound from a ``routing.family(...)`` call,
# the family factory, or ``<alias>.family``/``get_family``; a module
# with a ``*_ROUTES`` runner table must declare its candidate table
# through ``routing.family`` too; and no code asks the table by hand:
# nothing branches on ``routing.autotune_mode()`` (``Family.select``
# applies the mode) and nothing calls a per-route gate (``.gate`` /
# ``.route_allowed``).  Reading the mode as a value — a decision
# event's field — is no branch.

_ROUTING_MOD = f"{PKG}.runtime.routing"
_SELECTOR_PREFIXES = ("_use_", "_select_", "select_")
_HAND_GATES = ("gate", "route_allowed")
_ASK_THE_TABLE = ("a dispatch site asks Family.select for its route "
                  "(Family.static_select for a choice that is static by "
                  "contract), which applies the table's eligibility and "
                  "the autotune mode")


def _routing_aliases(tree) -> tuple:
    """``(module_aliases, family_fns)``: names bound to the routing
    engine module, and names bound to its ``family`` factory."""
    modules, family_fns = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == f"{PKG}.runtime":
                for a in node.names:
                    if a.name == "routing":
                        modules.add(a.asname or a.name)
            elif node.module == _ROUTING_MOD:
                for a in node.names:
                    if a.name == "family":
                        family_fns.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _ROUTING_MOD and a.asname:
                    modules.add(a.asname)
    return modules, family_fns


def _family_table_names(tree, modules, family_fns) -> set:
    """Module-level names assigned from ``<alias>.family(...)`` /
    ``family(...)`` calls."""
    names = set()
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            continue
        func = node.value.func
        if (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id in modules
                and func.attr == "family") or (
                isinstance(func, ast.Name) and func.id in family_fns):
            names.add(node.targets[0].id)
    return names


def routing_selector_errors(tree, fname) -> list:
    """The routing rule on a parsed module."""
    errors = []
    modules, family_fns = _routing_aliases(tree)
    families = _family_table_names(tree, modules, family_fns)
    table_names = family_fns | families

    def references_engine(fn) -> bool:
        for n in ast.walk(fn):
            if isinstance(n, ast.Name) and n.id in table_names:
                return True
            if (isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id in modules
                    and n.attr in ("family", "get_family")):
                return True
        return False

    has_routes_table = any(
        isinstance(node, ast.Assign) and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name)
        and node.targets[0].id.endswith("_ROUTES")
        for node in tree.body)
    if has_routes_table and not families:
        errors.append(
            f"{fname}: a *_ROUTES runner table without a "
            "routing.family(...) candidate table — declare the "
            f"family's routes through {_ROUTING_MOD}")
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        if not node.name.startswith(_SELECTOR_PREFIXES):
            continue
        if not references_engine(node):
            errors.append(
                f"{fname}:{node.lineno}: selector {node.name} does not "
                "consult the routing engine — route predicates belong in "
                "a runtime.routing candidate table (routing.family), and "
                + _ASK_THE_TABLE)
    errors += _hand_selection(tree, fname, modules)
    return errors


def _hand_selection(tree, fname, modules) -> list:
    """The protocol re-implemented around the table: a branch on
    ``autotune_mode()`` or a call of a per-route gate."""
    def is_mode_call(n) -> bool:
        if not isinstance(n, ast.Call):
            return False
        f = n.func
        return ((isinstance(f, ast.Attribute) and f.attr == "autotune_mode"
                 and isinstance(f.value, ast.Name)
                 and f.value.id in modules)
                or (isinstance(f, ast.Name) and f.id == "autotune_mode"))

    tests = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.IfExp, ast.While, ast.Assert)):
            tests.append(node.test)
        elif isinstance(node, (ast.Compare, ast.BoolOp)) or (
                isinstance(node, ast.UnaryOp)
                and isinstance(node.op, ast.Not)):
            tests.append(node)
    branch_lines = sorted({n.lineno for t in tests for n in ast.walk(t)
                           if is_mode_call(n)})
    errors = [f"{fname}:{line}: branches on routing.autotune_mode() — "
              + _ASK_THE_TABLE for line in branch_lines]
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _HAND_GATES):
            errors.append(
                f"{fname}:{node.lineno}: calls Family.{node.func.attr} "
                "— " + _ASK_THE_TABLE)
    return errors


# --- route-dispatch rule (ops/spectral.py, parallel/fourier.py) -------------
# Every route-table entry resolves to a module-level runner whose body
# reaches an obs.instrumented_jit core (directly, through the CUDA
# kernel module whose wrappers are instrumented in place, or
# transitively through module-level helpers) — a route run any other
# way is invisible to the resource axis — and every public dispatcher
# that indexes a route table does so inside a ``with obs.span(...)``.

_DISPATCH_RULE_FILES = (f"{PKG_DIR}/ops/spectral.py",
                        f"{PKG_DIR}/parallel/fourier.py")


def spectral_dispatch_errors(tree, fname) -> list:
    """The route-dispatch rule on a parsed module."""
    errors = []
    funcs = {}
    instrumented = set()
    kernels = _kernel_aliases(tree)
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            funcs[node.name] = node
            if any(_is_instrumented_decorator(d)
                   for d in node.decorator_list):
                instrumented.add(node.name)
            elif any(isinstance(n, ast.Attribute)
                     and n.attr == "instrumented_jit"
                     for n in ast.walk(node)):
                # a helper that CALLS obs.instrumented_jit in its body
                instrumented.add(node.name)
    changed = True
    while changed:
        changed = False
        for name, fn in funcs.items():
            if name in instrumented:
                continue
            names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
            if names & instrumented:
                instrumented.add(name)
                changed = True
    tables = {
        node.targets[0].id: node
        for node in tree.body
        if isinstance(node, ast.Assign) and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name)
        and node.targets[0].id.endswith("_ROUTES")
        and isinstance(node.value, ast.Dict)}
    if not tables:
        errors.append(f"{fname}: no *_ROUTES dispatch tables found "
                      "(the spectral route rule expects them)")
        return errors
    for tname, node in tables.items():
        for v in node.value.values:
            if not isinstance(v, ast.Name) or v.id not in funcs:
                errors.append(
                    f"{fname}:{node.lineno}: {tname} values must be "
                    "module-level route runner functions")
                continue
            runner = funcs[v.id]
            names = {n.id for n in ast.walk(runner)
                     if isinstance(n, ast.Name)}
            # a runner may delegate to the CUDA kernel module, whose
            # wrappers are instrumented_jit in place
            uses_kernels = any(
                isinstance(a, ast.Attribute)
                and isinstance(a.value, ast.Name)
                and a.value.id in kernels
                for a in ast.walk(runner))
            if not (names & instrumented or uses_kernels):
                errors.append(
                    f"{fname}:{runner.lineno}: route runner {v.id} "
                    "reaches no obs.instrumented_jit core — the "
                    "resource axis cannot see this route")
    for fn in funcs.values():
        if fn.name.startswith("_"):
            continue
        loads = [n for n in ast.walk(fn)
                 if isinstance(n, ast.Subscript)
                 and isinstance(n.value, ast.Name)
                 and n.value.id in tables]
        if not loads:
            continue
        inside_span = set()
        for w in ast.walk(fn):
            if isinstance(w, ast.With) and any(
                    isinstance(it.context_expr, ast.Call)
                    and isinstance(it.context_expr.func, ast.Attribute)
                    and it.context_expr.func.attr == "span"
                    for it in w.items):
                for body_node in w.body:
                    inside_span.update(id(x) for x in ast.walk(body_node))
        for load in loads:
            if id(load) not in inside_span:
                errors.append(
                    f"{fname}:{load.lineno}: {fn.name} dispatches "
                    f"{load.value.id} outside a 'with obs.span(...)' "
                    "scope — the time axis cannot see this route")
    return errors


# --- serving-layer rule (serve/) --------------------------------------------
# Every dispatch into ops.batched happens inside a thunk handed to
# faults.guarded (the oracle path — simd=False or a *_na twin — is
# exempt), a serve module that dispatches records via obs, and no serve
# module imports time (deadlines read faults.monotonic).

_SERVE_RULE_DIR = f"{PKG_DIR}/serve"
_BATCHED_MOD = f"{PKG}.ops.batched"
_SERVE_OBS_HELPERS = {"span", "count", "gauge", "observe",
                      "record_decision", "quantiles",
                      "request_trace", "request_summary",
                      "slo_snapshot", "fleet_record", "signals"}
_PKG_LEAF = PKG.rsplit(".", 1)[1]


def _serve_aliases(tree) -> tuple:
    """``(batched_aliases, batched_names, ops_pkg_aliases,
    faults_aliases, guarded_names, obs_aliases)``; ``batched_names``
    maps each name bound from the batched module to the name it was
    imported as, so ``import ... as`` cannot hide a ``batched_*``
    entry point."""
    batched_mods, ops_pkgs = set(), set()
    batched_names: dict = {}
    faults_mods, guarded_names, obs_names = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == f"{PKG}.ops":
                for a in node.names:
                    if a.name == "batched":
                        batched_mods.add(a.asname or a.name)
            elif node.module == _BATCHED_MOD:
                for a in node.names:
                    batched_names[a.asname or a.name] = a.name
            elif node.module in ("veles", PKG):
                for a in node.names:
                    if a.name in ("ops", _PKG_LEAF):
                        ops_pkgs.add(a.asname or a.name)
            elif node.module == f"{PKG}.runtime":
                for a in node.names:
                    if a.name == "faults":
                        faults_mods.add(a.asname or a.name)
            elif node.module == f"{PKG}.runtime.faults":
                for a in node.names:
                    if a.name == "guarded":
                        guarded_names.add(a.asname or a.name)
            if node.module == PKG:
                for a in node.names:
                    if a.name == "obs":
                        obs_names.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _BATCHED_MOD and a.asname:
                    batched_mods.add(a.asname)
                elif a.name == f"{PKG}.runtime.faults" and a.asname:
                    faults_mods.add(a.asname)
                elif a.name.startswith("veles"):
                    ops_pkgs.add(a.asname or "veles")
    return (batched_mods, batched_names, ops_pkgs, faults_mods,
            guarded_names, obs_names)


def _guarded_regions(tree, faults_mods, guarded_names) -> set:
    """ids of AST nodes lexically inside a ``faults.guarded(...)``
    call's arguments, or inside a function transitively reachable (by
    name reference) from one."""
    funcs = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs.setdefault(node.name, node)
    inside: set = set()
    guarded_fns: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        is_guarded = (
            (isinstance(f, ast.Attribute) and f.attr == "guarded"
             and isinstance(f.value, ast.Name)
             and f.value.id in faults_mods)
            or (isinstance(f, ast.Name) and f.id in guarded_names))
        if not is_guarded:
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for w in ast.walk(arg):
                inside.add(id(w))
                if isinstance(w, ast.Name) and w.id in funcs:
                    guarded_fns.add(w.id)
    changed = True
    while changed:
        changed = False
        for name in list(guarded_fns):
            for w in ast.walk(funcs[name]):
                inside.add(id(w))
                if (isinstance(w, ast.Name) and w.id in funcs
                        and w.id not in guarded_fns):
                    guarded_fns.add(w.id)
                    changed = True
    return inside


def serve_layer_errors(tree, fname) -> list:
    """The serving-layer rule on a parsed module."""
    errors = []
    (batched_mods, batched_names, ops_pkgs, faults_mods,
     guarded_names, obs_names) = _serve_aliases(tree)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Import) and any(
                a.name == "time" or a.name.startswith("time.")
                for a in node.names)) or (
                isinstance(node, ast.ImportFrom)
                and node.module == "time"):
            errors.append(
                f"{fname}:{node.lineno}: raw time import in a serve "
                "module — deadlines read faults.monotonic, latency "
                "belongs to obs.span/observe")
    guarded = _guarded_regions(tree, faults_mods, guarded_names)
    dispatches = records = 0
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id in obs_names
                and f.attr in _SERVE_OBS_HELPERS):
            records += 1
            continue
        is_batched = False
        if isinstance(f, ast.Name) and f.id in batched_names:
            is_batched, attr = True, batched_names[f.id]
        elif isinstance(f, ast.Attribute):
            chain = _dotted_chain(f)
            if chain is not None:
                head, *rest = chain.split(".")
                is_batched = (
                    (head in batched_mods and len(rest) == 1)
                    or (head in ops_pkgs and len(rest) >= 2
                        and rest[-2] == "batched"))
                attr = rest[-1] if rest else head
        if not is_batched or not attr.startswith("batched_"):
            continue
        if attr.endswith("_na"):
            continue    # the oracle twin cannot fault
        if any(kw.arg == "simd" and isinstance(kw.value, ast.Constant)
               and kw.value.value is False for kw in node.keywords):
            continue    # explicit oracle route
        dispatches += 1
        if id(node) not in guarded:
            errors.append(
                f"{fname}:{node.lineno}: bare batched-op dispatch in a "
                "serve module — device dispatch must run inside a "
                "faults.guarded thunk (retry/degrade/health policy)")
    if dispatches and not records:
        errors.append(
            f"{fname}: serve module dispatches ops but never records "
            "via obs (span/count/gauge/observe/record_decision) — an "
            "unobservable serving loop")
    return errors


# --- request-trace rule (serve/, pipeline/) ---------------------------------
# Terminal request accounting belongs to the request-trace API
# (obs/requests.py: Ticket._complete -> trace.finish); an obs.count /
# obs.observe naming a terminal metric beside it drifts from the trace.

_TERMINAL_METRICS = {"serve_completed", "serve_deadline_miss",
                     "serve.request_latency"}


def request_trace_errors(tree, fname) -> list:
    """The request-trace rule on a parsed module."""
    errors = []
    obs_names = _serve_aliases(tree)[5]
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in ("count", "observe")
                and isinstance(f.value, ast.Name)
                and f.value.id in obs_names):
            continue
        name_arg = node.args[0] if node.args else None
        if (isinstance(name_arg, ast.Constant)
                and name_arg.value in _TERMINAL_METRICS):
            errors.append(
                f"{fname}:{node.lineno}: hand-rolled terminal request "
                f"accounting (obs.{f.attr}({name_arg.value!r}, ...)) in "
                "a serve/pipeline module — terminal outcomes flow "
                "through the request-trace API (Ticket._complete -> "
                "trace.finish, obs/requests.py)")
    return errors


# --- cluster router rule (serve/cluster.py) ---------------------------------
# _submit_to_replica is the only call site allowed to submit into a
# replica: it carries the original deadline and the typed placement
# failure handling.

_CLUSTER_RULE_FILE = f"{PKG_DIR}/serve/cluster.py"
_CLUSTER_FUNNEL = "_submit_to_replica"


def cluster_router_errors(tree, fname) -> list:
    """The cluster-router rule on a parsed module."""
    errors = []
    funnel_nodes: set = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == _CLUSTER_FUNNEL:
            funnel_nodes.update(id(w) for w in ast.walk(node))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "submit" \
                and id(node) not in funnel_nodes:
            errors.append(
                f"{fname}:{node.lineno}: replica submission outside the "
                f"{_CLUSTER_FUNNEL} funnel — router dispatch must go "
                "through the one guarded path that carries the original "
                "request deadline and handles typed placement failure")
    return errors


# --- rpc transport rule (serve/ but serve/rpc.py) ---------------------------
# serve/rpc.py is the one serve module that opens request-carrying
# transport to a replica; elsewhere http/socket imports and
# body-carrying urllib calls are refused (GET scrapes stay legal).

_RPC_RULE_FILE = f"{PKG_DIR}/serve/rpc.py"
_RPC_BANNED_IMPORTS = {"http", "socket"}


def _urllib_request_aliases(tree) -> tuple:
    """(dotted prefixes bound to urllib.request, names bound to
    urlopen, names bound to Request)."""
    mods, urlopen_names, request_names = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "urllib.request":
                    mods.add(a.asname or a.name)
                elif a.name == "urllib":
                    mods.add((a.asname or a.name) + ".request")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "urllib.request":
                for a in node.names:
                    if a.name == "urlopen":
                        urlopen_names.add(a.asname or a.name)
                    elif a.name == "Request":
                        request_names.add(a.asname or a.name)
            elif node.module == "urllib":
                for a in node.names:
                    if a.name == "request":
                        mods.add(a.asname or a.name)
    return mods, urlopen_names, request_names


def rpc_transport_errors(tree, fname) -> list:
    """The RPC-transport rule on a parsed module."""
    errors = []
    mods, urlopen_names, request_names = _urllib_request_aliases(tree)

    def _carries_body(node, data_pos) -> bool:
        if len(node.args) > data_pos:
            arg = node.args[data_pos]
            if not (isinstance(arg, ast.Constant) and arg.value is None):
                return True
        for kw in node.keywords:
            if kw.arg == "data" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is None):
                return True
            if kw.arg == "method":
                v = kw.value
                if not (isinstance(v, ast.Constant)
                        and isinstance(v.value, str)
                        and v.value.upper() in ("GET", "HEAD")):
                    return True
        return False

    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) \
                else ([node.module] if node.module else [])
            for m in names:
                if m.split(".")[0] in _RPC_BANNED_IMPORTS:
                    errors.append(
                        f"{fname}:{node.lineno}: raw transport import "
                        f"({m}) in a serve module — replica submissions "
                        "ride the serve/rpc.py data plane (RpcClient)")
            continue
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        chain = _dotted_chain(f)
        is_urlopen = (
            (isinstance(f, ast.Name) and f.id in urlopen_names)
            or (chain is not None
                and any(chain == m + ".urlopen" for m in mods)))
        is_request = (
            (isinstance(f, ast.Name) and f.id in request_names)
            or (chain is not None
                and any(chain == m + ".Request" for m in mods)))
        if (is_urlopen or is_request) and _carries_body(node, 1):
            shown = chain or (f.id if isinstance(f, ast.Name) else "...")
            errors.append(
                f"{fname}:{node.lineno}: body-carrying urllib submission "
                f"({shown}(...)) in a serve module — requests go to "
                "replicas through the serve/rpc.py data plane "
                "(RpcClient); GET scrapes are the only legal urllib use")
    return errors


# --- control axis rule (serve/scaler.py) ------------------------------------
# The scaler reads fleet state only through obs.signals() and acts only
# through the ReplicaGroup verbs, so its journaled input vector is its
# whole view of the fleet.

_SCALER_RULE_FILE = f"{PKG_DIR}/serve/scaler.py"
_SCALER_OBS_ALLOWED = {"signals", "record_decision", "count", "gauge"}
_SCALER_GROUP_VERBS = {"spawn_replica", "retire", "restart", "drain",
                       "kill", "alive", "live_replicas"}
_SCALER_BANNED_IMPORTS = {"urllib", "http", "socket", "requests"}


def scaler_control_errors(tree, fname) -> list:
    """The control-axis rule on a parsed module."""
    errors = []
    obs_names = _serve_aliases(tree)[5]
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names] \
                if isinstance(node, ast.Import) \
                else ([node.module] if node.module else [])
            for m in mods:
                if m.split(".")[0] in _SCALER_BANNED_IMPORTS:
                    errors.append(
                        f"{fname}:{node.lineno}: scrape machinery import "
                        f"({m}) in the scaler — the control loop reads "
                        "fleet state only through obs.signals()")
            continue
        if isinstance(node, ast.Attribute) and node.attr == "server":
            errors.append(
                f"{fname}:{node.lineno}: direct Server access (.server) "
                "in the scaler — act only through the ReplicaGroup verbs")
            continue
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not isinstance(f, ast.Attribute):
            continue
        chain = _dotted_chain(f)
        if f.attr == "parse_prometheus":
            errors.append(
                f"{fname}:{node.lineno}: scrape parsing "
                f"({chain or '...'}(...)) in the scaler — read "
                "obs.signals() instead")
        elif f.attr == "submit":
            errors.append(
                f"{fname}:{node.lineno}: request submission "
                f"({chain or '...'}(...)) in the scaler — the control "
                "loop never dispatches work")
        elif isinstance(f.value, ast.Name) \
                and f.value.id in obs_names \
                and f.attr not in _SCALER_OBS_ALLOWED:
            errors.append(
                f"{fname}:{node.lineno}: obs read outside the "
                f"control-axis surface ({f.value.id}.{f.attr}(...)) — "
                "the scaler may call only obs.signals / record_decision "
                "/ count / gauge")
        elif chain is not None and chain.startswith("self.group.") \
                and chain.count(".") == 2 \
                and f.attr not in _SCALER_GROUP_VERBS:
            errors.append(
                f"{fname}:{node.lineno}: unapproved group call "
                f"({chain}(...)) in the scaler — actions go through the "
                "ReplicaGroup verb set "
                f"({', '.join(sorted(_SCALER_GROUP_VERBS))})")
    return errors


# --- fleet funnel rule (serve/) ---------------------------------------------
# ReplicaGroup._collect_fleet_sample is the one place serve code reads
# cross-replica metrics; parse_prometheus and obs.snapshot /
# to_prometheus / fleet_series elsewhere fork the fleet's view.

_FLEET_FUNNEL = "_collect_fleet_sample"
_FLEET_READ_HELPERS = {"snapshot", "to_prometheus", "fleet_series"}
_OBS_EXPORT_MOD = f"{PKG}.obs.export"


def _export_parse_aliases(tree) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) \
                and node.module == _OBS_EXPORT_MOD:
            for a in node.names:
                if a.name == "parse_prometheus":
                    names.add(a.asname or a.name)
    return names


def fleet_funnel_errors(tree, fname) -> list:
    """The fleet-funnel rule on a parsed module."""
    errors = []
    obs_names = _serve_aliases(tree)[5]
    parse_names = _export_parse_aliases(tree)
    funnel_nodes: set = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == _FLEET_FUNNEL:
            funnel_nodes.update(id(w) for w in ast.walk(node))

    def _flag(node, what):
        errors.append(
            f"{fname}:{node.lineno}: cross-replica metrics read ({what}) "
            f"outside the {_FLEET_FUNNEL} funnel — serve-layer code "
            "reads fleet state through the collector/obs.signals() "
            "contract")

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or id(node) in funnel_nodes:
            continue
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr == "parse_prometheus":
                _flag(node, f"{_dotted_chain(f) or '...'}(...)")
            elif (f.attr in _FLEET_READ_HELPERS
                    and isinstance(f.value, ast.Name)
                    and f.value.id in obs_names):
                _flag(node, f"{f.value.id}.{f.attr}(...)")
        elif isinstance(f, ast.Name) and f.id in parse_names:
            _flag(node, f"{f.id}(...)")
    return errors


# --- journal funnel rule (serve/, runtime/, pipeline/) ----------------------
# obs/journal.py is the one journal writer: a raw open() on a
# journal-derived path or a hand-minted JournalWriter forks the history.

_JOURNAL_MOD = f"{PKG}.obs.journal"
_JOURNAL_DIR_ENV = "VELES_SIMD_JOURNAL_DIR"
_RUNTIME_RULE_DIR = f"{PKG_DIR}/runtime"
_OPEN_CHAINS = {"io.open", "os.open", "os.fdopen"}


def _journal_aliases(tree) -> tuple:
    mod_names, dir_fns, writer_names = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == f"{PKG}.obs":
                for a in node.names:
                    if a.name == "journal":
                        mod_names.add(a.asname or a.name)
            elif node.module == _JOURNAL_MOD:
                for a in node.names:
                    if a.name == "journal_dir":
                        dir_fns.add(a.asname or a.name)
                    elif a.name == "JournalWriter":
                        writer_names.add(a.asname or a.name)
    return mod_names, dir_fns, writer_names


def journal_funnel_errors(tree, fname) -> list:
    """The journal-funnel rule on a parsed module."""
    errors = []
    mod_names, dir_fns, writer_names = _journal_aliases(tree)
    tainted: set = set()

    def _derived(node) -> bool:
        for w in ast.walk(node):
            if isinstance(w, ast.Name) and w.id in tainted:
                return True
            if isinstance(w, ast.Constant) and isinstance(w.value, str):
                low = w.value.lower()
                if _JOURNAL_DIR_ENV in w.value or \
                        ("journal" in low and ".jsonl" in low):
                    return True
            if isinstance(w, ast.Call):
                f = w.func
                if isinstance(f, ast.Name) and f.id in dir_fns:
                    return True
                if isinstance(f, ast.Attribute) \
                        and f.attr == "journal_dir" \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id in mod_names:
                    return True
        return False

    changed = True
    while changed:
        changed = False
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or \
                    not _derived(node.value):
                continue
            for tgt in node.targets:
                for t in ast.walk(tgt):
                    if isinstance(t, ast.Name) and t.id not in tainted:
                        tainted.add(t.id)
                        changed = True

    writer_msg = ("JournalWriter minted outside the obs.journal facade — "
                  "one process gets ONE journal writer; arm it via "
                  "obs.configure(journal_dir=...) / "
                  "$VELES_SIMD_JOURNAL_DIR")
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (isinstance(f, ast.Name) and f.id in writer_names) or (
                isinstance(f, ast.Attribute) and f.attr == "JournalWriter"
                and isinstance(f.value, ast.Name)
                and f.value.id in mod_names):
            errors.append(f"{fname}:{node.lineno}: {writer_msg}")
            continue
        is_open = (isinstance(f, ast.Name) and f.id == "open") \
            or (_dotted_chain(f) in _OPEN_CHAINS) \
            or (isinstance(f, ast.Attribute) and f.attr == "open")
        if not is_open:
            continue
        receiver_derived = isinstance(f, ast.Attribute) \
            and _derived(f.value)
        if receiver_derived or any(_derived(a) for a in node.args) \
                or any(_derived(kw.value) for kw in node.keywords):
            errors.append(
                f"{fname}:{node.lineno}: raw open() on a journal path — "
                "journal writes funnel through the obs.journal facade, "
                "reads through journal.read_pack / "
                "tools/obs_query_torch.py")
    return errors


# --- sharded-dispatch rule (parallel/ops.py) --------------------------------
# Invoking an obs.instrumented_jit sharded program outside a
# faults.guarded region (arguments of faults.guarded/breaker_guarded or
# of a module-level wrapper that reaches one, transitively) is a
# dispatch that cannot retry, degrade or trip a breaker.

_PARALLEL_GUARD_FILES = (f"{PKG_DIR}/parallel/ops.py",)
_GUARD_ENTRY_POINTS = {"guarded", "breaker_guarded"}


def _faults_aliases(tree) -> tuple:
    """``(faults_module_aliases, guarded_fn_names)``."""
    mods, guarded_names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == f"{PKG}.runtime":
                for a in node.names:
                    if a.name == "faults":
                        mods.add(a.asname or a.name)
            elif node.module == f"{PKG}.runtime.faults":
                for a in node.names:
                    if a.name in _GUARD_ENTRY_POINTS:
                        guarded_names.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == f"{PKG}.runtime.faults" and a.asname:
                    mods.add(a.asname)
    return mods, guarded_names


def _guard_call_test(tree):
    faults_mods, guarded_names = _faults_aliases(tree)

    def _is_guarded_call(node) -> bool:
        f = node.func
        return ((isinstance(f, ast.Attribute)
                 and f.attr in _GUARD_ENTRY_POINTS
                 and isinstance(f.value, ast.Name)
                 and f.value.id in faults_mods)
                or (isinstance(f, ast.Name) and f.id in guarded_names))
    return _is_guarded_call


def parallel_guard_errors(tree, fname) -> list:
    """The sharded-dispatch rule on a parsed module."""
    errors = []
    is_guarded_call = _guard_call_test(tree)
    funcs = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs.setdefault(node.name, node)

    guard_wrappers: set = set()
    changed = True
    while changed:
        changed = False
        for name, fn in funcs.items():
            if name in guard_wrappers:
                continue
            for w in ast.walk(fn):
                if isinstance(w, ast.Call) and (
                        is_guarded_call(w)
                        or (isinstance(w.func, ast.Name)
                            and w.func.id in guard_wrappers)):
                    guard_wrappers.add(name)
                    changed = True
                    break

    inside: set = set()
    guarded_fns: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if not (is_guarded_call(node)
                or (isinstance(node.func, ast.Name)
                    and node.func.id in guard_wrappers)):
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for w in ast.walk(arg):
                inside.add(id(w))
                if isinstance(w, ast.Name) and w.id in funcs:
                    guarded_fns.add(w.id)
    changed = True
    while changed:
        changed = False
        for name in list(guarded_fns):
            for w in ast.walk(funcs[name]):
                inside.add(id(w))
                if (isinstance(w, ast.Name) and w.id in funcs
                        and w.id not in guarded_fns):
                    guarded_fns.add(w.id)
                    changed = True

    factories = {
        name for name, fn in funcs.items()
        if any(isinstance(w, ast.Attribute)
               and w.attr == "instrumented_jit" for w in ast.walk(fn))}

    def _is_factory_call(call) -> bool:
        f = call.func
        if isinstance(f, ast.Name) and f.id in factories:
            return True
        return isinstance(f, ast.Attribute) and f.attr == "instrumented_jit"

    handles = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and _is_factory_call(node.value)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    handles.add(t.id)

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        is_dispatch = (
            (isinstance(f, ast.Call) and _is_factory_call(f))
            or (isinstance(f, ast.Name) and f.id in handles))
        if is_dispatch and id(node) not in inside:
            errors.append(
                f"{fname}:{node.lineno}: sharded dispatch outside a "
                "faults.guarded thunk — instrumented sharded programs "
                "must dispatch through the fault policy (retry / "
                "single-card degrade / breaker gate)")
    return errors


# --- segment-packing rule (ops/segments.py) ---------------------------------
# Every packed_* entry point dispatches through faults.breaker_guarded
# and consults the segments routing-family table (directly or through
# module-level helpers).

_SEGMENT_RULE_FILES = (f"{PKG_DIR}/ops/segments.py",)
_SEGMENT_ENTRY_PREFIX = "packed_"


def segment_dispatch_errors(tree, fname) -> list:
    """The segment-packing rule on a parsed module."""
    errors = []
    faults_mods, guarded_names = _faults_aliases(tree)
    routing_mods, family_fns = _routing_aliases(tree)
    tables = _family_table_names(tree, routing_mods, family_fns)
    table_names = tables | family_fns
    funcs = {node.name: node for node in tree.body
             if isinstance(node, ast.FunctionDef)}

    def _is_breaker_call(node) -> bool:
        f = node.func
        return ((isinstance(f, ast.Attribute)
                 and f.attr == "breaker_guarded"
                 and isinstance(f.value, ast.Name)
                 and f.value.id in faults_mods)
                or (isinstance(f, ast.Name) and f.id in guarded_names
                    and f.id.endswith("breaker_guarded")))

    def _reaches(fn, hit, seen=None) -> bool:
        seen = set() if seen is None else seen
        if fn.name in seen:
            return False
        seen.add(fn.name)
        for w in ast.walk(fn):
            if hit(w):
                return True
            if (isinstance(w, ast.Name) and w.id in funcs
                    and w.id not in seen
                    and _reaches(funcs[w.id], hit, seen)):
                return True
        return False

    def _consults_table(w) -> bool:
        if isinstance(w, ast.Name) and w.id in table_names:
            return True
        return (isinstance(w, ast.Attribute)
                and isinstance(w.value, ast.Name)
                and w.value.id in routing_mods
                and w.attr in ("family", "get_family"))

    for node in tree.body:
        if not (isinstance(node, ast.FunctionDef)
                and node.name.startswith(_SEGMENT_ENTRY_PREFIX)):
            continue
        if not _reaches(node, lambda w: isinstance(w, ast.Call)
                        and _is_breaker_call(w)):
            errors.append(
                f"{fname}:{node.lineno}: packed entry point {node.name} "
                "does not dispatch through faults.breaker_guarded — a "
                "segment-masked dispatch fans one fault across every "
                "co-packed ticket")
        if not _reaches(node, _consults_table):
            errors.append(
                f"{fname}:{node.lineno}: packed entry point {node.name} "
                "does not consult the segments routing-family table — "
                "packing geometry is a route property")
    return errors


# --- pipeline rule (pipeline/) ----------------------------------------------
# Stage kernel resolution goes through a routing.family-bound selector,
# and the compiled step (an obs.instrumented_jit handle, and the port's
# CUDA-graph step) runs only inside a faults.guarded/breaker_guarded
# region.

_PIPELINE_RULE_DIR = f"{PKG_DIR}/pipeline"
# the port's graph step: its class, the method that replays it, and a
# captured graph's replay
_GRAPH_STEP_CLASS = "_GraphStep"
_GRAPH_STEP_METHODS = {"run"}
_GRAPH_REPLAY = "replay"


def _ops_module_aliases(tree) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == f"{PKG}.ops":
                for a in node.names:
                    names.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(f"{PKG}.ops.") and a.asname:
                    names.add(a.asname)
    return names


def pipeline_route_errors(tree, fname) -> list:
    """The stage-resolution half of the pipeline rule."""
    errors = []
    ops_mods = _ops_module_aliases(tree)
    modules, family_fns = _routing_aliases(tree)
    families = _family_table_names(tree, modules, family_fns)
    table_names = family_fns | families

    def resolves_via_engine(fn) -> bool:
        for n in ast.walk(fn):
            if isinstance(n, ast.Call):
                f = n.func
                if (isinstance(f, ast.Attribute)
                        and f.attr.startswith("select_")
                        and isinstance(f.value, ast.Name)
                        and f.value.id in ops_mods):
                    return True
                if (isinstance(f, ast.Attribute)
                        and f.attr in ("family", "get_family")
                        and isinstance(f.value, ast.Name)
                        and f.value.id in modules):
                    return True
            if isinstance(n, ast.Name) and n.id in table_names:
                return True
        return False

    def trivial(fn) -> bool:
        body = [n for n in fn.body
                if not isinstance(n, ast.Expr)
                or not isinstance(n.value, ast.Constant)]
        return all(isinstance(n, ast.Return)
                   and (n.value is None
                        or isinstance(n.value, ast.Constant))
                   for n in body)

    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef) or node.name != "resolve":
            continue
        if trivial(node) or resolves_via_engine(node):
            continue
        errors.append(
            f"{fname}:{node.lineno}: pipeline stage resolve() picks a "
            "kernel without consulting the routing engine — stage "
            "dispatch must go through a routing.family-bound selector "
            "(an ops select_* hook or routing.family/get_family)")
    return errors


def pipeline_guard_errors(tree, fname) -> list:
    """The guarded-step half of the pipeline rule: a call of an
    instrumented handle, the construction of a graph step, its
    ``run`` and a graph's ``replay()`` must lie in a guarded region —
    the arguments of a guard call, and the bodies of the functions and
    methods they reference, transitively, including the functions an
    instrumented handle wraps."""
    errors = []
    is_guarded_call = _guard_call_test(tree)
    funcs = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs.setdefault(node.name, node)

    # handles: names/attributes assigned from expressions that reach an
    # obs.instrumented_jit call, with the functions each one wraps
    handles: dict = {}
    graph_handles: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        reaches = any(isinstance(w, ast.Attribute)
                      and w.attr == "instrumented_jit"
                      for w in ast.walk(value))
        is_graph = any(isinstance(w, ast.Call)
                       and isinstance(w.func, ast.Name)
                       and w.func.id == _GRAPH_STEP_CLASS
                       for w in ast.walk(value))
        if not (reaches or is_graph):
            continue
        wrapped = {w.id for w in ast.walk(value)
                   if isinstance(w, ast.Name) and w.id in funcs} | {
            w.attr for w in ast.walk(value)
            if isinstance(w, ast.Attribute) and w.attr in funcs}
        for t in node.targets:
            name = t.id if isinstance(t, ast.Name) else (
                t.attr if isinstance(t, ast.Attribute) else None)
            if name is None:
                continue
            if reaches:
                handles.setdefault(name, set()).update(wrapped)
            if is_graph:
                graph_handles.add(name)

    inside: set = set()
    guarded_fns: set = set()

    def _mark(subtree):
        for w in ast.walk(subtree):
            inside.add(id(w))
            ref = (w.id if isinstance(w, ast.Name) else
                   w.attr if isinstance(w, ast.Attribute) else None)
            if ref is None:
                continue
            if ref in funcs:
                guarded_fns.add(ref)
            if ref in handles:
                guarded_fns.update(handles[ref])

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and is_guarded_call(node):
            for arg in list(node.args) + [kw.value
                                          for kw in node.keywords]:
                _mark(arg)
    seen: set = set()
    while guarded_fns - seen:
        for name in list(guarded_fns - seen):
            seen.add(name)
            _mark(funcs[name])

    def _dispatch_kind(call):
        f = call.func
        if isinstance(f, ast.Name) and f.id in handles:
            return "compiled pipeline step"
        if isinstance(f, ast.Attribute) and f.attr in handles:
            return "compiled pipeline step"
        if isinstance(f, ast.Name) and f.id == _GRAPH_STEP_CLASS:
            return "graph-step capture"
        if isinstance(f, ast.Attribute):
            if f.attr == _GRAPH_REPLAY and not call.args:
                return "CUDA-graph replay"
            recv = f.value
            recv_name = (recv.id if isinstance(recv, ast.Name) else
                         recv.attr if isinstance(recv, ast.Attribute)
                         else None)
            if f.attr in _GRAPH_STEP_METHODS and \
                    recv_name in graph_handles:
                return "graph-step replay"
        return None

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        kind = _dispatch_kind(node)
        if kind and id(node) not in inside:
            errors.append(
                f"{fname}:{node.lineno}: {kind} outside a "
                "faults.guarded/breaker_guarded region — the fused step "
                "must dispatch through the fault policy (retry / "
                "oracle-twin degrade / per-pipeline-class breaker)")
    return errors


# --- the rule dispatch -------------------------------------------------------

def module_errors(tree, rel) -> list:
    """Every project rule that applies to the package module ``rel``
    (repo-relative), on its parsed tree."""
    errors = []
    in_serve = rel.startswith(_SERVE_RULE_DIR + "/")
    in_pipeline = rel.startswith(_PIPELINE_RULE_DIR + "/")
    in_runtime = rel.startswith(_RUNTIME_RULE_DIR + "/")
    in_compute = rel.startswith(tuple(d + "/" for d in _OBS_RULE_DIRS))
    # package-wide: compile sites and precision switches
    errors += compile_site_errors(tree, rel)
    errors += precision_errors(tree, rel)
    if in_serve or in_pipeline or in_runtime:
        errors += journal_funnel_errors(tree, rel)
    if in_serve:
        # the serving layer's own contract, instead of the compute
        # rules
        errors += serve_layer_errors(tree, rel)
        errors += request_trace_errors(tree, rel)
        errors += fleet_funnel_errors(tree, rel)
        if rel != _RPC_RULE_FILE:
            errors += rpc_transport_errors(tree, rel)
        if rel == _CLUSTER_RULE_FILE:
            errors += cluster_router_errors(tree, rel)
        if rel == _SCALER_RULE_FILE:
            errors += scaler_control_errors(tree, rel)
        errors += artifact_serialization_errors(tree, rel)
        return errors
    if not (in_compute or in_pipeline):
        return errors
    if in_pipeline:
        errors += pipeline_route_errors(tree, rel)
        errors += pipeline_guard_errors(tree, rel)
        errors += request_trace_errors(tree, rel)
    if rel in _DISPATCH_RULE_FILES:
        errors += spectral_dispatch_errors(tree, rel)
    if rel in _PARALLEL_GUARD_FILES:
        errors += parallel_guard_errors(tree, rel)
    if rel in _SEGMENT_RULE_FILES:
        errors += segment_dispatch_errors(tree, rel)
    errors += fault_handler_errors(tree, rel)
    errors += routing_selector_errors(tree, rel)
    errors += artifact_serialization_errors(tree, rel)
    errors += telemetry_errors(tree, rel)
    return errors


def project_errors(files) -> list:
    """The project rules over the files that lie in the port's
    package."""
    errors = []
    for f in files:
        rel = _rel(f)
        if not rel.startswith(PKG_DIR + "/"):
            continue
        try:
            tree = ast.parse(Path(f).read_text(), str(f))
        except SyntaxError as e:
            errors.append(f"{rel}:{e.lineno}: syntax error: {e.msg}")
            continue
        errors += module_errors(tree, rel)
    return errors


def lint(paths=None) -> list:
    """Both passes over ``paths`` (default: the port's sources);
    returns the error lines."""
    files = sorted(set(python_sources(paths)))
    errors = []
    for f in files:
        errors += base_errors(f)
    return errors + project_errors(files)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    files = sorted(set(python_sources(argv)))
    errors = lint(argv)
    for e in errors:
        print(e)
    print(f"lint_torch: {len(files)} files, {len(errors)} errors")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
