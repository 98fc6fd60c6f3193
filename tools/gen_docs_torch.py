#!/usr/bin/env python3
"""API reference generator of the port: ``docs/torch/``.

The twin of ``tools/gen_docs.py`` over the PyTorch/CUDA port
(``veles.simd_tpu_torch``).  It writes one markdown page for each of the
port's public modules (the JAX generator's ``MODULES`` mapped to the
port, ``ops.cuda_kernels`` in place of ``ops.pallas_kernels``, the
``tools.*_torch`` twins, and the port's own ``utils.devtrace`` and
``cabi``) under ``docs/torch/``, plus an index ``docs/torch/README.md``,
from signatures and docstrings via ``inspect`` (the JAX generator's
helpers, imported: that tool loads nothing of JAX).

A page shows only what the port's modules define or re-export: a
class's methods are the ones in its own ``__dict__``, so an inherited
member (``int.from_bytes`` of an ``IntEnum``, which Python 3.12 lists
with the subclass's name) never appears, and a page does not move with
the interpreter.  Object addresses are stripped from reprs and
signatures, as the JAX generator does.  Rendering needs no
card: the modules are imported with ``VELES_SIMD_PLATFORM=cpu`` (the C
shim reads it at import), and the caller's setting and ``Config`` are
restored afterwards.  ``tests/test_torch_docs.py`` holds the committed
pages to a regeneration, byte for byte.

Run:  python3 tools/gen_docs_torch.py        # regenerates docs/torch/
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import os
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import gen_docs  # noqa: E402

DOCS = REPO / "docs" / "torch"


def _port_name(modname: str) -> str:
    """The port's module for one of the JAX generator's modules."""
    if modname.startswith("tools."):
        return modname + "_torch"
    name = "veles.simd_tpu_torch" + modname[len("veles.simd_tpu"):]
    return name.replace(".ops.pallas_kernels", ".ops.cuda_kernels")


MODULES = [_port_name(m) for m in gen_docs.MODULES] + [
    # the port's own public modules, with no JAX twin
    "veles.simd_tpu_torch.utils.devtrace",
    "veles.simd_tpu_torch.cabi",
]


def page_name(modname: str) -> str:
    return modname.replace(".", "_") + ".md"


@contextlib.contextmanager
def cpu_import():
    """``VELES_SIMD_PLATFORM=cpu`` for the imports, then the caller's
    environment and ``Config`` back."""
    from veles.simd_tpu_torch.utils import config

    prev_env = os.environ.get("VELES_SIMD_PLATFORM")
    prev_cfg = config.get_config()
    os.environ["VELES_SIMD_PLATFORM"] = "cpu"
    try:
        yield
    finally:
        if prev_env is None:
            os.environ.pop("VELES_SIMD_PLATFORM", None)
        else:
            os.environ["VELES_SIMD_PLATFORM"] = prev_env
        config.set_config(**dataclasses.asdict(prev_cfg))


def _clean(text: str) -> str:
    """``text`` without per-process object addresses."""
    return re.sub(r" at 0x[0-9a-f]+", "", text)


def _own_methods(cls):
    """``(name, member)`` of the public callables ``cls`` itself
    defines (its own ``__dict__``), by name."""
    own = vars(cls)
    for mname, meth in inspect.getmembers(cls):
        if mname.startswith("_") or mname not in own or not callable(meth):
            continue
        yield mname, meth


def render_module(modname: str) -> str:
    """The page of ``modname`` (imported with the CPU platform)."""
    with cpu_import():
        mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", "", gen_docs._doc(mod), ""]
    classes, functions, constants = [], [], []
    for name, obj in gen_docs._public_members(mod):
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif callable(obj):
            functions.append((name, obj))
        else:
            constants.append((name, obj))

    if constants:
        lines += ["## Constants", ""]
        for name, obj in constants:
            rep = _clean(repr(obj))
            if len(rep) > 120:
                rep = rep[:117] + "..."
            lines += [f"- **`{name}`** = `{rep}`"]
        lines += [""]

    for name, cls in classes:
        lines += [f"## class `{name}`", "", gen_docs._doc(cls), ""]
        for mname, meth in _own_methods(cls):
            lines += [f"### `{name}.{mname}"
                      f"{_clean(gen_docs._signature(meth))}`", "",
                      gen_docs._doc(meth), ""]
        if hasattr(cls, "__members__"):
            members = ", ".join(f"`{m}`" for m in cls.__members__)
            lines += [f"Members: {members}", ""]

    for name, fn in functions:
        lines += [f"## `{name}{_clean(gen_docs._signature(fn))}`", "",
                  gen_docs._doc(fn), ""]
    return "\n".join(lines).rstrip() + "\n"


def render_index() -> str:
    index = ["# veles.simd_tpu_torch — API reference",
             "",
             "The PyTorch/CUDA port of `veles.simd_tpu`, one page a "
             "public module. Generated by `tools/gen_docs_torch.py`; "
             "`tests/test_torch_docs.py` holds these pages to a "
             "regeneration. The JAX package's pages are one directory "
             "up ([../README.md](../README.md)).",
             ""]
    for modname in MODULES:
        with cpu_import():
            mod = importlib.import_module(modname)
        first = (inspect.getdoc(mod) or "").split("\n", 1)[0]
        index.append(f"- [`{modname}`]({page_name(modname)}) — {first}")
    return "\n".join(index) + "\n"


def main(argv=None) -> int:
    DOCS.mkdir(parents=True, exist_ok=True)
    written = {"README.md"}
    for modname in MODULES:
        out = DOCS / page_name(modname)
        out.write_text(render_module(modname))
        written.add(out.name)
        print(f"wrote {out.relative_to(REPO)}")
    (DOCS / "README.md").write_text(render_index())
    print(f"wrote {(DOCS / 'README.md').relative_to(REPO)}")
    for stale in sorted(DOCS.glob("*.md")):
        if stale.name not in written:
            stale.unlink()
            print(f"pruned stale {stale.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
