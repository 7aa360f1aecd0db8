"""Generate markdown API documentation for the nmpc_tpu package.

This repository's equivalent of the reference's per-package Doxygen build
(``/root/reference/nmpc_ddp/doc/CMakeLists.txt:1-11`` and the Doxygen +
gh-pages upload in ``.github/workflows/ci-colcon.yaml:63-94``): walks every
module in ``nmpc_tpu``, extracts docstrings and signatures with the stdlib
``inspect`` machinery, and writes one markdown page per module plus an
index to ``docs/api/``.  Pure stdlib — no doc-tool dependency — and
deterministic, so the output is diffable and CI can verify it builds.

Usage:  python tools/gen_api_docs.py [output_dir]
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import pkgutil
import sys
from pathlib import Path

_REPO = str(Path(__file__).resolve().parents[1])
if _REPO not in sys.path:  # allow running without an installed package
    sys.path.insert(0, _REPO)


def _anchor(title: str) -> str:
    return title.lower().replace(" ", "-").replace(".", "").replace("_", "-")


def _clean_doc(obj) -> str:
    doc = inspect.getdoc(obj)
    return doc.strip() if doc else ""


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _defined_here(obj, module) -> bool:
    return getattr(obj, "__module__", None) == module.__name__


def _doc_function(name: str, fn, lines: list[str], heading: str = "###"):
    lines.append(f"{heading} `{name}{_signature(fn)}`")
    lines.append("")
    doc = _clean_doc(fn)
    if doc:
        lines.append(doc)
        lines.append("")


def _doc_class(name: str, cls, lines: list[str]):
    bases = ", ".join(b.__name__ for b in cls.__bases__
                      if b.__name__ not in ("object",))
    suffix = f" ({bases})" if bases else ""
    lines.append(f"### class `{name}`{suffix}")
    lines.append("")
    doc = _clean_doc(cls)
    if doc:
        lines.append(doc)
        lines.append("")

    if dataclasses.is_dataclass(cls):
        lines.append("| field | type | default |")
        lines.append("|---|---|---|")
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                default = repr(f.default)
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore
                default = f"{getattr(f.default_factory, '__name__', '...')}()"
            else:
                default = "(required)"
            tname = getattr(f.type, "__name__", None) or str(f.type)
            lines.append(f"| `{f.name}` | `{tname}` | `{default}` |")
        lines.append("")

    # NamedTuple fields
    if hasattr(cls, "_fields") and not dataclasses.is_dataclass(cls):
        lines.append("Fields: " + ", ".join(f"`{f}`" for f in cls._fields))
        lines.append("")

    for mname, meth in sorted(vars(cls).items()):
        if not _is_public(mname) or mname in ("index", "count"):
            continue
        if isinstance(meth, (staticmethod, classmethod)):
            meth = meth.__func__
        if inspect.isfunction(meth):
            mdoc = _clean_doc(meth)
            lines.append(f"#### `{name}.{mname}{_signature(meth)}`")
            lines.append("")
            if mdoc:
                lines.append(mdoc)
                lines.append("")


def document_module(module) -> str:
    lines = [f"# `{module.__name__}`", ""]
    doc = _clean_doc(module)
    if doc:
        lines.append(doc)
        lines.append("")

    classes, functions = [], []
    public = getattr(module, "__all__", None)
    for name, obj in sorted(vars(module).items()):
        if not _is_public(name):
            continue
        if public is not None and name not in public:
            continue
        if inspect.isclass(obj) and _defined_here(obj, module):
            classes.append((name, obj))
        elif (inspect.isfunction(obj) and _defined_here(obj, module)):
            functions.append((name, obj))

    if classes:
        lines.append("## Classes")
        lines.append("")
        for name, cls in classes:
            _doc_class(name, cls, lines)
    if functions:
        lines.append("## Functions")
        lines.append("")
        for name, fn in functions:
            _doc_function(name, fn, lines)
    return "\n".join(lines) + "\n"


def iter_modules(package_name: str = "nmpc_tpu"):
    pkg = importlib.import_module(package_name)
    yield pkg
    for info in pkgutil.walk_packages(pkg.__path__, prefix=package_name + "."):
        if ".src" in info.name:
            continue
        spec = info.module_finder.find_spec(info.name)  # type: ignore[union-attr]
        if spec is None or not (spec.origin or "").endswith(".py"):
            continue  # compiled extensions (e.g. the runtime .so)
        try:
            yield importlib.import_module(info.name)
        except Exception as exc:  # pragma: no cover - import-env specific
            print(f"skip {info.name}: {exc}", file=sys.stderr)


def generate(out_dir: str | Path = "docs/api",
             package_name: str = "nmpc_tpu") -> list[Path]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    index = ["# nmpc_tpu API reference", "",
             "Generated by `tools/gen_api_docs.py` (stdlib-only; this",
             "repository's analog of the reference's Doxygen build).", "",
             "| module | summary |", "|---|---|"]
    for module in iter_modules(package_name):
        page = document_module(module)
        fname = module.__name__.replace(".", "_") + ".md"
        path = out / fname
        path.write_text(page)
        written.append(path)
        doc = _clean_doc(module)
        summary = doc.splitlines()[0] if doc else ""
        index.append(f"| [`{module.__name__}`]({fname}) | {summary} |")
    index_path = out / "index.md"
    index_path.write_text("\n".join(index) + "\n")
    written.append(index_path)
    return written


if __name__ == "__main__":
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "docs/api"
    files = generate(out_dir)
    print(f"wrote {len(files)} pages to {out_dir}")
