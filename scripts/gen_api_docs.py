#!/usr/bin/env python
"""Generate markdown API documentation for hemx into doc/api/.

The reference ships generated API docs (doc/api/*.html, one page per
module); hemx's equivalent is one markdown page per module, generated by
introspection so signatures never drift from the code. Regenerate with:

    python scripts/gen_api_docs.py

CLI flags/entry points are documented in doc/guide.md; this covers the
importable surface.
"""

from __future__ import annotations

import importlib
import inspect
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Force CPU so importing hemx (which imports jax) never opens the GPU —
# doc generation must be runnable while a training job owns the card.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "hemx",
    "hemx.core",
    "hemx.config",
    "hemx.ops.layers",
    "hemx.ops.activations",
    "hemx.ops.losses",
    "hemx.ops.images",
    "hemx.ops.initializers",
    "hemx.ops.normalize",
    "hemx.data.plugin",
    "hemx.data.pipeline",
    "hemx.data.tfrecord",
    "hemx.data.imageio",
    "hemx.models.plugin",
    "hemx.models.common",
    "hemx.models.conditional",
    "hemx.models.networks",
    "hemx.parallel.mesh",
    "hemx.parallel.dp",
    "hemx.train.loop",
    "hemx.train.checkpoint",
    "hemx.train.optimizers",
    "hemx.summaries.events",
    "hemx.summaries.reader",
    "hemx.summaries.montage",
    "hemx.summaries.proto",
    "hemx.metrics.eigen",
    "hemx.metrics.fid",
    "hemx.utils.misc",
    "hemx.utils.terminal",
]


def _anchor(mod_name: str) -> str:
    return mod_name.replace(".", "_") + ".md"


def _signature(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # Default values repr'd as <function f at 0x...> / <class 'x.Y'> make
    # regeneration nondeterministic; reduce them to their names.
    sig = re.sub(r"<function ([\w.<>]+|<lambda>) at 0x[0-9a-f]+>", r"\1", sig)
    sig = re.sub(r"<class '([\w.]+)'>", r"\1", sig)
    sig = re.sub(r"<PjitFunction of ([\w.]+)>", r"\1", sig)
    sig = re.sub(r"<[\w.]+ object at 0x[0-9a-f]+>", "...", sig)
    return sig


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d if d else ""


def _first_line(text: str) -> str:
    return text.split("\n", 1)[0].strip() if text else ""


def _public_members(mod):
    """Functions and classes defined in (not imported into) the module —
    except for the `hemx` facade, where re-exports ARE the public API."""
    is_facade = mod.__name__ == "hemx"
    fns, classes = [], []
    for name in sorted(vars(mod)):
        if name.startswith("_"):
            continue
        obj = vars(mod)[name]
        home = getattr(obj, "__module__", None)
        if not is_facade and home != mod.__name__:
            continue
        if is_facade and (home is None or not str(home).startswith("hemx")):
            continue
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif inspect.isfunction(obj):
            fns.append((name, obj))
    return fns, classes


def _render_function(name: str, fn, level: str = "###") -> list[str]:
    out = [f"{level} `{name}{_signature(fn)}`", ""]
    doc = _doc(fn)
    if doc:
        out += [doc, ""]
    return out


def _render_class(name: str, cls) -> list[str]:
    out = [f"### class `{name}`", ""]
    doc = _doc(cls)
    if doc:
        out += [doc, ""]
    for mname, member in sorted(vars(cls).items()):
        if mname.startswith("_") and mname != "__init__":
            continue
        raw = member
        if isinstance(member, (staticmethod, classmethod)):
            raw = member.__func__
        if not inspect.isfunction(raw):
            continue
        mdoc = _doc(raw)
        # Skip boilerplate-free trivial methods to keep pages readable;
        # __init__ is always shown when it has a custom signature.
        if mname == "__init__" and _signature(raw) == "(self)":
            continue
        out += [f"#### `{name}.{mname}{_signature(raw)}`", ""]
        if mdoc:
            out += [mdoc, ""]
    return out


def render_module(mod_name: str) -> tuple[str, str]:
    mod = importlib.import_module(mod_name)
    lines = [f"# `{mod_name}`", ""]
    mdoc = _doc(mod)
    if mdoc:
        lines += [mdoc, ""]
    fns, classes = _public_members(mod)
    if mod_name == "hemx":
        lines += ["## Re-exported API", "",
                  "| symbol | defined in | summary |", "|---|---|---|"]
        for name, obj in fns + classes:
            home = getattr(obj, "__module__", "?")
            link = _anchor(home) if home in MODULES else None
            target = f"[`{home}`]({link})" if link else f"`{home}`"
            lines.append(
                f"| `{name}` | {target} | {_first_line(_doc(obj))} |")
        lines.append("")
        return _anchor(mod_name), "\n".join(lines) + "\n"
    if classes:
        lines += ["## Classes", ""]
        for name, cls in classes:
            lines += _render_class(name, cls)
    if fns:
        lines += ["## Functions", ""]
        for name, fn in fns:
            lines += _render_function(name, fn)
    return _anchor(mod_name), "\n".join(lines) + "\n"


def main() -> int:
    out_dir = os.path.join(os.path.dirname(__file__), "..", "doc", "api")
    os.makedirs(out_dir, exist_ok=True)
    index = ["# hemx API reference", "",
             "Generated by `scripts/gen_api_docs.py` — regenerate after "
             "changing any public signature or docstring.", "",
             "| module | summary |", "|---|---|"]
    for mod_name in MODULES:
        fname, text = render_module(mod_name)
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(text)
        mod = importlib.import_module(mod_name)
        index.append(f"| [`{mod_name}`]({fname}) | "
                     f"{_first_line(_doc(mod))} |")
        print(f"wrote doc/api/{fname}")
    with open(os.path.join(out_dir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote doc/api/index.md")
    return 0


if __name__ == "__main__":
    sys.exit(main())
