#!/usr/bin/env python
"""Regenerate docs/elements_torch.md from the port's live element
registry: the counterpart of ``tools/gen_element_docs.py``.

The reference's analog surface is ``gst-inspect-1.0``; the port's is
``python -m nnstreamer_tpu_torch inspect <name>``. This script renders the
same registry data as markdown so the docs cannot drift from the code:

    python tools/gen_element_docs_torch.py            # rewrites the file
    python tools/gen_element_docs_torch.py --check    # exit 1 when stale
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "docs", "elements_torch.md")

EPILOGUE = """## Universal properties

Every element additionally accepts `config-file` — a path of
`key=value` lines applied as properties at set time (the reference's
`gst_tensor_parse_config_file`). It does not appear in the per-element
lists above because it is implemented once in the element base outside
the property registry. (`silent`, the other universal property, IS
listed per element.)

## Device placement

The port's device elements (`tensor_filter`, `tensor_transform`,
`tensor_generate`, `tensor_serving`, `tensor_trainer`, and `tensor_src
device=true`) run on the card (`cuda:0`) unless `accelerator=cpu` (or
`accelerator=cuda:N`) says otherwise; on a machine without a card they
post a bus ERROR naming the missing device.
"""


def render() -> str:
    from nnstreamer_tpu_torch.registry.elements import (
        element_factories,
        get_factory,
    )
    from nnstreamer_tpu_torch.runtime.element import merged_properties

    lines = [
        "# Element reference (nnstreamer_tpu_torch)",
        "",
        "Auto-generated from the port's element registry "
        "(`python tools/gen_element_docs_torch.py`; "
        "`python -m nnstreamer_tpu_torch inspect <name>` shows the same "
        "live). The JAX package's page is [elements.md](elements.md).",
        "",
        "Pipelines built from these elements can be validated *before* "
        "execution with the static linter — `python -m nnstreamer_tpu_torch "
        "lint \"<launch string>\"` cross-checks element names, "
        "properties, caps compatibility, and perf hazards against this "
        "registry; see [lint.md](lint.md) for the rule catalog.",
    ]
    for name in element_factories():
        cls = get_factory(name)
        lines += ["", f"## `{name}`", ""]
        doc = (cls.__doc__ or "").strip()
        if doc:
            # the first paragraph (up to a blank line): docstrings wrap
            # mid-sentence
            para = doc.split("\n\n")[0]
            lines += [" ".join(ln.strip() for ln in para.splitlines()), ""]
        sinks = ", ".join(f"`{t.name_template}`"
                          for t in cls.SINK_TEMPLATES) or "—"
        srcs = ", ".join(f"`{t.name_template}`"
                         for t in cls.SRC_TEMPLATES) or "—"
        lines.append(f"- sink pads: {sinks}; src pads: {srcs}")
        props = merged_properties(cls)
        if props:
            lines.append("- properties:")
            for key, prop in props.items():
                dash = key.replace("_", "-")
                doc_str = f" — {prop.doc}" if prop.doc else ""
                lines.append(f"  - `{dash}` (default `{prop.default!r}`)"
                             f"{doc_str}")
    lines += ["", EPILOGUE.rstrip()]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if the committed file differs from the "
                    "registry's rendering (writes nothing)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    text = render()
    n = text.count("\n## `")
    if args.check:
        try:
            with open(args.out) as fh:
                current = fh.read()
        except FileNotFoundError:
            current = None
        if current != text:
            print(f"{os.path.normpath(args.out)} is stale: run python "
                  "tools/gen_element_docs_torch.py")
            return 1
        print(f"{os.path.normpath(args.out)} is current ({n} elements)")
        return 0
    with open(args.out, "w") as fh:
        fh.write(text)
    print(f"wrote {os.path.normpath(args.out)} ({text.count(chr(10))} "
          f"lines, {n} elements)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
