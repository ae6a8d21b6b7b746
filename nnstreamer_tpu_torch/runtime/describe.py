"""Declarative (structured) pipeline descriptions ↔ launch text (L6).

Reference analog: ``tools/development/parser/`` — the flex/bison pbtxt ↔
gst-launch converter (grammar.y), i.e. a machine-readable pipeline format
that round-trips with the launch-text UX. Ours is JSON-native::

    {
      "name": "detect",
      "elements": [
        {"factory": "tensor_src", "name": "src",
         "props": {"num-buffers": 8, "dimensions": "3:224:224:1"}},
        {"factory": "tensor_filter", "name": "f",
         "props": {"framework": "torch", "model": "..."}},
        {"caps": "other/tensors,types=float32", "name": "cf"},
        {"factory": "tensor_sink", "name": "out"}
      ],
      "links": [["src", "f"], ["f", "cf"], ["cf", "out"]]
    }

Link endpoints are ``"element"`` or ``"element.pad"`` (request pads created
on demand, same as the launch DSL). ``caps`` entries are capsfilters; they
are inlined into the emitted launch text. With no explicit ``links``, the
elements form a linear chain in listed order.

API: :func:`pipeline_from_description`, :func:`description_to_launch`,
:func:`launch_to_description` (inverse), :func:`load_pipeline_file`.
"""
from __future__ import annotations

import json
import shlex
from typing import Dict

from .pipeline import Pipeline


def description_to_launch(desc: dict) -> str:
    """Structured description → launch string.

    Emission scheme: declare every element (with its name and props) as its
    own chain, then express each link as a ``src. ! dst.`` reference chain —
    valid launch syntax that survives arbitrary graph shapes (tees, muxes,
    multi-chain). Capsfilter entries cannot be name-referenced in launch
    text, so each one is inlined: ``src. ! <caps> ! dst.``.
    """
    elements = list(desc.get("elements", []))
    if not elements:
        raise ValueError("pipeline description has no elements")
    by_name: Dict[str, dict] = {}
    for i, e in enumerate(elements):
        if "factory" not in e and "caps" not in e:
            raise ValueError(f"element #{i} needs 'factory' or 'caps': {e}")
        name = e.get("name") or f"e{i}__auto"
        e = {**e, "name": name}
        elements[i] = e
        if name in by_name:
            raise ValueError(f"duplicate element name '{name}'")
        by_name[name] = e

    links = [tuple(ln) for ln in (desc.get("links") or [])]
    if not links and len(elements) > 1:
        names = [e["name"] for e in elements]
        links = list(zip(names, names[1:]))
    caps_names = {e["name"] for e in elements if "caps" in e}

    def decl(e: dict) -> str:
        parts = [e["factory"], f"name={e['name']}"]
        for k, v in (e.get("props") or {}).items():
            v = _prop_str(v)
            parts.append(f"{k}={shlex.quote(v) if _needs_quote(v) else v}")
        return " ".join(parts)

    def ref(endpoint: str) -> str:
        return endpoint if "." in endpoint else endpoint + "."

    chunks = [decl(e) for e in elements if e["name"] not in caps_names]
    consumed: set = set()
    for i, (s, d) in enumerate(links):
        if i in consumed:
            continue
        s_el, d_el = s.split(".")[0], d.split(".")[0]
        if s_el in caps_names:
            continue  # emitted by its upstream link below
        if s_el not in by_name or d_el not in by_name:
            missing = s_el if s_el not in by_name else d_el
            raise ValueError(f"link references unknown element '{missing}'")
        if d_el in caps_names:
            follow = next(
                (j for j, (s2, _) in enumerate(links)
                 if j not in consumed and s2.split(".")[0] == d_el), None)
            if follow is None:
                raise ValueError(f"capsfilter '{d_el}' has no outgoing link")
            consumed.add(follow)
            chunks.append(
                f"{ref(s)} ! {by_name[d_el]['caps']} ! {ref(links[follow][1])}")
        else:
            chunks.append(f"{ref(s)} ! {ref(d)}")
    return " ".join(chunks)


def launch_to_description(launch: str) -> dict:
    """Launch string → structured description (the parser tool's
    gst-launch → pbtxt direction)."""
    from .parse import parse_launch

    pipe = parse_launch(launch)
    desc: dict = {"elements": [], "links": []}
    for name, el in pipe.elements.items():
        if el.ELEMENT_NAME == "capsfilter":
            entry: dict = {"caps": str(el.filter_caps), "name": name}
        else:
            entry = {"factory": el.ELEMENT_NAME, "name": name}
            props = {}
            for k, v in el.props.items():
                # _prop_defs is the MRO-merged table (class PROPERTIES
                # dicts shadow, e.g. the universal `silent`)
                default = el._prop_defs[k].default if k in el._prop_defs else None
                if v != default:
                    props[k.replace("_", "-")] = v
            if props:
                entry["props"] = props
        desc["elements"].append(entry)
        for pad in el.src_pads:
            if pad.peer is not None:
                desc["links"].append(
                    [f"{name}.{pad.name}",
                     f"{pad.peer.element.name}.{pad.peer.name}"])
    return desc


def pipeline_from_description(desc: dict) -> Pipeline:
    """Instantiate a Pipeline from a structured description."""
    from .parse import parse_launch

    return parse_launch(description_to_launch(desc))


def load_pipeline_file(path: str) -> Pipeline:
    """Load a ``.json`` structured description (or a launch-text file)."""
    from .parse import parse_launch

    with open(path) as fh:
        text = fh.read()
    if path.endswith(".json"):
        return pipeline_from_description(json.loads(text))
    return parse_launch(text.strip())


def _prop_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _needs_quote(v: str) -> bool:
    return v == "" or any(c in v for c in " !\"'")
