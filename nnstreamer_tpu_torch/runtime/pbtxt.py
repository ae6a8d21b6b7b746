"""Pipeline ↔ pbtxt (MediaPipe-style graph text) conversion.

Reference analog: ``tools/development/parser/convert.c`` — the
reference's gst-pipeline↔pbtxt converter for its visual pipeline editor.
Same emitted shape, faithfully:

  * top-level ``input_stream:`` / ``output_stream:`` lines for elements
    with no sink pads (sources) / no src pads (sinks);
  * one ``node { calculator: "<element>Calculator" ... }`` block per
    element that has BOTH sides, its streams named by the producing pad:
    ``<element>_<node_index>_<pad_index>`` (sources contribute their node
    name directly — "any src has only one pad", convert.c:53-60);
  * node naming: first instance of an element type keeps the bare
    element name, later ones get ``_<index+1>`` (convert.c:28-39);
  * a stream feeding a SINK is named after the sink's node name
    (convert.c pbtxt_print_node_output_stream:79-81 — "assume that any
    sink has only one pad"), so the top-level ``output_stream`` line
    references a stream some node actually produces;
  * properties ARE carried, in ``node_options`` (the reference left this
    as a TODO, convert.c:111): each non-default scalar property becomes
    an ``option: "key=value"`` entry. Topology-only consumers can ignore
    the block; ``from_pbtxt`` replays the options into the launch line.

``from_pbtxt`` rebuilds a launch string from that topology: producers
are resolved by stream name, fan-out becomes a named ``tee``-style
segment reference (``name=X`` + ``X.`` chains), multi-input nodes use
the launch grammar's pad-reference form. Sinks resolve by stream NAME
(conformant emissions); files from other tools that name sink streams
differently fall back to in-order attachment to dangling streams.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

_OPTIONS_TYPE = "type.googleapis.com/nnstreamer.LaunchOptions"


def _kind(el) -> str:
    return el.ELEMENT_NAME or type(el).__name__.lower()


def _number_elements(pipeline):
    """One pass: element runtime-name -> (per-kind index, pbtxt node
    name per the reference numbering — bare kind for the first instance,
    ``kind_<i+1>`` after)."""
    seen: Dict[str, int] = {}
    indices: Dict[str, int] = {}
    names: Dict[str, str] = {}
    for el in pipeline.elements.values():
        kind = _kind(el)
        i = seen.get(kind, 0)
        seen[kind] = i + 1
        indices[el.name] = i
        names[el.name] = kind if i == 0 else f"{kind}_{i + 1}"
    return indices, names


def _launch_options(el) -> List[str]:
    """Non-default scalar properties as launch-spelling ``key=value``
    strings (dashes, booleans as true/false). Properties holding parsed
    non-scalar values (e.g. combination tuples) are emitted from their
    original launch value when the element kept one, else skipped —
    pbtxt remains loadable either way."""
    out: List[str] = []
    # property tables are split across the MRO (Element merges them in
    # __init__ as _prop_defs) — reading one class's table would omit
    # inherited props like a paced source's num-buffers
    declared = getattr(el, "_prop_defs", None) or getattr(
        type(el), "PROPERTIES", {})
    values = getattr(el, "props", {})
    for key, prop in declared.items():
        v = values.get(key, prop.default)
        if v == prop.default or v is None:
            continue
        if isinstance(v, bool):
            v = "true" if v else "false"
        elif not isinstance(v, (str, int, float)):
            continue
        v = str(v)
        if '"' in v:
            # no escaping scheme survives both the pbtxt string literal
            # and the launch grammar — skip rather than corrupt the value
            continue
        if any(c in v for c in " \t!"):
            v = '\\"' + v + '\\"'
        out.append(f"{key.replace('_', '-')}={v}")
    return out


def to_pbtxt(pipeline) -> str:
    """Emit the reference converter's pbtxt for a built Pipeline."""
    indices, names = _number_elements(pipeline)
    lines: List[str] = []

    def stream_of(src_pad) -> str:
        owner = src_pad.element
        if not getattr(owner, "sink_pads", ()):  # source: node name IS the stream
            return names[owner.name]
        peer = src_pad.peer
        if peer is not None and not getattr(peer.element, "src_pads", ()):
            # stream into a sink is named after the sink node
            # (convert.c:79-81) so the top-level output_stream line
            # references a produced stream
            return names[peer.element.name]
        pad_idx = list(owner.src_pads).index(src_pad)
        return f"{_kind(owner)}_{indices[owner.name]}_{pad_idx}"

    for el in pipeline.elements.values():
        if not getattr(el, "sink_pads", ()):
            lines.append(f'input_stream: "{names[el.name]}"')
        if not getattr(el, "src_pads", ()):
            lines.append(f'output_stream: "{names[el.name]}"')

    for el in pipeline.elements.values():
        sinks = getattr(el, "sink_pads", ())
        srcs = getattr(el, "src_pads", ())
        if not sinks or not srcs:
            continue
        kind = _kind(el)
        lines.append("")
        lines.append("node: {")
        lines.append(f'\tcalculator: "{kind}Calculator"')
        for pad in sinks:
            if pad.peer is not None:
                lines.append(f'\tinput_stream: "{stream_of(pad.peer)}"')
        for pad in srcs:
            lines.append(f'\toutput_stream: "{stream_of(pad)}"')
        opts = _launch_options(el)
        if opts:
            lines.append("\tnode_options: {")
            lines.append(f"\t\t[{_OPTIONS_TYPE}] {{")
            for o in opts:
                lines.append(f'\t\t\toption: "{o}"')
            lines.append("\t\t}")
            lines.append("\t}")
        lines.append("}")
    return "\n".join(lines) + "\n"


_NODE_HEAD_RE = re.compile(r"node:?\s*\{")
_FIELD_RE = re.compile(r'(calculator|input_stream|output_stream):\s*"([^"]+)"')
_OPTION_RE = re.compile(r'option:\s*"((?:[^"\\]|\\.)*)"')
_SRC_INDEX_RE = re.compile(r"_\d+$")


def _split_nodes(text: str) -> Tuple[str, List[str]]:
    """(top-level text, node bodies) with BALANCED brace scanning — the
    protobuf text format allows both ``node {`` and ``node: {`` heads
    and nested sub-blocks (node_options) inside a node."""
    bodies: List[str] = []
    top_parts: List[str] = []
    pos = 0
    while True:
        m = _NODE_HEAD_RE.search(text, pos)
        if m is None:
            top_parts.append(text[pos:])
            return "".join(top_parts), bodies
        top_parts.append(text[pos:m.start()])
        depth = 1
        i = m.end()
        while i < len(text) and depth:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
            i += 1
        if depth:
            raise ValueError("pbtxt: unbalanced braces in node block")
        bodies.append(text[m.end():i - 1])
        pos = i


def from_pbtxt(text: str) -> str:
    """Rebuild a launch string from pbtxt topology.

    Properties don't round-trip (the format doesn't carry them — same
    limitation as the reference converter). Sink attachment is a
    documented HEURISTIC: the format records sinks only as top-level
    ``output_stream`` names with no producer link, so each listed sink
    is attached to the next dangling (consumer-less) node stream in
    order — correct for every pipeline the emitter produces, ambiguous
    only for hand-written pbtxt with reordered sink lines.
    """
    top_text, node_bodies = _split_nodes(text)
    top_inputs: List[str] = []
    top_outputs: List[str] = []
    nodes: List[Tuple[str, List[str], List[str], List[str]]] = []
    for body in node_bodies:
        fields = _FIELD_RE.findall(body)
        calc = [v for k, v in fields if k == "calculator"]
        ins = [v for k, v in fields if k == "input_stream"]
        outs = [v for k, v in fields if k == "output_stream"]
        opts = [o.replace('\\"', '"') for o in _OPTION_RE.findall(body)]
        if not calc:
            raise ValueError("pbtxt node without calculator")
        el = calc[0]
        if el.endswith("Calculator"):
            el = el[: -len("Calculator")]
        nodes.append((el, ins, outs, opts))
    for m in _FIELD_RE.finditer(top_text):
        if m.group(1) == "input_stream":
            top_inputs.append(m.group(2))
        elif m.group(1) == "output_stream":
            top_outputs.append(m.group(2))

    # producer stream name -> launch name of the producing element
    produced: Dict[str, str] = {}
    counts: Dict[str, int] = {}

    def fresh(kind: str) -> str:
        counts[kind] = counts.get(kind, 0) + 1
        return f"{kind}_n{counts[kind]}"

    src_kinds: Dict[str, str] = {}
    for s in top_inputs:
        kind = _SRC_INDEX_RE.sub("", s)  # source node name = element[_i]
        src_kinds[s] = kind
        produced[s] = fresh(kind)
    for el, ins, outs, _opts in nodes:
        name = fresh(el)
        for o in outs:
            produced[o] = name

    # emit: each top-level source opens a segment; nodes chain from their
    # first input's producer, additional inputs use pad references
    segs: List[str] = []
    consumed: set = set()
    for s in top_inputs:
        segs.append(f"{src_kinds[s]} name={produced[s]}")
    for el, ins, outs, opts in nodes:
        name = produced[outs[0]] if outs else fresh(el)
        head = " ".join([el, f"name={name}", *opts])
        first = True
        for i in ins:
            if i not in produced:
                raise ValueError(f"pbtxt stream '{i}' has no producer")
            consumed.add(i)
            src = produced[i]
            if first:
                segs.append(f"{src}. ! {head}")
                first = False
            else:
                segs.append(f"{src}. ! {name}.")
        if not ins:
            segs.append(head)
    # sinks: a conformant emission names the stream feeding a sink after
    # the sink node (convert.c:79-81), so resolve by NAME first; foreign
    # files that didn't fall back to in-order attachment to the
    # remaining dangling (consumer-less) streams
    dangling = [s for s in produced if s not in consumed]
    leftover_outputs: List[str] = []
    for sink_stream in top_outputs:
        if sink_stream in produced and sink_stream in dangling:
            dangling.remove(sink_stream)
            kind = _SRC_INDEX_RE.sub("", sink_stream)
            segs.append(
                f"{produced[sink_stream]}. ! {kind} name={fresh(kind)}")
        else:
            leftover_outputs.append(sink_stream)
    for sink_stream, feed in zip(leftover_outputs, dangling):
        kind = _SRC_INDEX_RE.sub("", sink_stream)
        segs.append(f"{produced[feed]}. ! {kind} name={fresh(kind)}")
    return "  ".join(segs)


def main() -> None:  # pragma: no cover - CLI helper, exercised via __main__
    import sys

    from .parse import parse_launch

    print(to_pbtxt(parse_launch(sys.argv[1])))


if __name__ == "__main__":  # pragma: no cover
    main()
