"""gst-launch-style pipeline description parser (L6).

Reference analog: GStreamer's ``gst_parse_launch`` — the reference's primary
UX is text pipelines like::

    videotestsrc ! tensor_converter ! tensor_filter framework=... model=m \
      ! tensor_decoder mode=image_labeling option1=labels.txt ! tensor_sink

Supported syntax subset:
  * ``elem prop=value ...`` — element with properties (values may be quoted);
  * ``a ! b ! c`` — linking;
  * ``name=n`` — naming an element; ``n.`` / ``n.pad`` — link to/from a named
    element (request pads created on demand), e.g. ``t. ! queue ! sink``;
  * ``media/type,field=v,...`` — capsfilter (constrains negotiation);
  * parentheses/bins are not supported (the reference rarely uses them).
"""
from __future__ import annotations

import re
import shlex
from typing import List, Optional, Tuple

from ..core import Caps, Event, EventType, parse_caps_string
from ..core.caps import Structure, looks_like_caps
from .element import TransformElement
from .pad import Pad, PadDirection, PadTemplate
from .pipeline import Pipeline


class CapsFilter(TransformElement):
    """Pass-through element constraining negotiation to its caps (capsfilter)."""

    ELEMENT_NAME = "capsfilter"

    def __init__(self, caps: Caps, name=None):
        media = {s.media_type for s in caps.structures}
        tmpl = Caps(tuple(Structure.new(m) for m in media))
        self.SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, tmpl),)
        self.SRC_TEMPLATES = (PadTemplate("src", PadDirection.SRC, tmpl),)
        super().__init__(name)
        self.filter_caps = caps

    def handle_sink_event(self, pad: Pad, event: Event) -> None:
        if event.type is EventType.CAPS:
            caps = event.data["caps"].intersect(self.filter_caps)
            if caps.is_empty:
                raise ValueError(
                    f"{self.describe()}: caps {event.data['caps']} do not satisfy "
                    f"filter {self.filter_caps}"
                )
            event = Event.caps(caps if caps.is_fixed else caps.fixate())
        super().handle_sink_event(pad, event)

    def transform(self, buf):
        return buf


_NAME_REF_RE = re.compile(r"^(?P<el>[A-Za-z_][\w-]*)\.(?P<pad>[\w%]*)$")


def _pad_links(text: str) -> str:
    """Space-pad '!' link separators, but never inside quoted values
    (a model path like "dir/my!file.py" must survive intact)."""
    out = []
    quote = None
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
            out.append(ch)
        elif ch in "\"'":
            quote = ch
            out.append(ch)
        elif ch == "!":
            out.append(" ! ")
        else:
            out.append(ch)
    return "".join(out)

# One chain entry: ("el", Element) or ("ref", element_name, pad_name|None)
Entry = tuple


def launch_chains(description: str) -> List[List[List[str]]]:
    """Tokenize a launch description into chains of entry token lists.

    This is the pure grammar stage of :func:`parse_launch` — no elements
    are constructed. Each chain is a list of entries; each entry is the token
    list of one element / caps filter / name reference (``["tee",
    "name=t"]``, ``["video/raw,format=RGB"]``, ``["t."]``).
    """
    tokens = shlex.split(_pad_links(description))
    # gst-launch tolerates spaces around '=' in properties and caps
    # fields ("tee name =t", "format = RGB", "width= 100" — all appear in
    # the reference's own runTest corpus): rejoin the fragments. Only
    # unambiguous shapes merge — a bare '=', a token that IS a
    # continuation ("=t"), or a bare "key=" with exactly one '=' (so a
    # VALUE that merely ends with '=' , e.g. base64 padding, never grabs
    # its neighbor).
    fixed: List[str] = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        nxt = tokens[i + 1] if i + 1 < len(tokens) else None
        # a bare '=' (or '=value' continuation) can only be a split
        # assignment — merge regardless of the previous token's content
        # ("video/x-raw,width=100,height = 200" must rejoin even though
        # the prior fragment already carries '=' signs)
        if (tok == "=" and fixed and fixed[-1] != "!"
                and nxt is not None and nxt != "!"):
            fixed[-1] += "=" + nxt
            i += 2
            continue
        if tok.startswith("=") and tok != "=" and fixed and fixed[-1] != "!":
            fixed[-1] += tok
            i += 1
            continue
        if (tok.endswith("=") and tok.count("=") == 1 and tok != "="
                and nxt is not None and nxt != "!" and "=" not in nxt):
            # 'key= value' rejoins, but 'option= silent=true' is a
            # deliberately EMPTY value followed by a new assignment — a
            # token carrying its own '=' is never a bare value
            fixed.append(tok + nxt)
            i += 2
            continue
        fixed.append(tok)
        i += 1
    tokens = fixed
    # gst-launch allows spaces after commas inside caps strings
    # ("video/x-raw, width=160, height=120"): a comma-terminated token
    # continues in the next token — but ONLY for tokens that began as a
    # caps string (media/type head), so a property value with a trailing
    # comma (e.g. the reference's option3="0:1:2:3," grammar) is never
    # merged with its neighbor
    caps_head = re.compile(r"^[A-Za-z0-9.+-]+/[A-Za-z0-9.+-]+(,|$)")
    merged: List[str] = []
    for tok in tokens:
        if (merged and merged[-1].endswith(",") and tok != "!"
                and caps_head.match(merged[-1])):
            merged[-1] += tok
        else:
            merged.append(tok)
    tokens = merged

    # Group tokens into entries, entries into chains. Entries within a chain
    # are separated by '!'; a non-property token with no preceding '!' starts
    # a new chain (gst-launch semantics for "tee name=t t. ! ...").
    chains: List[List[List[str]]] = [[]]
    cur: Optional[List[str]] = None
    after_link = True  # pipeline start behaves like after '!'
    for tok in tokens:
        if tok == "!":
            if cur is None:
                raise ValueError("dangling '!' in launch string")
            chains[-1].append(cur)
            cur = None
            after_link = True
        elif cur is None:
            if not after_link and chains[-1]:
                chains.append([])
            cur = [tok]
            after_link = False
        elif "=" in tok:
            cur.append(tok)  # property of the current element
        else:
            chains[-1].append(cur)  # token starts a new chain
            chains.append([])
            cur = [tok]
    if cur is not None:
        chains[-1].append(cur)
    elif after_link and tokens:
        raise ValueError("launch string ends with '!'")
    if not tokens:
        raise ValueError("empty launch string")
    return chains


def parse_launch(description: str, pipeline: Optional[Pipeline] = None,
                 fuse: Optional[bool] = None, place=None) -> Pipeline:
    """Build a Pipeline from a launch string (elements linked, not started).

    Unknown element names raise with a did-you-mean suggestion from the
    registry (``registry.elements.suggest_element``). ``fuse`` and
    ``place`` forward to the Pipeline constructor (device-segment fusion,
    default on / NNS_NO_FUSE; profile-guided placement, default off /
    ``place="auto"`` / NNS_NO_PLACE); ignored when an existing
    ``pipeline`` is passed in.
    """
    from ..registry.elements import make_element

    pipe = pipeline or Pipeline(fuse=fuse, place=place)
    chains = launch_chains(description)

    links: List[Tuple[Entry, Entry]] = []
    for chain in chains:
        prev: Optional[Entry] = None
        for entry_tokens in chain:
            entry = _build_entry(entry_tokens, pipe, make_element)
            if prev is not None:
                links.append((prev, entry))
            prev = entry

    for src_ref, sink_ref in links:
        src_pad = _resolve_pad(pipe, src_ref, PadDirection.SRC)
        sink_pad = _resolve_pad(pipe, sink_ref, PadDirection.SINK)
        src_pad.link(sink_pad)

    return pipe


def _build_entry(tokens: List[str], pipe: Pipeline, make_element) -> Entry:
    head = tokens[0]
    m = _NAME_REF_RE.match(head)
    if m and len(tokens) == 1:
        return ("ref", m.group("el"), m.group("pad") or None)
    if looks_like_caps(head):
        caps = parse_caps_string(" ".join(tokens))
        el = CapsFilter(caps)
        pipe.add(el)
        return ("el", el)
    props = {}
    name = None
    for tok in tokens[1:]:
        k, eq, v = tok.partition("=")
        if not eq:
            raise ValueError(f"bad property token '{tok}' for element {head}")
        if k == "name":
            name = v
        else:
            props[k] = v
    el = make_element(head, name=name, **props)
    pipe.add(el)
    return ("el", el)


def _resolve_pad(pipe: Pipeline, ref: Entry, direction: PadDirection) -> Pad:
    if ref[0] == "el":
        return ref[1].get_compatible_pad(direction)
    _, el_name, pad_name = ref
    el = pipe.elements.get(el_name)
    if el is None:
        raise ValueError(f"launch string references unknown element '{el_name}'")
    if pad_name:
        pad = el.get_pad(pad_name)
        if pad is None:
            pad = el.request_pad(direction, pad_name)
        return pad
    return el.get_compatible_pad(direction)
