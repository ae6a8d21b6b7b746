"""`nnlint` CLI: ``python -m nnstreamer_tpu_torch lint <pbtxt | launch | pkg>``.

Target dispatch (per positional argument):

* a directory or ``.py`` file → source lint (pass 2);
* ``*.pbtxt``          → pbtxt topology → graph lint;
* ``*.launch``         → launch text file → graph lint;
* ``*.json``           → pipeline description file → graph lint;
* anything else        → treated as a launch string → graph lint.

Exit code: 0 clean (or warnings without ``--strict``); 1 when errors are
found — or, under ``--strict``, when anything at all is found. With no
target the command is the self-lint gate: a strict run of all five
source passes over the ``nnstreamer_tpu_torch`` tree.

The port of nnstreamer_tpu's ``analysis/cli.py``: the same dispatch,
flags and exit codes.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from .diagnostics import RULES, Diagnostic, Severity


def add_lint_args(parser) -> None:
    parser.add_argument(
        "targets", nargs="*",
        help="launch string, .pbtxt/.launch/.json file, .py file, or "
             "package directory (none = strict self-lint of the "
             "nnstreamer_tpu_torch tree, the CI gate)")
    parser.add_argument("--strict", action="store_true",
                        help="exit non-zero on ANY finding (CI gate); "
                             "default fails only on errors")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit findings as a JSON array")
    parser.add_argument("--rules", nargs="?", const="list", default=None,
                        dest="rules", metavar="FILTER",
                        help="no value: print the rule catalog and exit; "
                             "with a value: only report matching rules — "
                             "comma-separated IDs or families "
                             "(e.g. NNL201 or NNL3xx); 'list,FILTER' "
                             "prints the catalog restricted to FILTER")


def _lint_target(target: str) -> List[Diagnostic]:
    from .concurrency_lint import lint_concurrency
    from .graph_lint import lint_launch, lint_pbtxt
    from .lifecycle_lint import lint_lifecycle
    from .protocol_lint import lint_protocol
    from .source_lint import lint_source
    from .transfer_lint import lint_transfer

    from .diagnostics import make

    p = Path(target)
    try:
        is_dir = p.is_dir()
    except OSError:  # a launch line longer than a file name may be
        is_dir = False
    if is_dir or p.suffix == ".py":
        root = str(p.parent)
        return (lint_source([p], root=root)
                + lint_concurrency([p], root=root)
                + lint_lifecycle([p], root=root)
                + lint_transfer([p], root=root)
                + lint_protocol([p], root=root))
    if p.suffix in (".pbtxt", ".launch", ".json"):
        try:
            text = p.read_text()
        except OSError as e:
            return [make("NNL012", f"cannot read '{target}': {e}",
                         location=target)]
        if p.suffix == ".pbtxt":
            return lint_pbtxt(text)
        if p.suffix == ".json":
            from ..runtime.describe import description_to_launch

            try:
                return lint_launch(description_to_launch(json.loads(text)))
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                return [make("NNL012", f"bad pipeline description "
                             f"'{target}': {e}", location=target)]
        return lint_launch(text.strip())
    return lint_launch(target)


def _rule_filter(spec: str):
    """Predicate for a ``--rules`` FILTER: comma-separated exact IDs or
    ``xx``-suffixed family patterns (``NNL2xx`` = every NNL2 rule)."""
    tokens = [t.strip() for t in spec.split(",") if t.strip()]
    exact = {t for t in tokens if not t.lower().endswith("xx")}
    prefixes = tuple(t[:-2] for t in tokens if t.lower().endswith("xx"))

    def match(rule_id: str) -> bool:
        return rule_id in exact or (bool(prefixes)
                                    and rule_id.startswith(prefixes))
    return match


def _print_catalog(filter_spec: Optional[str] = None) -> None:
    """The ``--rules`` rule-catalog listing; a family filter joins it
    (``--rules list,NNL3xx`` prints just the lifecycle family)."""
    match = _rule_filter(filter_spec) if filter_spec else None
    for rule in RULES.values():
        if match is not None and not match(rule.id):
            continue
        print(f"{rule.id}  {rule.severity.value:7s} {rule.title}")
        print(f"    {rule.rationale}")


def run_lint(args) -> int:
    if args.rules is not None:
        tokens = [t.strip() for t in args.rules.split(",") if t.strip()]
        if "list" in tokens:
            rest = [t for t in tokens if t != "list"]
            _print_catalog(",".join(rest) if rest else None)
            return 0
    if not args.targets:
        # no target = the self-lint gate: strict source lint of our tree
        pkg = Path(__file__).resolve().parent.parent
        args.targets = [str(pkg)]
        args.strict = True
    diags: List[Diagnostic] = []
    for target in args.targets:
        diags.extend(_lint_target(target))
    if args.rules:
        match = _rule_filter(args.rules)
        diags = [d for d in diags if match(d.rule)]
    if args.as_json:
        print(json.dumps([d.to_dict() for d in diags], indent=2))
    else:
        for d in diags:
            print(d.format())
        n_err = sum(1 for d in diags if d.is_error)
        n_info = sum(1 for d in diags if d.severity is Severity.INFO)
        n_warn = len(diags) - n_err - n_info
        print(f"lint: {n_err} error(s), {n_warn} warning(s), "
              f"{n_info} info")
    if any(d.is_error for d in diags):
        return 1
    # info findings (NNL013 segmentation plans) are reports, not
    # violations: they never gate, not even under --strict
    if args.strict and any(d.severity is not Severity.INFO for d in diags):
        return 1
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Standalone entry (``python -m nnstreamer_tpu_torch.analysis.cli``)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="nnlint", description="nnstreamer_tpu_torch static analyzer")
    add_lint_args(ap)
    return run_lint(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
