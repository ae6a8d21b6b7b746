#!/usr/bin/env python
"""Launch-line drop-in compat coverage of the port against the
reference's OWN test corpus: the port's counterpart of
``tools/compat_coverage.py``.

Scans every ``runTest.sh`` under ``<reference_root>/tests`` for ``gstTest
"..."`` pipeline strings (upstream NNStreamer's SSAT harness) and tries to
CONSTRUCT each one through nnstreamer_tpu_torch's ``parse_launch``: the
measurable form of "reference launch lines run unchanged". Construction
only: no ``play()``, because most lines reference fixture files their
suites generate at run time. The scan, the shell expansion and the
classification are the reference tool's, kept verbatim:

  constructed       — parse_launch built the pipeline
  fixture_missing   — grammar parsed but a referenced file is absent
  parse_failed      — parse/link/negotiation raised (the real gaps)
  shell_var_skipped — line still contains unresolved ``$...`` after the
                      harness substitutions
  negative_raised / negative_constructed — the corpus's expect-fail lines

No upstream checkout is carried by the repo, so the root is an argument.
The detail JSON (counts, ``by_suite``, ``top_failures``, and each line's
class under ``lines``) goes to ``--out`` (default
``COMPAT_COVERAGE_torch.json`` at the repo root; the reference's
``COMPAT_COVERAGE.json`` is never written); one summary line is printed.

    python tools/compat_coverage_torch.py /path/to/nnstreamer [--out F]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from collections import Counter, defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "COMPAT_COVERAGE_torch.json")

# re.S: the corpus writes multi-line pipelines with backslash-newline
# continuations inside the quoted string — '\\.' must match them
_GSTTEST = re.compile(r'gstTest\s+"((?:[^"\\]|\\.)*)"\s*([^\n]*)', re.S)
# the harness always passes the plugin path first; not part of the line
_PLUGIN_PATH = re.compile(r"--gst-plugin-path=\S+\s*")
_SHELL_VAR = re.compile(r"\$\{?[A-Za-z0-9_#@*]+\}?|\$\(")


def _unescape(s: str) -> str:
    # shell line continuations (backslash-newline) join with a space,
    # then double-quote escapes \" \( \) \$ \\ drop the backslash
    s = re.sub(r"\\\n[ \t]*", " ", s)
    return re.sub(r'\\(.)', r'\1', s)


_FUNC_HEAD_RE = re.compile(r"(?:function\s+)?(\w+)\s*\(\)\s*\{")
_ASSIGN_RE = re.compile(r'^(\w+)=("[^"$`]*"|[^\s$`;&|()<>]+)\s*$', re.M)


def _subst_env(line: str, env: dict) -> str:
    for k, v in env.items():
        if v is None:
            continue
        line = line.replace("${%s}" % k, v)
        line = re.sub(rf"\${k}(?![A-Za-z0-9_])",
                      v.replace("\\", r"\\"), line)
    return line


def _expand_shell(text: str) -> str:
    """Best-effort shell expansion so more corpus lines are evaluable:
    parameterized SSAT helpers (``function do_test() { gstTest "...${1}..."
    }``) are inlined IN PLACE at each call site with positional
    substitution (zero-arg calls included), and scalar assignments apply
    POSITIONALLY — a ``PATH_TO_MODEL=`` reassigned mid-file substitutes
    the value in force at each line, not last-assignment-wins. Anything
    still carrying ``$`` afterwards is classified shell_var_skipped as
    before — expansion only ADDS evaluable lines, never guesses."""
    import shlex

    # 0. normalize $VAR to ${VAR} so later textual substitutions can't
    # merge a variable with adjacent substituted text ("$A$B" with B→x
    # must become "${A}x", never the new variable "$Ax")
    text = re.sub(r"\$([A-Za-z_]\w*)", r"${\1}", text)

    # 1. function bodies (balanced braces), cut from the scan text so
    # their unexpanded gstTest lines aren't double counted
    funcs = {}
    spans = []
    for m in _FUNC_HEAD_RE.finditer(text):
        depth, i = 1, m.end()
        while i < len(text) and depth:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
            i += 1
        funcs[m.group(1)] = text[m.end():i - 1]
        spans.append((m.start(), i))
    remainder_parts = []
    pos = 0
    for a, b in spans:
        remainder_parts.append(text[pos:a])
        pos = b
    remainder_parts.append(text[pos:])
    remainder = "".join(remainder_parts)

    # 2. inline calls IN PLACE (preserves assignment ordering relative to
    # the instantiated gstTest lines); zero-arg invocations included
    for name, body in funcs.items():
        if "gstTest" not in body:
            continue

        def _inline(call, _body=body):
            try:
                args = shlex.split(call.group(1) or "")
            except ValueError:
                return call.group(0)
            inst = _body
            for idx, val in enumerate(args[:9], start=1):
                inst = inst.replace("${%d}" % idx, val)
                inst = re.sub(rf"\${idx}(?![0-9])", val, inst)
            return inst

        remainder = re.sub(rf"^[ \t]*{name}(?:[ \t]+([^\n]*))?$", _inline,
                           remainder, flags=re.M)

    # 3. simple for-loops over literal word lists instantiate per value,
    # matching BOTH the same-line "for X in a b; do" form (the corpus's
    # style) and newline-do. The body is tempered to contain no nested
    # `for`, so the INNERMOST loop unrolls first and repeated passes
    # expand outward — never across half-instantiated fragments.
    loop_re = re.compile(
        r"^[ \t]*for[ \t]+(\w+)[ \t]+in[ \t]+([^\n;$`]+?)[ \t]*;?"
        r"(?:[ \t]*\n[ \t]*|[ \t]+)do\b"
        r"((?:(?!^[ \t]*for[ \t]).)*?)^[ \t]*done[ \t]*$",
        re.M | re.S)

    def _unroll(m):
        var, words, body = m.group(1), m.group(2).split(), m.group(3)
        insts = []
        for w in words:
            inst = body.replace("${%s}" % var, w)
            inst = re.sub(rf"\${var}(?![A-Za-z0-9_])", w, inst)
            insts.append(inst)
        return "\n".join(insts)

    for _ in range(3):  # nesting depth
        new = loop_re.sub(_unroll, remainder)
        if new == remainder:
            break
        remainder = new

    # 4. positional scalar substitution: walk lines, env updates as
    # assignments appear (var-in-var resolved against the env so far).
    # Harness-only vars whose VALUE is grammar-irrelevant get synthetic
    # defaults (ports from get_available_port, platform .so extension).
    env: dict = {"PORT": "5000", "PORT1": "5001", "PORT2": "5002",
                 "SO_EXT": "so"}
    out_lines = []
    for line in remainder.splitlines():
        am = _ASSIGN_RE.match(line)
        if am:
            val = _subst_env(am.group(2).strip('"'), env)
            env[am.group(1)] = None if "$" in val else val
            out_lines.append(line)
            continue
        out_lines.append(_subst_env(line, env))
    return "\n".join(out_lines)


# fixtures the reference suite GENERATES at run time with an echo
# redirect (e.g. nnstreamer_decoder_pose writes pose_label.txt) — the
# construction pass materializes them in a per-suite overlay
_ECHO_WRITE = re.compile(r'echo\s+"((?:[^"\\]|\\.)*)"\s*>\s*([\w.\-]+)', re.S)


def _suite_overlay(suite_dir: str, generated: dict) -> str:
    """Tempdir mirroring the read-only suite dir (symlinks) plus the
    suite's runtime-generated text fixtures."""
    import tempfile

    d = tempfile.mkdtemp(prefix="nns_compat_")
    for name in os.listdir(suite_dir):
        os.symlink(os.path.join(suite_dir, name), os.path.join(d, name))
    for name, content in generated.items():
        path = os.path.join(d, name)
        if not os.path.lexists(path):
            with open(path, "w") as fh:
                fh.write(content)
    return d


def collect_lines(ref: str):
    out = []
    for root, _dirs, files in os.walk(os.path.join(ref, "tests")):
        if "runTest.sh" not in files:
            continue
        suite = os.path.basename(root)
        text = _expand_shell(open(os.path.join(root, "runTest.sh"),
                                  errors="replace").read())
        generated = {m.group(2): _unescape(m.group(1)) + "\n"
                     for m in _ECHO_WRITE.finditer(text)}
        for m in _GSTTEST.finditer(text):
            line = _unescape(m.group(1))
            line = _PLUGIN_PATH.sub("", line).strip()
            # launcher flags, not pipeline grammar
            line = re.sub(r"^(-v|--verbose)\s+", "", line)
            # SSAT gstTest args: <case> <ignore> <expectFail> ... — the
            # reference's NEGATIVE tests (expectFail=1) are lines that
            # MUST fail; they are scored separately (error compat)
            args = m.group(2).split()
            expect_fail = len(args) >= 3 and args[2] == "1"
            if line:
                out.append((suite, line, expect_fail, root, generated))
    return out


def classify(lines) -> tuple:
    """Construct every line with the port's ``parse_launch``; return the
    counts, the per-suite counts, the failure messages and each line's
    class (the reference tool's loop, plus the per-line record)."""
    import shutil

    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    counts = Counter()
    by_suite = defaultdict(Counter)
    failures = Counter()
    per_line = []
    launch_cwd = os.getcwd()
    overlays = {}
    for suite, line, expect_fail, suite_dir, generated in lines:
        if _SHELL_VAR.search(line):
            counts["shell_var_skipped"] += 1
            by_suite[suite]["shell_var_skipped"] += 1
            per_line.append({"suite": suite, "line": line,
                             "class": "shell_var_skipped"})
            continue
        try:
            # SSAT runs each runTest.sh from its own suite directory, so
            # relative fixture paths resolve there; suites that generate
            # fixtures at run time get an overlay dir
            if generated:
                if suite_dir not in overlays:
                    overlays[suite_dir] = _suite_overlay(suite_dir, generated)
                os.chdir(overlays[suite_dir])
            else:
                os.chdir(suite_dir)
            pipe = parse_launch(line)
            pipe.stop()
            ok = True
        except Exception as e:  # noqa: BLE001 — classification, not flow
            ok = False
            err = e
        finally:
            os.chdir(launch_cwd)
        if expect_fail:
            kind = ("negative_raised" if not ok
                    else "negative_constructed")
        elif ok:
            kind = "constructed"
        else:
            msg = str(err)
            if isinstance(err, FileNotFoundError) or (
                    "No such file or directory" in msg
                    or "cannot open" in msg):
                kind = "fixture_missing"
            else:
                kind = "parse_failed"
                failures[f"{type(err).__name__}: {msg[:90]}"] += 1
        counts[kind] += 1
        by_suite[suite][kind] += 1
        per_line.append({"suite": suite, "line": line, "class": kind})
    for overlay in overlays.values():
        shutil.rmtree(overlay, ignore_errors=True)
    return counts, by_suite, failures, per_line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("reference_root",
                    help="an upstream NNStreamer checkout (its tests/ tree)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the detail JSON (default COMPAT_COVERAGE_torch.json)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(args.reference_root, "tests")):
        raise SystemExit(f"{args.reference_root}: no tests/ directory")
    out_path = os.path.abspath(args.out)
    lines = collect_lines(args.reference_root)
    counts, by_suite, failures, per_line = classify(lines)
    evaluable = (counts["constructed"] + counts["parse_failed"]
                 + counts["fixture_missing"])
    grammar_ok = counts["constructed"] + counts["fixture_missing"]
    result = {
        "metric": "reference_launch_line_construct_coverage_torch",
        "total_lines": len(lines),
        "constructed": counts["constructed"],
        "fixture_missing": counts["fixture_missing"],
        "parse_failed": counts["parse_failed"],
        "negative_raised": counts["negative_raised"],
        "negative_constructed": counts["negative_constructed"],
        "shell_var_skipped": counts["shell_var_skipped"],
        "grammar_rate_evaluable": (
            round(grammar_ok / evaluable, 3) if evaluable else None),
    }
    detail = {
        **result,
        "by_suite": {s: dict(c) for s, c in sorted(by_suite.items())},
        "top_failures": failures.most_common(25),
        "lines": per_line,
    }
    with open(out_path, "w") as fh:
        json.dump(detail, fh, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
