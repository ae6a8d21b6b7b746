"""The port's lifecycle lint (NNL3xx) against nnstreamer_tpu's.

Every snippet of the reference's ``tests/test_lifecycle.py`` (the string handed
to its lint helper) is linted by both packages' passes; the rules are
spelling-independent, so the two must give equal ``(rule, line,
severity)`` lists on the same code.
"""
import pytest

from nnstreamer_tpu.analysis import lifecycle_lint as ref_pass
from nnstreamer_tpu_torch.analysis import lifecycle_lint as port_pass
from test_torch_source_lint import (ROOT, jax_spelled, lint_list,
                                   reference_snippets)

SNIPPETS = reference_snippets("test_lifecycle.py", with_subdir=False)


def test_every_snippet_is_read():
    assert SNIPPETS
    assert not [s for s, _, code in SNIPPETS if jax_spelled(code)]


@pytest.mark.parametrize("sid,subdir,code", SNIPPETS,
                         ids=[s[0] for s in SNIPPETS])
def test_port_gives_the_references_findings(tmp_path, sid, subdir, code):
    want = lint_list(ref_pass.lint_lifecycle, tmp_path, "ref", subdir, code,
                     root=False)
    got = lint_list(port_pass.lint_lifecycle, tmp_path, "port", subdir, code,
                    root=False)
    assert got == want


@pytest.mark.parametrize("tree", ["nnstreamer_tpu", "nnstreamer_tpu_torch"])
def test_both_trees_give_equal_findings(monkeypatch, tree):
    """Both packages' NNL3xx passes over a whole package tree, pragmas
    off (so the sets are not empty by construction): the same findings,
    but for the port's NNL203 on a torch ``.synchronize()`` under a lock,
    which the reference's spelling does not know."""
    for mod in (ref_pass, port_pass):
        monkeypatch.setattr(mod, "_suppressed", lambda *a, **k: False)

    def found(mod):
        return {(d.location, d.rule, d.line, d.severity.value, d.message)
                for d in mod.lint_lifecycle([str(ROOT / tree)], root=str(ROOT))}
    want, got = found(ref_pass), found(port_pass)
    torch_only = {d for d in got - want if "synchronize" in d[4]}
    assert all(d[1] == "NNL203" for d in torch_only)
    assert {d[:4] for d in got - torch_only} == {d[:4] for d in want}
