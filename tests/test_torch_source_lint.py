"""The port's source lint (NNL1xx) against nnstreamer_tpu's.

Every snippet of the reference's ``tests/test_lint.py`` source rules is
read from that file (the string handed to its ``_lint_snippet``) and
linted by both packages' passes. Snippets free of JAX spellings must give
equal ``(rule, line, severity)`` lists; each JAX-spelled one has a torch
twin here (same lines, same shape of code), and the port's pass on the
twin must give the reference's list on the original.

The helpers here are shared by the port's other lint-parity tests
(``test_torch_{concurrency,lifecycle,transfer,protocol}_lint.py``).
"""
import ast
import textwrap
from pathlib import Path

import pytest

from nnstreamer_tpu.analysis import source_lint as ref_source
from nnstreamer_tpu_torch.analysis import source_lint as port_source

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"


def _string(node, consts):
    """A literal string argument: a constant, a class constant
    (``self.BAD``) or a sum of them."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return consts[node.attr]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _string(node.left, consts) + _string(node.right, consts)
    raise ValueError(f"not a literal snippet: {ast.unparse(node)}")


def reference_snippets(test_file: str, with_subdir: bool):
    """[(id, subdir, code)] for every ``_lint_snippet``/``_lint_text``
    call in a reference test file; ``id`` is ``<test name>:<line>`` (the
    call's line in that file)."""
    tree = ast.parse((TESTS / test_file).read_text())
    scopes = [(tree, {})]
    for cls in tree.body:
        if isinstance(cls, ast.ClassDef):
            scopes.append((cls, {
                t.id: n.value.value for n in cls.body
                if isinstance(n, ast.Assign)
                and isinstance(n.value, ast.Constant)
                for t in n.targets if isinstance(t, ast.Name)}))
    out = []
    for scope, consts in scopes:
        for fn in scope.body:
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name.startswith("test")):
                continue
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id in ("_lint_snippet", "_lint_text")):
                    continue
                strs = [_string(a, consts) for a in node.args[1:]]
                if with_subdir:
                    subdir, code = strs
                else:
                    subdir, (code,) = "", strs
                out.append((f"{fn.name}:{node.lineno}", subdir, code))
    return sorted(out, key=lambda s: int(s[0].rsplit(":", 1)[1]))


def jax_spelled(code: str) -> bool:
    return "jax" in code or "jnp" in code or "block_until_ready" in code


def lint_list(lint, tmp_path, side: str, subdir: str, code: str,
              root: bool = True):
    """One pass on ``code`` written as ``<tmp>/<side>/<subdir>/mod.py``:
    the sorted (rule, line, severity) list."""
    d = tmp_path / side / subdir if subdir else tmp_path / side
    d.mkdir(parents=True, exist_ok=True)
    f = d / "mod.py"
    f.write_text(textwrap.dedent(code))
    kw = {"root": str(tmp_path / side)} if root else {}
    return sorted((x.rule, x.line, x.severity.value)
                  for x in lint([f], **kw))


SNIPPETS = reference_snippets("test_lint.py", with_subdir=True)

# torch twins of the JAX-spelled snippets: a host pull (``.cpu()``) where
# the reference waits on ``block_until_ready``, CUDA-graph capture
# (``make_graphed_callables``) and a ``capture_safe`` model where it jits
TWINS = {
    "test_nnl101_sync_in_element_hot_path:214": """
            class El:
                def chain(self, pad, buf):
                    out = self.fn(buf)
                    out.cpu()
        """,
    "test_nnl101_sync_in_element_hot_path:221": """
            class El:
                def debug_probe(self, buf):  # not a hot function
                    buf.cpu()
        """,
    "test_nnl101_pragma_suppresses:243": """
            class El:
                def chain(self, pad, buf):
                    # nnlint: disable=NNL101 — sampled probe
                    buf.cpu()
        """,
    "test_nnl106_tracer_branch:330": """
            import torch

            def fn(x):
                if x > 0:
                    return x
                return -x

            graphed = torch.cuda.make_graphed_callables(fn, (torch.ones(1),))
        """,
    "test_nnl106_static_args_and_closures_ok:343": """
            import functools
            import torch

            class Scaled:
                capture_safe = True
                def __call__(self, x):
                    if self.n > 3:   # a Python attribute: fine
                        return x * self.n
                    if x.dim() > 1 and x.is_cuda:  # metadata: fine
                        return x
                    return x

            def make(mode):
                def gen(key):
                    if mode == "zeros":   # closure: fine
                        return key
                    if key is None:       # identity check: fine
                        return key
                    if key.shape[0] > 1:  # shape: static at trace: fine
                        return key
                    return key
                return torch.cuda.make_graphed_callables(gen, (torch.ones(2),))
        """,
}


def test_every_snippet_is_read():
    # 15 literal snippets in the reference's source-rule tests, 5 of them
    # JAX-spelled (each has a twin)
    assert len(SNIPPETS) == 15
    assert {i for i, _, c in SNIPPETS if jax_spelled(c)} == set(TWINS)


@pytest.mark.parametrize("sid,subdir,code", SNIPPETS,
                         ids=[s[0] for s in SNIPPETS])
def test_port_gives_the_references_findings(tmp_path, sid, subdir, code):
    want = lint_list(ref_source.lint_source, tmp_path, "ref", subdir, code)
    twin = TWINS.get(sid, code)
    got = lint_list(port_source.lint_source, tmp_path, "port", subdir, twin)
    assert got == want


def test_nnl101_torch_syncs(tmp_path):
    got = lint_list(port_source.lint_source, tmp_path, "port", "serving", """
        import torch

        class S:
            def _loop(self):
                torch.cuda.synchronize()
                self.done.synchronize()
                t = self.out.item()
                return self.out.tolist(), self.out.numpy(), t
    """)
    assert [(r, ln) for r, ln, _ in got] == [
        ("NNL101", 6), ("NNL101", 7), ("NNL101", 8), ("NNL101", 9),
        ("NNL101", 9)]


def test_nnl106_capture_safe_forward_and_export(tmp_path):
    got = lint_list(port_source.lint_source, tmp_path, "port", "models", """
        import torch

        class Model(torch.nn.Module):
            capture_safe = True

            def forward(self, x, n):
                if n > 2:
                    return x
                return x + 1

        def stage(x):
            while x.sum() > 0:
                x = x - 1
            return x

        program = torch.export.export(stage, (torch.ones(2),))
    """)
    assert [(r, ln) for r, ln, _ in got] == [("NNL106", 8),
                                             ("NNL106", 13)]
