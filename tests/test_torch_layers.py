"""The port's kernel layer imports nothing above it.

Every module under ``qinfer_tpu_torch/ops/`` is parsed (not imported) and
each of its imports, at module level or inside a function, is checked: the
kernels and their plain versions may use ``_build``, ``profiling``,
``utils`` and one another, never the layers that call them (the SMC step,
the resamplers, the models, the sharded layer, the design heuristics and
the trial loop).
"""

import ast
from pathlib import Path

import pytest

OPS = Path(__file__).resolve().parent.parent / "qinfer_tpu_torch" / "ops"
ABOVE = {"resamplers", "smc", "models", "parallel", "heuristics",
         "perf_testing"}


def _imported_modules(tree):
    """(line, the top-level module of ``qinfer_tpu_torch`` named) of each
    import of the package in ``tree``: ``from ..x import y``, ``from
    qinfer_tpu_torch.x import y``, ``import qinfer_tpu_torch.x`` and
    ``from .. import x``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.level >= 2 or (node.level == 0 and node.module and
                                   node.module.split(".")[0]
                                   == "qinfer_tpu_torch"):
                parts = (node.module or "").split(".")
                if node.level == 0:
                    parts = parts[1:]
                names = ([parts[0]] if parts and parts[0]
                         else [a.name for a in node.names])
                for name in names:
                    yield node.lineno, name
        elif isinstance(node, ast.Import):
            for alias in node.names:
                parts = alias.name.split(".")
                if parts[0] == "qinfer_tpu_torch" and len(parts) > 1:
                    yield node.lineno, parts[1]


@pytest.mark.parametrize("path", sorted(OPS.glob("*.py")),
                         ids=lambda p: p.name)
def test_ops_module_imports_nothing_above_it(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    upward = [(line, name) for line, name in _imported_modules(tree)
              if name in ABOVE]
    assert upward == [], f"{path.name} imports from the layers above: {upward}"


def test_the_check_sees_each_form_of_import():
    src = ("from ..resamplers import a\n"
           "def f():\n    from ..models.base import b\n"
           "from .. import smc, utils\n"
           "import qinfer_tpu_torch.parallel\n"
           "from qinfer_tpu_torch.heuristics import c\n"
           "from . import pr1_trace\n"
           "from ..profiling import span\n")
    found = sorted(name for _, name in _imported_modules(ast.parse(src)))
    assert found == ["heuristics", "models", "parallel", "profiling",
                     "resamplers", "smc", "utils"]
