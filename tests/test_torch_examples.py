"""The four ``examples/torch`` scripts, each run in this process on the
CPU at its smallest size: each must finish, print its summary and hold
its own checks (the PACO suite's six ``[ok]`` lines, the sort exact,
``train_lm``'s "did not learn" assertion).  About 25 s on one core."""
import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, argv, expect", [
    ("quickstart", [], ["exact cover: True", "paco_sort(p=7): exact=True"]),
    ("serve_lm", ["--requests", "4", "--new-tokens", "4"],
     ["qwen3-0.6b: 4 requests, 16 tokens", "req 0: prompt [1, 7, 3]"]),
    ("train_lm", ["--steps", "30", "--batch", "8", "--seq", "64"],
     ["M params | loss"]),
    ("paco_algorithms", ["--p", "5"], ["LCS      p=5", "Sort     p=5"]),
])
def test_example_runs_on_the_cpu(name, argv, expect, capsys):
    rc = _example(name).main(["--device", "cpu", *argv])
    assert rc in (None, 0)
    out = capsys.readouterr().out
    for line in expect:
        assert line in out, out
    if name == "paco_algorithms":
        assert out.count("[ok]") == 6 and "FAILED" not in out


def test_examples_ask_for_the_card_by_default():
    """Without ``--device`` every example asks for CUDA, and says so on a
    host without it."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs on it")
    for name in ("quickstart", "serve_lm", "train_lm", "paco_algorithms"):
        with pytest.raises(RuntimeError, match="CUDA|cuda"):
            _example(name).main([])


def test_examples_import_neither_jax_nor_repro():
    """AST scan of the four scripts: they run where JAX is not installed."""
    import ast

    files = sorted(EXAMPLES.glob("*.py"))
    assert len(files) == 4
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & {
                "jax", "jaxlib", "repro"}, (f.name, names)
