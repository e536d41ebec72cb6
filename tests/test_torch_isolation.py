"""jellyfish_tpu_torch stands alone: it imports neither jax nor anything of
jellyfish_tpu, and its entry points do not fall back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def test_count_runs_without_jax(tmp_path):
    """A tiny count on the CPU in a fresh interpreter leaves jax and
    jellyfish_tpu out of sys.modules."""
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGTACGGTACCATGACGTTAGCNACGTAGGCATCGACTAGCATCGA\n")
    code = (
        "import sys\n"
        "import jellyfish_tpu_torch\n"
        "from jellyfish_tpu_torch.cli import main\n"
        f"assert main(['count', '-m', '11', '-s', '1k', '--chunk-len', '64',"
        f" '-o', {str(tmp_path / 'o.jf')!r}, {str(fa)!r}], device='cpu') == 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'jellyfish_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "o.jf").stat().st_size > 0


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_imports_in_sources():
    files = sorted((ROOT / "jellyfish_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "jellyfish_tpu"), (f, mod)


def test_counter_without_card_raises(monkeypatch):
    from jellyfish_tpu_torch.counter import MerCounter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MerCounter(21, 1 << 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MerCounter(21, 1 << 20, device="cuda")
