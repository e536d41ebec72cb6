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


def test_disk_merge_and_readers_run_without_jax(tmp_path):
    """count --disk (spills merged on the device route), merge and the
    database readers in a fresh interpreter leave jax and jellyfish_tpu
    out of sys.modules."""
    fa = tmp_path / "r.fa"
    rng = __import__("random").Random(5)
    fa.write_text("".join(
        f">r{i}\n{''.join(rng.choice('ACGT') for _ in range(300))}\n"
        for i in range(40)))
    out = str(tmp_path / "o.jf")
    code = (
        "import sys, contextlib, io\n"
        "from jellyfish_tpu_torch.cli import main\n"
        f"c = ['count', '-m', '15', '-s', '1k', '--chunk-len', '1024',"
        f" '--disk', '--no-merge', '--no-unlink', '-o', {out!r}, {str(fa)!r}]\n"
        "assert main(c, device='cpu') == 0\n"
        "import glob\n"
        f"parts = sorted(glob.glob({out!r} + '[0-9]*'))\n"
        "assert len(parts) >= 2, parts\n"
        f"assert main(['merge', '-o', {out!r}, *parts], device='cpu') == 0\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    for sub in ('histo', 'dump', 'stats', 'info'):\n"
        f"        assert main([sub, {out!r}]) == 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'jellyfish_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert os.path.getsize(out) > 0


def test_bloom_path_runs_without_jax(tmp_path):
    """bc, count --bc, count --bf-size, count --chunk-len 1000 and query of
    both formats in a fresh interpreter leave jax and jellyfish_tpu out of
    sys.modules."""
    fa = tmp_path / "r.fa"
    rng = __import__("random").Random(7)
    fa.write_text("".join(
        f">r{i}\n{''.join(rng.choice('ACGT') for _ in range(200))}\n"
        for i in range(30)))
    d, f = str(tmp_path), str(fa)
    code = (
        "import sys, contextlib, io\n"
        "from jellyfish_tpu_torch.cli import main\n"
        "def run(*a):\n"
        "    assert main(list(a), device='cpu') == 0, a\n"
        f"run('bc', '-m', '15', '-s', '10k', '-o', {d!r} + '/r.bc', {f!r})\n"
        f"run('count', '-m', '15', '-s', '1k', '--bc', {d!r} + '/r.bc',"
        f" '-o', {d!r} + '/a.jf', {f!r})\n"
        f"run('count', '-m', '15', '-s', '1k', '--bf-size', '10k',"
        f" '-o', {d!r} + '/b.jf', {f!r})\n"
        f"run('count', '-m', '15', '-s', '1k', '--chunk-len', '1000',"
        f" '-o', {d!r} + '/c.jf', {f!r})\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    for db in ('/r.bc', '/c.jf'):\n"
        f"        run('query', '-s', {f!r}, {d!r} + db)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'jellyfish_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for name in ("r.bc", "a.jf", "b.jf", "c.jf"):
        assert (tmp_path / name).stat().st_size > 0


def test_count_modes_tools_and_api_run_without_jax(tmp_path):
    """count --packed-store, --if, --text, -g and -d, mem, cite, generate
    and the scripting API in a fresh interpreter leave jax and
    jellyfish_tpu out of sys.modules."""
    d = str(tmp_path)
    code = (
        "import sys, contextlib, io\n"
        "import jellyfish_tpu_torch as jf\n"
        "from jellyfish_tpu_torch.cli import main\n"
        "def run(*a):\n"
        "    assert main(list(a), device='cpu') == 0, a\n"
        f"run('generate', '-m', '20k', '-r', '150', '-q', '-o', {d!r} + '/g')\n"
        f"fq = {d!r} + '/g.fq'\n"
        f"open({d!r} + '/cmds', 'w').write('cat ' + fq + '\\n')\n"
        f"run('count', '-m', '15', '-s', '1k', '--packed-store', '--if', fq,"
        f" '--text', '-g', {d!r} + '/cmds', '-o', {d!r} + '/a.jf')\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    run('mem', '-m', '21', '-s', '4M', '--packed')\n"
        "    run('cite')\n"
        f"run('count', '-m', '15', '-s', '1k', '-o', {d!r} + '/b.jf', fq)\n"
        f"run('count', '-m', '15', '-s', '1k', '-d', '3', '-o', {d!r} + '/c.jf',"
        " fq)\n"
        "assert jf.ShardedMerCounter is jf.parallel.ShardedMerCounter\n"
        f"assert sum(c for _, c in jf.ReadMerFile({d!r} + '/b.jf')) > 0\n"
        f"q = jf.QueryMerFile({d!r} + '/b.jf')\n"
        "jf.HashCounter(10, 5).add(jf.MerDNA('A' * 15), 1)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'jellyfish_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "a.jf").stat().st_size > 0


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
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"jellyfish_tpu_torch/merge.py", "jellyfish_tpu_torch/mer.py",
            "jellyfish_tpu_torch/kernels/window.py",
            "jellyfish_tpu_torch/cli/dbtools.py",
            "jellyfish_tpu_torch/bloom.py",
            "jellyfish_tpu_torch/ops/bitsarray.py",
            "jellyfish_tpu_torch/cli/tools.py",
            "jellyfish_tpu_torch/kernels/sort.py",
            "jellyfish_tpu_torch/ops/packed_run.py",
            "jellyfish_tpu_torch/api.py",
            "jellyfish_tpu_torch/memmodel.py",
            "jellyfish_tpu_torch/parallel/sharded.py"} <= names
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


def test_bloom_structures_without_card_raise(monkeypatch):
    from jellyfish_tpu_torch.bloom import BloomCounter2, BloomFilter
    from jellyfish_tpu_torch.ops.bitsarray import BitsArray

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: BloomCounter2.from_fpr(0.01, 1000, 21),
                 lambda: BloomFilter.from_size(1000, 0.01, 21),
                 lambda: BitsArray(3, 100)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
