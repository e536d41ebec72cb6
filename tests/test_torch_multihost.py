"""`count --coordinator` of jellyfish_tpu_torch across real processes on the
CPU (gloo over TCP on free ports), against the JAX package.

The references: for the plain count and its modes, the JAX package's
single-process `count` with the same --matrix-seed; for --bf-size, JAX
ShardedMerCounter on a 1-device mesh, which filters at finalize, with a
filter sized so that the test's mers give no false positive (asserted).
Records are compared past the header. Each world's processes run all their
modes in turn, one process group each, to save process starts; a module
fixture runs them once and the tests read what they wrote."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from jellyfish_tpu_torch.cli import main as torch_main
from jellyfish_tpu_torch.io.header import FileHeader

from tests.conftest import random_dna

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
K, SIZE, SEED, CHUNK = 21, "4k", 7, "2048"
BASE = ["count", "-m", str(K), "-s", SIZE, "-C", "--matrix-seed", str(SEED),
        "--chunk-len", CHUNK]
# a spill on every step: at least 2 a rank
DISK = ["--disk", "-s", "256"]

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from jellyfish_tpu_torch.cli import main

    rank, world = int(sys.argv[1]), int(sys.argv[2])

    def api(job):
        from jellyfish_tpu_torch.gf2 import GF2Matrix
        from jellyfish_tpu_torch.io.parse import pack_chunk
        from jellyfish_tpu_torch.parallel import ShardedMerCounter, make_mesh
        from jellyfish_tpu_torch.parallel.multihost import (
            assemble_db, init_multihost, shutdown_multihost,
            write_local_segments)

        init_multihost(f"127.0.0.1:{job['port']}", world, rank, device="cpu")
        try:
            d = np.load(job["data"])
            matrix = GF2Matrix(int(d["r"]), int(d["c"]), d["columns"])
            counter = ShardedMerCounter(
                job["k"], job["size"], mesh=make_mesh(2, "cpu"),
                canonical=True, matrix=matrix, group=dist.group.WORLD)
            assert counter.n_shards == 2 * world, counter.n_shards
            assert counter.first_shard == 2 * rank
            steps = d[f"rank{rank}"]
            i = 0
            while counter.any_rank(i < len(steps)):
                if i >= len(steps):
                    counter.empty_step()
                elif i % 2:
                    packed = [pack_chunk(c) for c in steps[i]]
                    counter.add_chunks_packed(
                        np.stack([p[0] for p in packed]),
                        np.stack([p[1] for p in packed]))
                else:
                    counter.add_chunks(steps[i])
                i += 1
            try:
                counter.finalize_np()
            except RuntimeError:
                pass
            else:
                raise AssertionError("finalize_np ran in a world of 2")
            write_local_segments(counter, job["prefix"])
            dist.barrier()
            if rank == 0:
                assemble_db(job["prefix"], world, job["out"])
            dist.barrier()
        finally:
            shutdown_multihost()

    for job in json.load(open(sys.argv[3])):
        if job["kind"] == "api":
            api(job)
        elif main(job["argv"][rank], device="cpu") != 0:
            sys.exit(f"{job['name']} failed")
        print("DONE", job["name"], flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _records(path):
    with open(path, "rb") as f:
        f.seek(FileHeader.read(f).offset)
        return f.read()


def _table(path):
    from jellyfish_tpu_torch.io.files import DBReader

    with DBReader(str(path)) as r:
        return {m: c for m, c in r}


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}\n{s}\n")


def _jax_main(argv):
    from jellyfish_tpu.cli import main

    return main(argv)


def _launch(tmp, world, jobs):
    """Start `world` worker processes that run the jobs in turn (_wait
    collects them)."""
    script = tmp / "worker.py"
    script.write_text(WORKER)
    spec = tmp / f"jobs{world}.json"
    spec.write_text(json.dumps(jobs))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(spec)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]


def _wait(procs, timeout):
    """Each process's (stdout, stderr); every process is killed when they
    do not all end within `timeout` seconds, and each must exit 0."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    return outs


def _cli_job(name, tmp, per_rank, extra=()):
    """One count --coordinator run: rank r counts per_rank[r] (its files,
    and any flags of its own)."""
    port = _free_port()
    world = len(per_rank)
    out = str(tmp / f"{name}.jf")
    argv = [[*BASE, *extra, "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(world), "--process-id", str(r),
             "-o", out, *mine] for r, mine in enumerate(per_rank)]
    return {"name": name, "kind": "cli", "argv": argv, "out": out}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs of unequal volume (duplicated reads, so that -L 2 and --bc
    keep mers), the port's multi-process runs in a world of 2 and of 3,
    and the JAX references."""
    from jellyfish_tpu.bloom import load_count_filter
    from jellyfish_tpu.gf2 import GF2Matrix
    from jellyfish_tpu.counter import MerCounter
    from jellyfish_tpu.io.dumpers import dump_counter
    from jellyfish_tpu.io.parse import SequenceChunker
    from jellyfish_tpu.parallel import ShardedMerCounter, make_mesh

    tmp = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(2024)
    s0 = [random_dna(rng, 3000, with_n=True) for _ in range(3)]
    s1 = [random_dna(rng, 2000, with_n=True)]
    s2 = [random_dna(rng, 1500) for _ in range(2)]
    files = [str(tmp / f"in{i}.fa") for i in range(3)]
    for path, seqs in zip(files, (s0 + s0[:1], s1, s2 + s0[1:2])):
        _write_fasta(path, seqs)
    allow = [str(tmp / f"allow{i}.fa") for i in range(2)]
    _write_fasta(allow[0], [s0[0][:300], random_dna(rng, 200)])
    _write_fasta(allow[1], [s2[1][100:500]])
    bcf = str(tmp / "f.bc")
    assert _jax_main(["bc", "-m", str(K), "-s", "10k", "-C", "-o", bcf,
                      *files]) == 0
    two = [[files[0]], files[1:]]

    # the API run: 2 processes x 2 CPU shards, 3 steps and 1 step
    k, size, L = K, 1 << 12, 512
    matrix = GF2Matrix.random_invertible(12, 2 * k, np.random.default_rng(3))
    steps = {r: np.full((n, 2, L), ord("N"), dtype=np.uint8)
             for r, n in ((0, 3), (1, 1))}
    for st in steps.values():
        for c in st.reshape(-1, L):
            seq = random_dna(rng, L - 12, with_n=True).encode()
            c[:len(seq)] = np.frombuffer(seq, dtype=np.uint8)
    data = str(tmp / "api.npz")
    np.savez(data, r=matrix.r, c=matrix.c, columns=matrix.columns,
             rank0=steps[0], rank1=steps[1])
    api = {"name": "api", "kind": "api", "port": _free_port(), "k": k,
           "size": size, "data": data, "prefix": str(tmp / "api"),
           "out": str(tmp / "api.jf")}

    jobs2 = [
        api,
        _cli_job("plain2", tmp, two),
        _cli_job("lu", tmp, two, ["-L", "2", "-U", "3"]),
        _cli_job("text", tmp, two, ["--text"]),
        _cli_job("disk", tmp, two, DISK),
        _cli_job("nomerge", tmp, two, [*DISK, "--no-merge", "--no-unlink"]),
        _cli_job("if", tmp, [["--if", allow[0], files[0]],
                             ["--if", allow[1], *files[1:]]]),
        _cli_job("bc", tmp, two, ["--bc", bcf]),
        _cli_job("bf", tmp, two, ["--bf-size", "1M"]),
    ]
    jobs3 = [_cli_job("plain3", tmp, [[f] for f in files])]
    procs = _launch(tmp, 2, jobs2) + _launch(tmp, 3, jobs3)

    # the JAX references, while the workers run
    ref = {}

    def jax_count(name, *extra):
        out = str(tmp / f"jax_{name}.jf")
        assert _jax_main([*BASE, *extra, "-o", out, *files]) == 0
        ref[name] = out

    jax_count("plain")
    jax_count("lu", "-L", "2", "-U", "3")
    jax_count("text", "--text")
    jax_count("disk", "-s", "256")
    jax_count("if", "--if", allow[0], "--if", allow[1])
    jax_count("bc", "--bc", bcf)
    bf = ShardedMerCounter(
        K, 4096, mesh=make_mesh(1), canonical=True,
        rng=np.random.default_rng(SEED),
        mer_filter=load_count_filter(bf_size=1_000_000, k=K, canonical=True,
                                     rng=np.random.default_rng(5)))
    with SequenceChunker(files, K, int(CHUNK)) as ch:
        for chunk in ch.chunks():
            bf.add_chunks(chunk[None])
    ref["bf"] = str(tmp / "jax_bf.jf")
    dump_counter(bf, ref["bf"])
    api_ref = MerCounter(k, size=size, canonical=True, matrix=matrix)
    for st in steps.values():
        for c in st.reshape(-1, L):
            api_ref.add_chunk(c)
    ref["api"] = str(tmp / "jax_api.jf")
    dump_counter(api_ref, ref["api"])

    outs = _wait(procs, timeout=240)
    assert b"DONE plain3" in outs[2][0]
    jobs = {j["name"]: j for j in jobs2 + jobs3}
    return tmp, jobs, ref


def test_api_two_processes_two_shards(runs):
    """ShardedMerCounter with a gloo group: 2 processes x 2 CPU shards,
    3 steps on rank 0 (ASCII and packed) and 1 on rank 1, which then takes
    empty steps; write_local_segments, then rank 0's assemble_db."""
    _, jobs, ref = runs
    got = _records(jobs["api"]["out"])
    assert len(got) > 1000
    assert got == _records(ref["api"])


@pytest.mark.parametrize("name,want", [
    ("plain2", "plain"), ("plain3", "plain"), ("lu", "lu"), ("text", "text"),
    ("disk", "disk"), ("nomerge", "disk"), ("if", "if"), ("bc", "bc"),
])
def test_cli_matches_jax_single_process(runs, name, want):
    """2 and 3 processes with unequal inputs, -L/-U, --text, --disk (also
    with --no-merge --no-unlink), --if with other allow files on each
    rank (their union), and --bc: the JAX package's single-process count's
    records, byte for byte."""
    _, jobs, ref = runs
    got = _records(jobs[name]["out"])
    assert len(got) > 0
    assert got == _records(ref[want])


def test_disk_spills_per_rank_and_keeps_them(runs):
    """--disk -s 256 spills at least twice a rank, on the same steps on
    every rank; --no-unlink keeps each rank's spills and merged part, and
    --disk alone leaves none."""
    tmp, jobs, _ = runs
    prefix = jobs["nomerge"]["out"] + ".mh"
    spills = {r: sorted(tmp.glob(f"nomerge.jf.mh.spill*.rank{r}.jf"))
              for r in range(2)}
    assert len(spills[0]) >= 2
    assert len(spills[0]) == len(spills[1])
    for r in range(2):
        assert os.path.exists(f"{prefix}.rank{r}.jf")
    assert not list(tmp.glob("disk.jf.mh*"))
    assert not list(tmp.glob("plain2.jf.mh*"))


def test_bf_size_filters_at_finalize(runs):
    """--bf-size across 2 processes: the JAX finalize-mode records (each
    mer once, on its owner shard: its count less one), and that reference
    has no false positive."""
    _, jobs, ref = runs
    want = {m: c - 1 for m, c in _table(ref["plain"]).items() if c > 1}
    assert _table(ref["bf"]) == want
    assert len(want) > 100
    assert _records(jobs["bf"]["out"]) == _records(ref["bf"])


@pytest.mark.parametrize("flags,message", [
    (["--coordinator", "127.0.0.1:1"],
     "--coordinator requires --num-processes and --process-id"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2"],
     "--coordinator requires --num-processes and --process-id"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "2"], "--process-id 2 is not in [0, 2)"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "-1"], "--process-id -1 is not in [0, 2)"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "0",
      "--process-id", "0"], "--num-processes 0 is not positive"),
], ids=["no-num-processes", "no-process-id", "rank-too-large",
        "rank-negative", "no-processes"])
def test_flag_validation_dies_before_any_group(tmp_path, capsys, flags,
                                               message):
    fa = tmp_path / "x.fa"
    fa.write_text(">a\nACGTACGTACGTACGTACGTACGT\n")
    with pytest.raises(SystemExit) as e:
        torch_main([*BASE, *flags, "-o", str(tmp_path / "o.jf"), str(fa)],
                   device="cpu")
    assert e.value.code not in (0, None)
    assert message in capsys.readouterr().err
    assert not dist.is_initialized()


def test_peer_that_never_arrives_raises():
    """A group whose second rank never joins ends with an error, and
    leaves no group behind."""
    from jellyfish_tpu_torch.parallel.multihost import init_multihost

    with pytest.raises(dist.DistStoreError):
        init_multihost(f"127.0.0.1:{_free_port()}", 2, 0, device="cpu",
                       timeout_s=1)
    assert not dist.is_initialized()


@pytest.fixture
def seeded(monkeypatch):
    """numpy.random.default_rng() without a seed gives a seeded generator
    in both packages, so their --bf-size filters match."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(777 if seed is None else seed))


@pytest.mark.parametrize("extra", [[], ["--bf-size", "1M"], ["--if", None]],
                         ids=["plain", "bf-size", "if"])
def test_world_of_one_matches_jax(runs, seeded, tmp_path, extra):
    """A world of 1 in this process, through the collectives: the JAX
    single-process count's records; --bf-size filters on the sender in
    stream order, as one device does."""
    tmp, _, _ = runs
    files = [str(tmp / f"in{i}.fa") for i in range(3)]
    extra = [str(tmp / "allow0.fa") if x is None else x for x in extra]
    out_t, out_j = str(tmp_path / "t.jf"), str(tmp_path / "j.jf")
    assert torch_main([*BASE, *extra, "--coordinator",
                       f"127.0.0.1:{_free_port()}", "--num-processes", "1",
                       "--process-id", "0", "-o", out_t, *files],
                      device="cpu") == 0
    assert not dist.is_initialized()
    assert _jax_main([*BASE, *extra, "-o", out_j, *files]) == 0
    assert len(_records(out_t)) > 0
    assert _records(out_t) == _records(out_j)


@pytest.mark.parametrize("fn", ["assemble_db_full_parts", "assemble_db"])
def test_assembly_matches_jax(tmp_path, fn):
    """The assembly functions write the JAX package's bytes from the same
    files: standalone databases, or a header and raw segments."""
    import jellyfish_tpu.parallel.multihost as jmh

    import jellyfish_tpu_torch.parallel.multihost as tmh

    rng = np.random.default_rng(11)
    parts = []
    for r in range(3):
        fa = tmp_path / f"p{r}.fa"
        _write_fasta(fa, [random_dna(rng, 600)])
        db = str(tmp_path / f"p{r}.jf")
        assert torch_main([*BASE, "-o", db, str(fa)], device="cpu") == 0
        parts.append(db)
    if fn == "assemble_db_full_parts":
        args_t = (parts, str(tmp_path / "t.jf"))
        args_j = (parts, str(tmp_path / "j.jf"))
    else:
        prefix = str(tmp_path / "seg")
        with open(parts[0], "rb") as f, open(prefix + ".header", "wb") as g:
            h = FileHeader.read(f)
            f.seek(0)
            g.write(f.read(h.offset))
        for r, db in enumerate(parts):
            with open(f"{prefix}.part{r}", "wb") as g:
                g.write(_records(db))
        args_t = (prefix, 3, str(tmp_path / "t.jf"))
        args_j = (prefix, 3, str(tmp_path / "j.jf"))
    getattr(tmh, fn)(*args_t)
    getattr(jmh, fn)(*args_j)
    with open(tmp_path / "t.jf", "rb") as f, open(tmp_path / "j.jf",
                                                  "rb") as g:
        got, want = f.read(), g.read()
    assert got == want
    assert _records(tmp_path / "t.jf") == b"".join(_records(p) for p in parts)


@pytest.mark.slow
def test_jax_two_process_cli_beside_the_port(tmp_path):
    """The JAX package's own 2-process CLI (gloo, 4 virtual CPU devices a
    process) and the port's 2-process CLI on the same inputs write the
    same records."""
    rng = np.random.default_rng(1234)
    files = []
    for r, n in ((0, 3), (1, 1)):
        path = tmp_path / f"in{r}.fa"
        _write_fasta(path, [random_dna(rng, 3000, with_n=True)
                            for _ in range(n)])
        files.append(str(path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    jenv = dict(env, JF_MH_PLATFORM="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jenv.pop("JAX_PLATFORMS", None)
    # the port's CLI runs on the card unless its caller asks for the CPU
    runners = {
        "jax": ([sys.executable, "-m", "jellyfish_tpu"], jenv),
        "port": ([sys.executable, "-c",
                  "import sys; from jellyfish_tpu_torch.cli import main; "
                  "sys.exit(main(sys.argv[1:], device='cpu'))"], env),
    }
    outs = {}
    for name, (cmd, e) in runners.items():
        port = _free_port()
        out = str(tmp_path / f"{name}.jf")
        procs = [subprocess.Popen(
            [*cmd, *BASE, "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(r), "-o", out,
             files[r]], env=e, cwd=tmp_path, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for r in range(2)]
        _wait(procs, timeout=600)
        outs[name] = _records(out)
    assert len(outs["jax"]) > 0
    assert outs["jax"] == outs["port"]
