"""The native host library of jellyfish_tpu_torch (native/chunker.cpp,
native/jfquery.cpp) on the CPU.

- The native scanner's chunks are the python path's, byte for byte, and
  the JAX package's: FASTA, DOS line endings, FASTQ, the quality mask,
  several files, and the structured fuzz of tests/test_native.py.
- jf_pack_chunk is the numpy packer; the native BAM parser is the python
  loop, malformed and truncated files included.
- -F: count -F 3 of 6 files writes the -F 1 records and the JAX
  package's; bc -F 3 its Bloom counter; generator children end, and a
  worker's error reaches the caller.
- The library builds into build/jellyfish_tpu_torch/, and two processes
  that build it at once both load it.
- libjfquery answers the port's query, and its Makefile installs it.
- The sanitizer build of the decoders (slow, as tests/test_asan.py).
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.conftest import random_dna

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def lib():
    from jellyfish_tpu_torch.native import build_error, get_lib

    assert not os.environ.get("JF_NO_NATIVE")
    lib = get_lib()
    assert lib is not None, build_error()
    return lib


def _chunks(pkg, paths, k, chunk_len, native, **kw):
    """(chunk bytes, reads) of `pkg`'s SequenceChunker, native or not."""
    import importlib

    parse = importlib.import_module(f"{pkg}.io.parse")
    old = os.environ.pop("JF_NO_NATIVE", None)
    if not native:
        os.environ["JF_NO_NATIVE"] = "1"
    try:
        ch = parse.SequenceChunker(paths, k, chunk_len, **kw)
        out = [c.tobytes() for c in ch.chunks()]
        return out, ch.reads
    finally:
        os.environ.pop("JF_NO_NATIVE", None)
        if old is not None:
            os.environ["JF_NO_NATIVE"] = old


def _all_paths_equal(paths, k, chunk_len, **kw):
    """The port's native and python chunks and the JAX package's native
    and python chunks are the same bytes, and count the same reads."""
    runs = [_chunks(pkg, paths, k, chunk_len, native, **kw)
            for pkg in ("jellyfish_tpu_torch", "jellyfish_tpu")
            for native in (True, False)]
    for r in runs[1:]:
        assert r == runs[0]
    return runs[0]


def _write_fasta(path, seqs, line_len=60, dos=False):
    eol = "\r\n" if dos else "\n"
    with open(path, "w", newline="") as f:
        for i, s in enumerate(seqs):
            f.write(f">r{i}{eol}")
            for j in range(0, len(s), line_len):
                f.write(s[j:j + line_len] + eol)


def _write_fastq(path, seqs, quals):
    with open(path, "w") as f:
        for i, (s, q) in enumerate(zip(seqs, quals)):
            f.write(f"@r{i}\n{s}\n+\n{q}\n")


def _quals(rng, seqs):
    return ["".join(chr(int(x)) for x in rng.integers(66, 107, len(s)))
            for s in seqs]


@pytest.mark.parametrize("case", ["fasta", "fasta-dos", "fastq",
                                  "fastq-mask", "multi-file"])
def test_native_chunks_match_python_and_jax(lib, tmp_path, rng, case):
    """Chunks of FASTA (with N, at three chunk lengths), DOS line endings,
    FASTQ, FASTQ under a quality threshold, and two files in a row."""
    if case == "fasta":
        seqs = [random_dna(rng, n, with_n=True)
                for n in (37, 200, 61, 1000, 5)]
        _write_fasta(tmp_path / "a.fa", seqs)
        for chunk_len in (64, 256, 4096):
            _, reads = _all_paths_equal([str(tmp_path / "a.fa")], 21,
                                        chunk_len)
            assert reads == len(seqs)
    elif case == "fasta-dos":
        _write_fasta(tmp_path / "d.fa", [random_dna(rng, 300)
                                         for _ in range(3)], 50, dos=True)
        _all_paths_equal([str(tmp_path / "d.fa")], 15, 128)
    elif case.startswith("fastq"):
        seqs = [random_dna(rng, n) for n in (80, 150, 33, 200)]
        _write_fastq(tmp_path / "q.fq", seqs, _quals(rng, seqs))
        kw = {"min_qual": 80} if case == "fastq-mask" else {}
        chunks, _ = _all_paths_equal([str(tmp_path / "q.fq")], 11, 256,
                                     **kw)
        masked = sum(c.count(b"N") for c in chunks)
        assert (masked > 100) == (case == "fastq-mask")
    else:
        for i, n in enumerate((3, 2)):
            _write_fasta(tmp_path / f"{i}.fa",
                         [random_dna(rng, 120) for _ in range(n)])
        _, reads = _all_paths_equal(
            [str(tmp_path / "0.fa"), str(tmp_path / "1.fa")], 17, 100)
        assert reads == 5


@pytest.mark.parametrize("seed", [11, 22, 33, 44])
def test_structured_fuzz_matches_python_and_jax(lib, tmp_path, seed):
    """tests/test_native.py's fuzz: random record shapes, empty
    sequences, stray blank lines, mixed DOS endings, lowercase and
    ambiguity codes, ragged FASTQ records."""
    frng = np.random.default_rng(seed)
    alpha = np.array(list("ACGTNacgtnRYKM"), dtype="U1")

    def rand_seq(n):
        return "".join(frng.choice(alpha, size=n))

    fa = tmp_path / "fuzz.fa"
    with open(fa, "w", newline="") as f:
        for i in range(int(frng.integers(3, 12))):
            eol = ["\n", "\r\n"][int(frng.integers(0, 2))]
            f.write(f">rec{i} desc{eol}")
            s = rand_seq(int(frng.integers(0, 300)))
            line_len = int(frng.integers(1, 80))
            for j in range(0, len(s), line_len):
                f.write(s[j:j + line_len] + eol)
            if frng.random() < 0.3:
                f.write(eol)
    fq = tmp_path / "fuzz.fq"
    with open(fq, "w") as f:
        for i in range(int(frng.integers(3, 10))):
            n = int(frng.integers(0, 150))
            q = "".join(chr(int(x)) for x in frng.integers(33, 74, size=n))
            f.write(f"@r{i}\n{rand_seq(n)}\n+\n{q}\n")
    k = int(frng.integers(3, 32))
    chunk_len = int(frng.integers(64, 4096))
    for paths, kw in (([str(fa)], {}), ([str(fq)], {}),
                      ([str(fq)], {"min_qual": 40}),
                      ([str(fa), str(fq)], {})):
        _all_paths_equal(paths, k, chunk_len, **kw)


def test_pack_chunk_native_matches_numpy(lib, monkeypatch):
    """jf_pack_chunk and the numpy packer give the same words, on ACGT in
    both cases, N, IUPAC codes and arbitrary bytes."""
    from jellyfish_tpu_torch.io import parse
    from jellyfish_tpu_torch.native import pack_chunk

    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACGTacgtNnRY\x00\xff-.", np.uint8)
    for L in (32, 1024, 1 << 16):
        chunk = alpha[rng.integers(0, len(alpha), L)]
        got = pack_chunk(chunk)
        assert got[0].dtype == np.uint32 and len(got[0]) == L // 16
        monkeypatch.setenv("JF_NO_NATIVE", "1")
        want = parse.pack_chunk(chunk)
        monkeypatch.delenv("JF_NO_NATIVE")
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert all(np.array_equal(a, b)
                   for a, b in zip(parse.pack_chunk(chunk), want))


def _bam_outcome(path, native):
    from jellyfish_tpu_torch.io.parse import open_stream, sam_records_to_fastx

    old = os.environ.pop("JF_NO_NATIVE", None)
    if not native:
        os.environ["JF_NO_NATIVE"] = "1"
    try:
        with open_stream(str(path)) as f:
            return b"".join(sam_records_to_fastx(f))
    except Exception as e:  # noqa: BLE001 - compared across paths
        return (type(e).__name__, str(e))
    finally:
        os.environ.pop("JF_NO_NATIVE", None)
        if old is not None:
            os.environ["JF_NO_NATIVE"] = old


@pytest.mark.parametrize("case", ["valid", "malformed", "truncated"])
def test_native_bam_matches_python(lib, tmp_path, case):
    """jf_bam_records over 4 MB windows gives the python loop's records;
    on a malformed record the python loop takes over from the window's
    first record and raises its error, as it does alone; a file cut in a
    record raises the python loop's error."""
    from test_torch_sam import _write_bam

    rng = np.random.default_rng(8)
    n = 9000 if case == "valid" else 300
    seqs = [random_dna(rng, int(x), with_n=True)
            for x in rng.integers(300, 600, n)]
    quals = [None if i % 3 == 0 else rng.integers(0, 70, len(s)).tolist()
             for i, s in enumerate(seqs)]
    bam = tmp_path / "x.bam"
    _write_bam(bam, seqs, quals)
    if case != "valid":
        import gzip

        data = bytearray(gzip.decompress(bam.read_bytes()))
        # the first record starts after the magic, the header text length
        # (0), the reference count (1) and one reference (4+4+4 bytes)
        first = 4 + 4 + 4 + 12
        second = first + 4 + int.from_bytes(data[first:first + 4], "little")
        if case == "malformed":
            data[second:second + 4] = (8).to_bytes(4, "little")
        else:
            del data[-100:]
        bam.write_bytes(gzip.compress(bytes(data)))
    got = _bam_outcome(bam, native=True)
    assert got == _bam_outcome(bam, native=False)
    if case == "valid":
        assert len(got) > (1 << 22)
    else:
        assert isinstance(got, tuple)


@pytest.fixture
def six_files(tmp_path):
    rng = np.random.default_rng(606)
    paths = []
    for i in range(6):
        p = tmp_path / f"f{i}.fa"
        _write_fasta(p, [random_dna(rng, int(n))
                         for n in rng.integers(50, 400, 8)])
        paths.append(str(p))
    return paths


def _records(p):
    from jellyfish_tpu_torch.io.header import FileHeader

    with open(p, "rb") as f:
        f.seek(FileHeader.read(f).offset)
        return f.read()


def test_count_F_matches_serial_and_jax(lib, six_files, tmp_path,
                                        monkeypatch):
    """count -F 3 of 6 files through the CLI: the records of -F 1 and of
    the JAX package's count; the chunker ran 3 native workers."""
    from jellyfish_tpu.cli import main as jax_main

    from jellyfish_tpu_torch.cli import main
    from jellyfish_tpu_torch.io import parse

    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    workers = []
    real = parse.SequenceChunker._chunks_native_concurrent

    def spy(self, n_workers):
        workers.append(n_workers)
        return real(self, n_workers)

    monkeypatch.setattr(parse.SequenceChunker, "_chunks_native_concurrent",
                        spy)
    common = ["count", "-m", "19", "-s", "4k", "-C", "--matrix-seed", "2",
              "--chunk-len", "512"]
    outs = {}
    for name, flags in (("F3", ["-F", "3"]), ("F1", ["-F", "1"])):
        outs[name] = tmp_path / f"{name}.jf"
        assert main([*common, *flags, "-o", str(outs[name]), *six_files],
                    device="cpu") == 0
    assert workers == [3]
    assert jax_main([*common, "-o", str(tmp_path / "j.jf"),
                     *six_files]) == 0
    got = _records(outs["F3"])
    assert len(got) > 1000
    assert got == _records(outs["F1"]) == _records(tmp_path / "j.jf")


def test_bc_F_matches_serial(lib, six_files, tmp_path, monkeypatch):
    """bc -F 3 of 6 files writes the Bloom counter of bc -F 1 (the same
    seeded matrices)."""
    from jellyfish_tpu_torch.cli import main

    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(777 if seed is None else seed))
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    got = []
    for f in ("3", "1"):
        out = tmp_path / f"r{f}.bc"
        assert main(["bc", "-m", "17", "-s", "10k", "-C", "-F", f,
                     "--chunk-len", "512", "-o", str(out), *six_files],
                    device="cpu") == 0
        got.append(_records(out))
    assert got[0] == got[1] and any(got[0])


def _gen_cmds(fail=False):
    cmds = [f"printf '>g{i}\\nACGTTGCAACGTAGGCTAGCTAAC{i}\\n'"
            for i in range(4)]
    if fail:
        cmds[2] = "printf '>x\\nACGT\\n'; exit 3"
    return cmds


def test_F_with_generators(lib, six_files):
    """-F 2 over files and 4 generator commands (-G 2): the mers of -F 1;
    every child is reaped. A child that exits nonzero raises
    RuntimeError from the chunks, and no child outlives close()."""
    from jellyfish_tpu_torch.io.parse import SequenceChunker
    from jellyfish_tpu_torch.mer import string_mers

    def mers(nb_files, cmds):
        ch = SequenceChunker(six_files[:2], 13, 256, generator_cmds=cmds,
                             nb_generators=2, nb_files=nb_files)
        with ch:
            got = {}
            for c in ch.chunks():
                for m in string_mers(c.tobytes().decode(), 13):
                    got[m.bits] = got.get(m.bits, 0) + 1
            assert not ch._procs
        return got, ch.reads

    cmds = _gen_cmds()
    assert mers(2, cmds) == mers(1, cmds)
    assert mers(2, cmds)[1] == 16 + 4
    bad = _gen_cmds(fail=True)
    ch = SequenceChunker(six_files[:2], 13, 256, generator_cmds=bad,
                         nb_generators=2, nb_files=2)
    with ch, pytest.raises(RuntimeError, match="status 3"):
        list(ch.chunks())
    assert not ch._procs


def test_F_stress_many_workers(lib, tmp_path):
    """-F 16 over 24 files, more workers than cores, with the interpreter
    switching threads every microsecond: every read is counted once and
    the mers are those of -F 1."""
    from jellyfish_tpu_torch.io.parse import SequenceChunker
    from jellyfish_tpu_torch.mer import string_mers

    rng = np.random.default_rng(24)
    paths = []
    for i in range(24):
        paths.append(str(tmp_path / f"s{i}.fa"))
        _write_fasta(paths[-1], [random_dna(rng, int(n))
                                 for n in rng.integers(20, 300, 7)])

    def mers(nb_files):
        with SequenceChunker(paths, 9, 128, nb_files=nb_files) as ch:
            got = {}
            for c in ch.chunks():
                for m in string_mers(c.tobytes().decode(), 9):
                    got[m.bits] = got.get(m.bits, 0) + 1
            return got, ch.reads

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        many = mers(16)
    finally:
        sys.setswitchinterval(old)
    assert many == mers(1)
    assert many[1] == 24 * 7


def test_F_consumer_stops_early(lib):
    """A consumer that stops after the first chunk of -F 2 ends the
    workers and the generator children still writing."""
    import threading

    from jellyfish_tpu_torch.io.parse import SequenceChunker

    cmds = ["printf '>a\\n'; yes ACGTACGTACGTACGTACGTTTGACA | head -n 2000000"
            ] * 3
    before = set(threading.enumerate())
    ch = SequenceChunker([], 13, 4096, generator_cmds=cmds, nb_generators=3,
                         nb_files=2)
    with ch:
        gen = ch.chunks()
        assert len(next(gen)) == 4096
        gen.close()
    assert not ch._procs
    assert not set(threading.enumerate()) - before


def test_library_builds_once_into_build_dir(lib, tmp_path):
    """The library loads from build/jellyfish_tpu_torch/ at the
    repository root, never from the JAX package's tree; two processes that
    build a fresh copy at once both load it, and no temp file is left."""
    from jellyfish_tpu_torch.native import LIB_PATH

    assert LIB_PATH == ROOT / "build" / "jellyfish_tpu_torch" / "libjfnative.so"
    assert lib._name == str(LIB_PATH)
    code = (
        "import sys, time\n"
        "from pathlib import Path\n"
        "import jellyfish_tpu_torch.native as n\n"
        "d = Path(sys.argv[1])\n"
        "n.BUILD_DIR, n.LIB_PATH = d, d / 'libjfnative.so'\n"
        "while time.time() < float(sys.argv[2]):\n"
        "    time.sleep(0.01)\n"
        "lib = n.get_lib()\n"
        "assert lib is not None, n.build_error()\n"
        "print(lib._name)\n"
    )
    import time

    start = str(time.time() + 3)
    env = {k: v for k, v in os.environ.items() if k != "JF_NO_NATIVE"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path),
                               start], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == str(tmp_path / "libjfnative.so")
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "libjfnative.so", "libjfnative.so.lock"]


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    from jellyfish_tpu_torch.cli import main

    d = tmp_path_factory.mktemp("jfq")
    rng = np.random.default_rng(2718281828)
    seqs = [random_dna(rng, 400, with_n=True) for _ in range(20)]
    fa = d / "in.fa"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    out = d / "out.jf"
    assert main(["count", "-m", "17", "-s", "4k", "-C", "-o", str(out),
                 str(fa)], device="cpu") == 0
    return {"path": str(out), "k": 17, "seqs": seqs}


def _jfquery():
    from jellyfish_tpu_torch.native import JFQUERY_PATH, build_jfquery

    so = build_jfquery()
    assert so == str(JFQUERY_PATH)
    lq = ctypes.CDLL(so)
    lq.jf_query_open.restype = ctypes.c_void_p
    lq.jf_query_open.argtypes = [ctypes.c_char_p]
    lq.jf_query_close.argtypes = [ctypes.c_void_p]
    lq.jf_query_error.restype = ctypes.c_char_p
    lq.jf_query_k.restype = ctypes.c_uint
    lq.jf_query_k.argtypes = [ctypes.c_void_p]
    lq.jf_query_nb_records.restype = ctypes.c_uint64
    lq.jf_query_nb_records.argtypes = [ctypes.c_void_p]
    lq.jf_query_mer.restype = ctypes.c_int64
    lq.jf_query_mer.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lq.jf_query_record.restype = ctypes.c_int
    lq.jf_query_record.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_uint64)]
    return lq


def test_jfquery_matches_port_query(db, tmp_path):
    """libjfquery, built into build/jellyfish_tpu_torch/: its records are
    the port's ReadMerFile's, and its counts of the input's mers (either
    strand) and of random mers are the port's `query`'s."""
    from jellyfish_tpu_torch.api import ReadMerFile
    from jellyfish_tpu_torch.cli import main
    from jellyfish_tpu_torch.mer import MerDNA, string_mers

    lq = _jfquery()
    q = lq.jf_query_open(db["path"].encode())
    assert q, lq.jf_query_error().decode()
    try:
        assert lq.jf_query_k(q) == db["k"]
        recs = [(str(m), c) for m, c in ReadMerFile(db["path"])]
        assert lq.jf_query_nb_records(q) == len(recs) > 100
        buf = ctypes.create_string_buffer(db["k"] + 1)
        cnt = ctypes.c_uint64()
        for i, want in enumerate(recs):
            assert lq.jf_query_record(q, i, buf, ctypes.byref(cnt))
            assert (buf.value.decode(), cnt.value) == want
        probes = [str(m) for s in db["seqs"][:3]
                  for m in string_mers(s, db["k"])]
        probes += [str(MerDNA(db["k"], int(b))) for b in
                   np.random.default_rng(1).integers(0, 1 << 34, 100)]
        out = tmp_path / "q.txt"
        assert main(["query", "-o", str(out), db["path"], *probes],
                    device="cpu") == 0
        want = [line.split() for line in out.read_text().splitlines()]
        got = [[m, str(lq.jf_query_mer(q, m.encode()))] for m in probes]
        assert got == want
        assert sum(int(c) > 0 for _, c in got) > 100
        assert lq.jf_query_mer(q, b"ACGT") == -1
    finally:
        lq.jf_query_close(q)


def test_jfquery_makefile_installs(tmp_path):
    """make -C jellyfish_tpu_torch/native install: the library, its
    header and a pkg-config file naming the prefix; the build goes to
    BUILD, never beside the source."""
    if shutil.which("make") is None:
        pytest.skip("make is not installed")
    src = ROOT / "jellyfish_tpu_torch" / "native"

    def files():
        return sorted(p.name for p in src.iterdir()
                      if p.name != "__pycache__")

    before = files()
    r = subprocess.run(["make", "-s", "-C", str(src), "install",
                        f"BUILD={tmp_path / 'b'}",
                        f"PREFIX={tmp_path / 'prefix'}"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    pre = tmp_path / "prefix"
    assert (pre / "lib" / "libjfquery.so").exists()
    assert (pre / "include" / "jfquery.h").exists()
    pc = (pre / "lib" / "pkgconfig" / "jfquery.pc").read_text()
    assert f"prefix={pre}" in pc and "-ljfquery" in pc
    assert files() == before


CHILD_SCRIPT = r"""
import ctypes, random, sys

lib = ctypes.CDLL(sys.argv[1])
for fn in ("jf_rans_decode", "jf_rans16_decode", "jf_arith_decode",
           "jf_fqz_decode", "jf_tok3_decode"):
    f = getattr(lib, fn)
    f.restype = ctypes.c_long
    f.argtypes = [ctypes.c_char_p, ctypes.c_long,
                  ctypes.c_void_p, ctypes.c_long]

sys.path.insert(0, %(repo)r)
import os
os.environ["JF_NO_NATIVE"] = "1"   # the encoders stay pure python
from jellyfish_tpu_torch.io import arith, fqzcomp, rans, rans16, tok3

rng = random.Random(20260818)
raw = bytes(rng.choices(b"ACGTN!#%%+5?I", k=4000))
blobs = [("jf_rans_decode", rans.encode(raw, 1), len(raw))]
for fl in (0, rans16.F_ORDER1, rans16.F_PACK | rans16.F_RLE,
           rans16.F_ORDER1 | rans16.F_N32, rans16.F_STRIPE):
    blobs.append(("jf_rans16_decode", rans16.encode(raw, fl), len(raw)))
for fl in (0, arith.F_ORDER1 | arith.F_RLE, arith.F_PACK):
    blobs.append(("jf_arith_decode", arith.encode(raw, fl), len(raw)))
quals = bytes(rng.choices(b"ABCDEFGHI", k=2000))
blobs.append(("jf_fqz_decode",
              fqzcomp.encode([100] * 20, quals,
                             pflags=fqzcomp.P_DO_LEN | fqzcomp.P_HAVE_QMAP
                             | fqzcomp.P_HAVE_PTAB | fqzcomp.P_HAVE_DTAB
                             | fqzcomp.P_HAVE_QTAB),
              len(quals)))
names = b"".join(b"r%%05d:%%d\x00" %% (i, i * 7) for i in range(200))
blobs.append(("jf_tok3_decode", tok3.encode(names), len(names)))

for fn, blob, out_len in blobs:
    f = getattr(lib, fn)
    buf = ctypes.create_string_buffer(out_len)
    assert f(blob, len(blob), buf, out_len) == out_len, fn
    for trial in range(300):
        mut = bytearray(blob)
        op = rng.randrange(4)
        if op == 0:
            mut[rng.randrange(len(mut))] ^= 1 << rng.randrange(8)
        elif op == 1:
            del mut[rng.randrange(len(mut)):]
        elif op == 2:
            mut += bytes(rng.randrange(256)
                         for _ in range(rng.randrange(1, 16)))
        else:
            for _ in range(rng.randrange(2, 8)):
                mut[rng.randrange(len(mut))] = rng.randrange(256)
        buf = ctypes.create_string_buffer(out_len)
        f(bytes(mut), len(mut), buf, out_len)  # must not fault
print("ASAN_CHILD_OK")
"""


@pytest.mark.slow
def test_native_decoders_under_asan(tmp_path):
    """The port's chunker.cpp built with AddressSanitizer and
    UndefinedBehaviorSanitizer: its five decoders over valid blobs and 300
    mutations each, in a child process that any fault aborts."""
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    so = tmp_path / "libjfnative_asan.so"
    build = subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-shared", "-fPIC",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         str(ROOT / "jellyfish_tpu_torch" / "native" / "chunker.cpp"),
         "-o", str(so)], capture_output=True, text=True)
    if build.returncode != 0:
        pytest.skip(f"sanitizer build unavailable: {build.stderr[:200]}")
    libasan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True).stdout.strip()
    if not libasan or not os.path.exists(libasan):
        pytest.skip("libasan not found")
    script = tmp_path / "child.py"
    script.write_text(CHILD_SCRIPT % {"repo": str(ROOT)})
    env = dict(os.environ, LD_PRELOAD=libasan,
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1")
    res = subprocess.run([sys.executable, str(script), str(so)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
    assert "ASAN_CHILD_OK" in res.stdout
