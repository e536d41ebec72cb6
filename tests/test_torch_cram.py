"""CRAM input of jellyfish_tpu_torch (io/cram.py and its codecs io/rans.py,
io/rans16.py, io/arith.py, io/tok3.py, io/fqzcomp.py) against the JAX
package on the CPU, on the native path and under JF_NO_NATIVE=1.

- Codecs: blobs the JAX package encoded from seeded inputs decode to the
  JAX package's output, the port's encoders give the JAX package's bytes,
  and mutated or truncated blobs end as the JAX package's decode does:
  the same bytes, or the same exception type and message.
- Files (tests/cram_writer.py): unmapped and mapped records with an
  embedded, external (JF_CRAM_REF, UR:, an M5 cache) or absent
  reference, the CRAM 2.1, 3.0 and 3.1 method matrices, multi-slice and
  multi-container layouts, the slice thread pool, the quality-free mode,
  and corrupt files: cram_records_to_fastx yields the JAX package's
  bytes or raises its error.
- CLI: count --sam of a CRAM writes the JAX package's records at k = 21,
  at k = 63 (K3's route) and with -d 2, with and without -Q.
"""

import io
import random

import numpy as np
import pytest
import torch

import cram_writer as cw
from cram_writer import (Beta, ByteArrayStop, External, Gamma, Huffman,
                         SubExp, ext_array, fqz_method, simple_cram)

torch.set_num_threads(1)


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    """Run the test on the native library, then under JF_NO_NATIVE=1."""
    from jellyfish_tpu_torch.native import build_error, get_lib

    if request.param == "python":
        monkeypatch.setenv("JF_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("JF_NO_NATIVE", raising=False)
        assert get_lib() is not None, build_error()
    return request.param


def _outcome(fn, *args, **kw):
    """fn's result, or its exception as (type name, message)."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, str(e))


def _decode(pkg, blob, need_quals=True):
    """The FASTA/FASTQ bytes of a CRAM blob through `pkg`'s reader."""
    import importlib

    cram = importlib.import_module(f"{pkg}.io.cram")
    stream = io.BytesIO(blob)
    assert stream.read(4) == b"CRAM"
    return b"".join(cram.cram_records_to_fastx(stream,
                                               need_quals=need_quals))


def _same(blob, need_quals=True):
    """The port's bytes, or its error, are the JAX package's; returns
    them."""
    got = _outcome(_decode, "jellyfish_tpu_torch", blob, need_quals)
    want = _outcome(_decode, "jellyfish_tpu", blob, need_quals)
    assert got == want
    return got


# -- codecs -------------------------------------------------------------------


def _corpus(seed):
    rng = np.random.default_rng(seed)
    return [
        b"",
        b"A",
        b"ACGT" * 75,
        bytes([7]) * 333,
        bytes(range(256)),
        np.frombuffer(b"ACGTN", np.uint8)[
            rng.choice(5, 3000, p=[0.3, 0.25, 0.25, 0.15, 0.05])].tobytes(),
        np.frombuffer(b"!#%+5?I", np.uint8)[rng.integers(0, 7, 1500)]
        .tobytes(),
        rng.integers(0, 256, 1025, dtype=np.uint8).tobytes(),
    ]


def _names(seed, n=60):
    rng = np.random.default_rng(seed)
    return b"".join(b"read%05d.%d:%d\x00" % (i, int(rng.integers(0, 9)),
                                             int(rng.integers(0, 999)))
                    for i in range(n))


def _quals(seed, nrec=24):
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(30, 90, nrec)]
    steps = rng.choice([-1, 0, 0, 1], size=sum(lens))
    q = np.clip(35 + np.cumsum(steps), 30, 40) + 33
    return lens, q.astype(np.uint8).tobytes()


def _codec_cases(pkg):
    """(codec, label, encoder, raw, decoder) of every codec at its flag
    settings, from `pkg`'s modules."""
    import importlib

    rans = importlib.import_module(f"{pkg}.io.rans")
    r16 = importlib.import_module(f"{pkg}.io.rans16")
    ar = importlib.import_module(f"{pkg}.io.arith")
    tok3 = importlib.import_module(f"{pkg}.io.tok3")
    fqz = importlib.import_module(f"{pkg}.io.fqzcomp")
    cases = []
    for i, raw in enumerate(_corpus(11)):
        for order in (0, 1):
            cases.append(("rans", f"rans{order}/{i}",
                          lambda r=raw, o=order: rans.encode(r, o),
                          raw, lambda b, n: rans.decode(b)))
        for flags in (0, r16.F_ORDER1, r16.F_N32, r16.F_ORDER1 | r16.F_N32,
                      r16.F_CAT, r16.F_RLE, r16.F_PACK,
                      r16.F_PACK | r16.F_RLE | r16.F_ORDER1, r16.F_STRIPE,
                      r16.F_NOSZ):
            cases.append(("rans16", f"rans16-{flags:#x}/{i}",
                          lambda r=raw, f=flags: r16.encode(r, f),
                          raw, r16.decode))
        for flags in (0, ar.F_ORDER1, ar.F_RLE, ar.F_ORDER1 | ar.F_RLE,
                      ar.F_CAT, ar.F_EXT, ar.F_PACK, ar.F_STRIPE,
                      ar.F_NOSZ):
            cases.append(("arith", f"arith-{flags:#x}/{i}",
                          lambda r=raw, f=flags: ar.encode(r, f),
                          raw, ar.decode))
    for seed, n in ((5, 60), (6, 200), (7, 3)):
        for use_arith in (False, True):
            raw = _names(seed, n)
            cases.append(("tok3", f"tok3-{seed}-{use_arith}",
                          lambda r=raw, a=use_arith: tok3.encode(r, a),
                          raw, tok3.decode))
    lens, quals = _quals(6)
    for j, kw in enumerate([
            dict(),
            dict(pflags=fqz.P_DO_LEN | fqz.P_HAVE_QMAP),
            dict(pflags=(fqz.P_DO_LEN | fqz.P_HAVE_QMAP | fqz.P_HAVE_PTAB
                         | fqz.P_HAVE_DTAB | fqz.P_HAVE_QTAB)),
            dict(nparam=3),
            dict(do_rev=[i % 3 == 0 for i in range(len(lens))]),
            dict(pflags=fqz.P_DO_LEN | fqz.P_DO_DEDUP)]):
        cases.append(("fqz", f"fqz/{j}",
                      lambda kw=kw: fqz.encode(lens, quals, **kw),
                      quals, fqz.decode))
    return cases


def _encode(enc):
    try:
        return enc()
    except ValueError:
        return None  # unsatisfiable flags (PACK over > 16 symbols, ...)


def _mutants(blob, rng, n, keep=0):
    """n copies of blob, each with a bit flipped past its first `keep`
    bytes, cut short, or lengthened."""
    for _ in range(n):
        mut = bytearray(blob)
        op = int(rng.integers(0, 3))
        if op == 0 and len(mut) > keep:
            mut[int(rng.integers(keep, len(mut)))] ^= 1 << int(
                rng.integers(8))
        elif op == 1 and mut:
            del mut[int(rng.integers(0, len(mut))):]
        else:
            mut += rng.integers(0, 256, int(rng.integers(1, 9)),
                                dtype=np.uint8).tobytes()
        yield bytes(mut)


@pytest.mark.parametrize("codec", ["rans", "rans16", "arith", "tok3",
                                   "fqz"])
def test_codecs_match_jax(path, codec):
    """Each codec: the port encodes the JAX package's bytes, decodes the
    JAX package's blobs to the input, and ends on mutated blobs as the
    JAX package's decoder does."""
    ours = [c[1:] for c in _codec_cases("jellyfish_tpu_torch")
            if c[0] == codec]
    theirs = {c[1]: c[2:] for c in _codec_cases("jellyfish_tpu")}
    assert len(ours) >= 6
    rng = np.random.default_rng(len(codec))
    # a rANS 4x8 block states its own sizes in its first 9 bytes: a flip
    # there asks either decoder for up to 4 GiB
    keep = 9 if codec == "rans" else 0
    mutated = 0
    for label, enc, raw, dec in ours:
        blob = _encode(enc)
        jblob = _encode(theirs[label][0])
        assert blob == jblob, label
        if blob is None:
            continue
        jdec = theirs[label][2]
        assert dec(jblob, len(raw)) == raw, label
        for mut in _mutants(blob, rng, 3, keep):
            got = _outcome(dec, mut, len(raw))
            want = _outcome(jdec, mut, len(raw))
            assert got == want, (label, mut)
            mutated += 1
    assert mutated > 10


def test_native_codecs_are_the_ports():
    """The codecs' native entry points decode through the port's own
    library, built under build/jellyfish_tpu_torch/."""
    import ctypes

    from jellyfish_tpu_torch.io import rans16
    from jellyfish_tpu_torch.native import LIB_PATH, get_lib

    lib = get_lib()
    assert lib is not None and lib._name == str(LIB_PATH)
    assert LIB_PATH.parent.name == "jellyfish_tpu_torch"
    assert LIB_PATH.parent.parent.name == "build"
    raw = _corpus(3)[5]
    blob = rans16.encode(raw, rans16.F_ORDER1)
    buf = ctypes.create_string_buffer(len(raw))
    assert lib.jf_rans16_decode(blob, len(blob), buf, len(raw)) == len(raw)
    assert buf.raw == raw


# -- files --------------------------------------------------------------------


RECORDS = [
    {"name": b"r1", "seq": b"ACGTACGTACGTACGTACGT",
     "qual": bytes([37] * 20)},
    {"name": b"r2", "seq": b"GGGGCCCCNNTTTTAAAA", "qual": None},
    {"name": b"r3", "seq": b"ACACACACACACACACACACACACAC",
     "qual": bytes(range(26))},
]
REF = b"ACGTACGTACGTACGTACGTTTTTGGGGCCCCAAAA"
SQ = b"@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:36\n"


def _mapped(records, **kw):
    kw.setdefault("sam_text", SQ)
    return simple_cram(records, ref_id=0, start=1, span=36, **kw)


def _records31(seed, n):
    rng = random.Random(seed)
    recs = []
    for i in range(n):
        seq = bytes(rng.choices(b"ACGT", k=rng.randrange(40, 90)))
        qual = bytes(min(93, max(0, 38 + rng.randrange(-5, 3)))
                     for _ in seq)
        recs.append({"name": b"read%05d.%d" % (i, i * 3), "seq": seq,
                     "qual": qual})
    return recs


def _all_methods(method, v3=True):
    methods = {cw.CORE: method, "slice_header": method}
    methods.update({cid: method for cid in range(1, 30)})
    series = cw.default_series()
    sl = cw.encode_slice(series, RECORDS, block_methods=methods, v3=v3)
    return (cw.file_definition(version=(3, 0) if v3 else (2, 1))
            + cw.sam_header_container(b"@HD\tVN:1.6\n", method=method,
                                      v3=v3)
            + cw.data_container(cw.compression_header(series), sl,
                                1 + cw.count_blocks(sl, v3=v3),
                                len(RECORDS), 0, comp_method=method, v3=v3)
            + cw.eof_container(v3=v3))


def _core_codecs():
    series = cw.default_series()
    series["BF"] = Huffman([4], [0])
    series["CF"] = Huffman([1, 0], [1, 1])
    series["RL"] = Beta(0, 6)
    series["AP"] = Gamma(1)
    series["RG"] = SubExp(1, 2)
    series["TL"] = Huffman([0], [0])
    series["RN"] = ByteArrayStop(0x09, 31)
    return simple_cram(RECORDS, series=series)


def _detached_tags():
    tag_key = (ord("X") << 16) | (ord("A") << 8) | ord("Z")
    series = cw.default_series(detached=True)
    series["TS"] = SubExp(0, 3)
    return simple_cram(RECORDS, series=series, detached=True,
                       tag_dict=[[], [b"XAZ"]],
                       tags=[(b"XAZ", b"hello-world\x00")],
                       tag_encodings={tag_key: ext_array(40)})


ZOO = [(1, "S", b"TT"), (5, "X", 1), (6, "i", ord("G")),
       (7, "B", (ord("T"), 11)), (8, "I", b"AA"), (10, "D", 2),
       (10, "N", 3), (14, "Q", 9), (16, "b", b"CA"),
       (18, "q", bytes([7, 8])), (20, "H", 5), (20, "P", 1)]


def _kitchen_sink():
    series = cw.default_series(with_features=True)
    series["BF"] = Huffman([4, 0], [1, 1])
    series["CF"] = Huffman([1, 0], [1, 1])
    series["RL"] = Beta(0, 7)
    series["AP"] = Gamma(3)
    series["RG"] = SubExp(1, 2)
    series["TL"] = Huffman([0], [0])
    series["RN"] = ByteArrayStop(0x00, 31)
    series["FN"] = Gamma(1)
    series["FP"] = Beta(0, 7)
    series["MQ"] = Huffman([30], [0])
    series["BS"] = Huffman([0, 1, 2, 3], [2, 2, 2, 2])
    recs = [
        {"name": b"u1", "seq": b"ACGTNACGT" * 3, "qual": None},
        {"name": b"m1", "mapped": True, "pos": 4, "rlen": 10,
         "features": [(2, "X", 3), (5, "S", b"GG"), (8, "D", 2)],
         "qual": bytes(range(10))},
        {"name": b"m2", "mapped": True, "pos": 2, "rlen": 6,
         "features": [], "qual": None},
        {"name": b"u2", "seq": b"T" * 40, "qual": bytes([5] * 40)},
    ]
    return _mapped(recs, embedded_ref=REF, series=series,
                   block_methods={cw.CORE: "rans0", 8: "gzip", 9: "rans1",
                                  31: "bzip2", 22: "lzma"})


def _multi_layout(version=(3, 0), base=0):
    v3 = version[0] == 3
    series = cw.default_series()
    sl1 = cw.encode_slice(series, RECORDS[:2], record_counter=base, v3=v3)
    sl2 = cw.encode_slice(series, RECORDS[2:], record_counter=base + 2,
                          v3=v3)
    cont_a = cw.data_container(cw.compression_header(series), sl1 + sl2,
                               1 + cw.count_blocks(sl1 + sl2, v3=v3), 3,
                               base, v3=v3)
    more = [{"name": b"r4", "seq": b"TTTT", "qual": None}]
    sl3 = cw.encode_slice(series, more, record_counter=base + 3, v3=v3)
    cont_b = cw.data_container(cw.compression_header(series), sl3,
                               1 + cw.count_blocks(sl3, v3=v3), 1,
                               base + 3, v3=v3)
    return (cw.file_definition(version=version)
            + cw.sam_header_container(b"@HD\n", v3=v3) + cont_a + cont_b
            + cw.eof_container(v3=v3))


def _cram31(seed=314, n=24):
    recs = _records31(seed, n)
    series = cw.default_series()
    series["RN"] = ByteArrayStop(0, 6)
    methods = {cid: "arith" for cid in range(1, 8)}
    methods[6] = "tok3"
    methods[8] = "rans16-o1"
    methods[9] = fqz_method([len(r["qual"]) for r in recs])
    methods["slice_header"] = "rans16"
    return simple_cram(recs, series=series, block_methods=methods,
                       version=(3, 1))


def _fuzz_mapped(seed):
    """test_cram_fuzz's generator: unmapped and mapped records with
    random but consistent features, on a 500-base embedded reference."""
    from test_cram_fuzz import REF as FREF
    from test_cram_fuzz import random_features

    rng = random.Random(1000 + seed)
    records = []
    for i in range(12):
        if rng.random() < 0.4:
            seq = bytes(rng.choices(b"ACGTN", k=rng.randrange(1, 80)))
            qual = (bytes(rng.randrange(60) for _ in seq)
                    if rng.random() < 0.5 else None)
            records.append({"name": b"u%d" % i, "seq": seq, "qual": qual})
        else:
            rlen = rng.randrange(5, 90)
            records.append({"name": b"m%d" % i, "mapped": True,
                            "pos": rng.randrange(1, len(FREF) + 20),
                            "rlen": rlen,
                            "features": random_features(rng, rlen),
                            "qual": None})
    return simple_cram(
        records, embedded_ref=FREF, ref_id=0, start=1, span=len(FREF),
        ap_delta=bool(seed % 2),
        sam_text=b"@HD\tVN:1.6\n@SQ\tSN:f\tLN:%d\n" % len(FREF),
        block_methods={cw.CORE: "rans0", 8: "rans1", 9: "gzip"})


def _unknown_codec():
    series = cw.default_series()
    series["RL"].codec = 2  # GOLOMB, which the readers do not take
    return simple_cram(RECORDS, series=series)


METHODS31 = ["rans16", "rans16-o1", "rans16-x32", "rans16-o1x32",
             "rans16-cat", "rans16-rle", "rans16-pack", "rans16-packrle",
             "rans16-stripe", "arith", "arith-o1", "arith-rle",
             "arith-o1rle", "arith-pack", "arith-ext", "arith-cat",
             "arith-stripe"]

FILES = {
    "unmapped": lambda: simple_cram(RECORDS),
    **{f"v30-{m}": (lambda m=m: _all_methods(m))
       for m in ("gzip", "bzip2", "lzma", "rans0", "rans1")},
    "core-codecs": _core_codecs,
    "detached-tags": _detached_tags,
    "generated-names": lambda: simple_cram(
        [{"name": b"x", "seq": b"ACGT" * 3, "qual": None}],
        rn_preserved=False),
    "feature-zoo": lambda: _mapped(
        [{"name": b"zoo", "mapped": True, "pos": 5, "rlen": 20,
          "features": ZOO, "qual": None}], embedded_ref=REF),
    "subst-matrix": lambda: _mapped(
        [{"name": b"s", "mapped": True, "pos": 1, "rlen": 4,
          "features": [(2, "X", 3)], "qual": None}],
        embedded_ref=REF, subst=b"\xe4" * 5),
    "qual-array": lambda: _mapped(
        [{"name": b"q", "mapped": True, "pos": 1, "rlen": 8,
          "features": [], "qual": bytes([20] * 8)}], embedded_ref=REF),
    "no-ref-rr-false": lambda: _mapped(
        [{"name": b"n", "mapped": True, "pos": 1, "rlen": 10,
          "features": [(1, "b", b"TTTTGGGGCC")], "qual": None}], rr=False),
    "past-ref-end": lambda: _mapped(
        [{"name": b"p", "mapped": True, "pos": 33, "rlen": 8,
          "features": [], "qual": None}], embedded_ref=REF),
    "ap-absolute": lambda: _mapped(
        [{"name": n, "mapped": True, "pos": p, "rlen": 4, "features": [],
          "qual": None} for n, p in ((b"a", 3), (b"b", 9))],
        embedded_ref=REF, ap_delta=False),
    "kitchen-sink": _kitchen_sink,
    "multi-container": _multi_layout,
    "no-eof": lambda: simple_cram(RECORDS)[:-len(cw.eof_container())],
    **{f"v2{v[1]}": (lambda v=v: simple_cram(RECORDS, version=v))
       for v in ((2, 0), (2, 1))},
    "v21-mapped": lambda: simple_cram(
        [{"name": b"m1", "mapped": True, "pos": 3, "rlen": 12,
          "features": [(5, "X", 1)], "qual": None}], sam_text=SQ,
        ref_id=0, start=1, span=36, embedded_ref=REF, version=(2, 1)),
    "v20-legacy-keys": lambda: simple_cram(
        RECORDS, version=(2, 0), extra_pres=(b"MI\x01", b"UI\x01",
                                             b"PI\x00")),
    **{f"v21-{m}": (lambda m=m: _all_methods(m, v3=False))
       for m in ("gzip", "bzip2")},
    "v20-big-counter": lambda: _multi_layout((2, 0), (1 << 31) + 5),
    "v31-all-methods": _cram31,
    **{f"v31-{m}": (lambda m=m: simple_cram(
        _records31(len(m), 6), block_methods={8: m, 9: m}, version=(3, 1)))
       for m in METHODS31},
    "v31-tok3-arith": lambda: simple_cram(
        _records31(555, 8), series={**cw.default_series(),
                                    "RN": ByteArrayStop(0, 6)},
        block_methods={6: "tok3-arith"}, version=(3, 1)),
    "v31-fqz-multiparam": lambda: simple_cram(
        _records31(556, 9), version=(3, 1), block_methods={9: fqz_method(
            [len(r["qual"]) for r in _records31(556, 9)], nparam=2,
            do_rev=[i % 2 == 0 for i in range(9)])}),
    **{f"fuzz-mapped-{s}": (lambda s=s: _fuzz_mapped(s)) for s in range(4)},
    "v1-rejected": lambda: b"CRAM\x01\x00" + b"\x00" * 20,
    "unknown-codec": lambda: _unknown_codec(),
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_cram_files_match_jax(path, name):
    """cram_records_to_fastx yields the JAX package's bytes for each
    file, with and without the quality blocks, or raises its error."""
    blob = FILES[name]()
    out = _same(blob)
    _same(blob, need_quals=False)
    if name.endswith(("rejected", "codec")):
        assert isinstance(out, tuple) and out[0] == "CramError"
    else:
        assert isinstance(out, bytes) and out.count(b"\n") >= 2


def _ref_case(tmp_path, monkeypatch, how):
    """A reference-compressed CRAM (no embedded reference) and the
    environment that finds its reference `how`."""
    import hashlib

    for env in ("JF_CRAM_REF", "JF_CRAM_REF_CACHE", "REF_CACHE"):
        monkeypatch.delenv(env, raising=False)
    m5 = hashlib.md5(REF).hexdigest()
    sam = b"@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:36"
    if how in ("m5-flat", "m5-template", "m5-bad", "env-m5-bad"):
        sam += b"\tM5:" + m5.encode()
    fa = tmp_path / "ref.fa"
    fa.write_bytes(b">chr1 desc\n" + REF[:18] + b"\n" + REF[18:] + b"\n")
    if how == "ur":
        sam += b"\tUR:file://" + str(fa).encode()
    elif how == "env":
        monkeypatch.setenv("JF_CRAM_REF", str(fa))
    elif how == "env-m5-bad":
        fa.write_bytes(b">chr1\n" + REF[:-1] + b"T\n")
        monkeypatch.setenv("JF_CRAM_REF", str(fa))
    elif how == "m5-flat":
        (tmp_path / m5).write_bytes(REF)
        monkeypatch.setenv("JF_CRAM_REF_CACHE", str(tmp_path))
    elif how in ("m5-template", "m5-bad"):
        nested = tmp_path / "nest" / m5[:2] / m5[2:4]
        nested.mkdir(parents=True)
        body = REF if how == "m5-template" else REF[:-1] + b"T"
        (nested / m5[4:]).write_bytes(body)
        monkeypatch.setenv("REF_CACHE", str(tmp_path / "nest") + "/%2s/%2s/%s")
    recs = [{"name": b"e", "mapped": True, "pos": 7, "rlen": 10,
             "features": [(3, "X", 2)], "qual": None},
            {"name": b"f", "mapped": True, "pos": 1, "rlen": 36,
             "features": [], "qual": bytes(range(36))}]
    return _mapped(recs, sam_text=sam + b"\n")


@pytest.mark.parametrize("how", ["env", "ur", "m5-flat", "m5-template",
                                 "absent", "m5-bad", "env-m5-bad"])
def test_external_reference_matches_jax(path, tmp_path, monkeypatch, how):
    """A reference-compressed CRAM finds its reference through
    JF_CRAM_REF, a local-file UR: field, or an M5 cache (JF_CRAM_REF_CACHE
    as a flat directory, REF_CACHE as a %Ns template), as the JAX package
    does; an absent reference, or one that fails its M5, raises the JAX
    package's error."""
    blob = _ref_case(tmp_path, monkeypatch, how)
    out = _same(blob)
    if how in ("absent", "m5-bad", "env-m5-bad"):
        assert out[0] == "CramError"
        assert ("JF_CRAM_REF" if how == "absent" else "M5") in out[1]
    else:
        assert out.startswith(b">e\n") and REF[8:10] in out


def test_multiref_slice_matches_jax(path, tmp_path, monkeypatch):
    """A slice whose records name their reference (RI) each: the python
    path decodes it in both packages."""
    fa = tmp_path / "two.fa"
    fa.write_bytes(b">c1\n" + REF + b"\n>c2\nTTGGCCAATTGG\n")
    monkeypatch.setenv("JF_CRAM_REF", str(fa))
    series = cw.default_series(multiref=True)
    series.update(FN=External(15), FC=External(16), FP=External(17),
                  BS=External(18), MQ=External(27))
    recs = [{"name": b"r", "mapped": True, "pos": 1, "rlen": 6,
             "features": [], "qual": None, "ref_id": 1},
            {"name": b"s", "mapped": True, "pos": 3, "rlen": 5,
             "features": [(2, "X", 0)], "qual": None, "ref_id": 0}]
    blob = simple_cram(recs, series=series, multiref=True, start=1,
                       span=36, sam_text=b"@HD\tVN:1.6\n@SQ\tSN:c1\tLN:36"
                       b"\n@SQ\tSN:c2\tLN:12\n")
    assert _same(blob).startswith(b">r\nTTGGCC\n")


def _many_slices(n_containers=3, per=4):
    """A CRAM 3.1 file of n_containers containers of `per` slices."""
    out = [cw.file_definition(version=(3, 1)),
           cw.sam_header_container(b"@HD\tVN:1.6\n")]
    series = cw.default_series()
    counter = 0
    for c in range(n_containers):
        sl = b""
        for s in range(per):
            recs = _records31(100 * c + s, 5)
            sl += cw.encode_slice(series, recs, record_counter=counter,
                                  block_methods={8: "rans16-o1",
                                                 9: "arith-o1"})
            counter += len(recs)
        out.append(cw.data_container(cw.compression_header(series), sl,
                                     1 + cw.count_blocks(sl), 5 * per,
                                     counter - 5 * per))
    return b"".join(out) + cw.eof_container()


@pytest.mark.parametrize("threads", ["1", "4"])
def test_slice_pool_matches_jax(path, monkeypatch, threads):
    """12 slices in 3 containers, decoded one at a time and on a pool of
    4 threads (JF_CRAM_THREADS): the JAX package's bytes, in file
    order."""
    monkeypatch.setenv("JF_CRAM_THREADS", threads)
    out = _same(_many_slices())
    assert out.count(b"\n+\n") == 60
    assert out.index(b"@read00000.0\n") < out.index(b"@read00004.12\n")


def test_quality_free_mode_skips_quality_blocks(path, monkeypatch):
    """need_quals=False: FASTA records of the same sequences, the JAX
    package's bytes, and the fqzcomp block never decompressed."""
    from jellyfish_tpu_torch.io import cram

    blob = _cram31(77, 40)
    full = _same(blob)
    calls = []
    orig = cram._decompress

    def counting(method, data, raw_size):
        calls.append(method)
        return orig(method, data, raw_size)

    monkeypatch.setattr(cram, "_decompress", counting)
    noq = _same(blob, need_quals=False)
    assert cram.METHOD_FQZ not in calls
    assert noq.startswith(b">") and noq.count(b"\n") * 2 == full.count(b"\n")


def test_corrupt_files_match_jax(path, monkeypatch):
    """Bit flips and truncations of a CRAM 3.0 and a CRAM 3.1 file: the
    port yields the JAX package's bytes or raises its exception, with its
    message, decoding one slice at a time; on the slice pool it yields the
    same bytes, or raises where they raise. (On the pool, when a slice and
    the container walk after it both fail, which error comes first
    depends on the threads' timing, in either package.)"""
    rng = np.random.default_rng(77)
    recs = [{"name": b"r%d" % i,
             "seq": bytes(rng.choice(list(b"ACGT"), 50)),
             "qual": bytes(rng.integers(0, 40, 50).astype(np.uint8))}
            for i in range(8)]
    bases = [simple_cram(recs, block_methods={cw.CORE: "rans0", 8: "rans1",
                                              9: "rans0"}),
             _cram31(5, 8)]
    blobs = []
    for base in bases:
        for _ in range(25):
            blob = bytearray(base)
            for _ in range(int(rng.integers(1, 4))):
                blob[int(rng.integers(4, len(blob)))] ^= 1 << int(
                    rng.integers(8))
            blobs.append(bytes(blob))
        blobs += [base[:int(rng.integers(6, len(base)))] for _ in range(10)]
    monkeypatch.setenv("JF_CRAM_THREADS", "1")
    serial = [_same(b) for b in blobs]
    assert sum(isinstance(o, tuple) for o in serial) > 20
    monkeypatch.setenv("JF_CRAM_THREADS", "4")
    for blob, want in zip(blobs, serial):
        got = [_outcome(_decode, pkg, blob)
               for pkg in ("jellyfish_tpu_torch", "jellyfish_tpu")]
        for g in got:
            assert g == want if isinstance(want, bytes) else (
                isinstance(g, tuple))


# -- parse and CLI ------------------------------------------------------------


def test_gzipped_cram_and_concurrent_files(path, tmp_path):
    """A gzipped CRAM through open_stream and sam_records_to_fastx, and
    -F 2 over a FASTQ and that CRAM: the JAX package's records, and the
    same mers as -F 1."""
    import gzip

    from jellyfish_tpu.io.parse import SequenceChunker as JaxChunker
    from jellyfish_tpu.io.parse import open_stream as jopen
    from jellyfish_tpu.io.parse import sam_records_to_fastx as jrecords

    from jellyfish_tpu_torch.io.parse import (
        SequenceChunker,
        open_stream,
        sam_records_to_fastx,
    )
    from jellyfish_tpu_torch.mer import string_mers

    gz = tmp_path / "r.cram.gz"
    gz.write_bytes(gzip.compress(_cram31(8, 10)))
    with open_stream(str(gz)) as f:
        got = b"".join(sam_records_to_fastx(f))
    with jopen(str(gz)) as f:
        assert got == b"".join(jrecords(f)) and got.count(b"\n") == 40
    fq = tmp_path / "a.fq"
    fq.write_bytes(b"@x\nACGTACGTTGACCATGACG\n+\n" + b"I" * 19 + b"\n")

    def mers(cls, nb_files):
        with cls([str(fq)], 11, 256, sam_paths=[str(gz)],
                 nb_files=nb_files) as ch:
            out = {}
            for chunk in ch.chunks():
                for m in string_mers(chunk.tobytes().decode(), 11):
                    out[m.bits] = out.get(m.bits, 0) + 1
            return out, ch.reads

    serial = mers(SequenceChunker, 1)
    assert serial[0] and serial[1] == 11
    assert mers(SequenceChunker, 2) == serial == mers(JaxChunker, 2)


def _split(p):
    from jellyfish_tpu_torch.io.header import FileHeader

    with open(p, "rb") as f:
        h = FileHeader.read(f)
        return h.root, f.read()


@pytest.fixture(scope="module")
def cli_cram(tmp_path_factory):
    """The CLI's CRAM files of 150 reads of 60-140 bases with qualities,
    some bases N: `v31.cram` (tok3 names, rANS Nx16 bases, fqzcomp
    qualities), `v30.cram` (rANS 4x8 order 0 and 1), `v21.cram` (gzip
    and bzip2 blocks, 2.1 framing), and `ref.cram`, reads mapped with
    substitutions, insertions and soft clips onto a 3,000-base reference
    that `ref.fa` holds and the file does not."""
    d = tmp_path_factory.mktemp("cram_cli")
    rng = random.Random(2024)
    recs = []
    for i in range(150):
        seq = bytes(rng.choices(b"ACGTN", weights=[25, 25, 25, 25, 1],
                                k=rng.randrange(60, 140)))
        recs.append({"name": b"q%04d" % i, "seq": seq,
                     "qual": bytes(rng.randrange(2, 41) for _ in seq)})
    series = cw.default_series()
    series["RN"] = ByteArrayStop(0, 6)
    (d / "v31.cram").write_bytes(simple_cram(
        recs, series=series, version=(3, 1), block_methods={
            6: "tok3", 8: "rans16-o1",
            9: fqz_method([len(r["qual"]) for r in recs])}))
    (d / "v30.cram").write_bytes(simple_cram(recs, block_methods={
        cw.CORE: "rans0", 6: "rans0", 8: "rans1", 9: "rans1"}))
    (d / "v21.cram").write_bytes(simple_cram(recs, version=(2, 1),
                                             block_methods={
        cw.CORE: "gzip", 6: "bzip2", 8: "gzip", 9: "bzip2"}))
    ref = bytes(rng.choices(b"ACGT", k=3000))
    (d / "ref.fa").write_bytes(b">chr1\n" + ref + b"\n")
    mapped = []
    for i in range(150):
        rlen = rng.randrange(60, 140)
        subs = {rng.randrange(1, rlen + 1): rng.randrange(4)
                for _ in range(rng.randrange(0, 4))}
        feats = [(pos, "X", code) for pos, code in sorted(subs.items())]
        if rng.random() < 0.3:
            feats = [(1, "S", b"TTGA")] + [f for f in feats if f[0] > 4]
        mapped.append({"name": b"m%04d" % i, "mapped": True,
                       "pos": rng.randrange(1, 2900), "rlen": rlen,
                       "features": feats,
                       "qual": bytes(rng.randrange(2, 41)
                                     for _ in range(rlen))})
    (d / "ref.cram").write_bytes(simple_cram(
        mapped, sam_text=b"@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:3000\n",
        ref_id=0, start=1, span=3000, block_methods={8: "rans1"}))
    return d


@pytest.mark.parametrize("name,k,extra", [
    ("v31", 21, []), ("v31", 21, ["-Q", "%"]), ("v31", 63, []),
    ("v31", 21, ["-d", "2"]), ("v30", 21, []), ("v21", 21, []),
    ("ref", 21, []), ("ref", 63, ["-Q", "%"]),
], ids=["v31-k21", "v31-k21-Q", "v31-k63", "v31-k21-d2", "v30-k21",
        "v21-k21", "ref-k21", "ref-k63-Q"])
def test_count_cram_cli_matches_jax(cli_cram, tmp_path, monkeypatch, name,
                                    k, extra):
    """count --sam of a CRAM through the CLI: the JAX package's records,
    byte for byte, and its header apart from where and how it ran (-d 2
    against the JAX package's one-device count; the reference-compressed
    file with JF_CRAM_REF set for both)."""
    from jellyfish_tpu.cli import main as jax_main

    from jellyfish_tpu_torch.cli import main

    monkeypatch.setenv("SOURCE_DATE_EPOCH", "1700000000")
    monkeypatch.setenv("JF_CRAM_REF", str(cli_cram / "ref.fa"))
    common = ["count", "-m", str(k), "-s", "8k", "-C", "--matrix-seed", "3",
              "--chunk-len", "2048", "--sam", str(cli_cram / f"{name}.cram")]
    jax_extra = [a for a in extra if a not in ("-d", "2")]
    jax_out = cli_cram / f"jax-{name}-{k}{''.join(jax_extra)}.jf"
    if not jax_out.exists():
        assert jax_main([*common, *jax_extra, "-o", str(jax_out)]) == 0
    out = tmp_path / "t.jf"
    assert main([*common, *extra, "-o", str(out)], device="cpu") == 0
    ht, rt = _split(out)
    hj, rj = _split(jax_out)
    assert len(rt) > 1000 and rt == rj
    for h in (ht, hj):
        for key in ("exe_path", "pwd", "cmdline"):
            h.pop(key, None)
    if "-d" not in extra:
        assert ht == hj
