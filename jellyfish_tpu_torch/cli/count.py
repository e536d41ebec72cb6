"""`jellyfish count` on the GPU (jellyfish_tpu/cli/count.py: one device,
`-d N` shards, `--coordinator` processes, with the --disk spill and merge
and the Bloom filters).

The flag surface is the JAX package's (count_main_cmdline.yaggo:4-112).
Every flag runs, and --sam reads SAM, BAM and CRAM files.

-d N shards the table by hash prefix over N devices
(parallel/sharded.py); -d auto means every visible CUDA device (1 on the
CPU), and -d 0, -d 1 or one device count on one device. On the card N may
not exceed the visible CUDA devices; with device="cpu" every shard lies
on the CPU and N is free. Under -d each ingest step takes N chunks, one a
shard, the tail padded with chunks that hold no mer.

--coordinator HOST:PORT --num-processes N --process-id I runs one process
of N (parallel/multihost.py): each counts the input files it was given,
with its visible CUDA devices as its local shards (one shard on the CPU;
-d is ignored), and the steps exchange mers between the processes over
NCCL on the card and gloo on the CPU. The processes step in lockstep on
one has-data flag a round; a process whose input has run out takes part
with empty steps. Given no --matrix-seed, rank 0 draws the seed and
broadcasts it. Each process writes its contiguous segment of the
database (-L/-U and --text per segment) and rank 0 assembles them; with
--disk each rank spills standalone databases, on the same steps as the
others (the store bytes are summed over the ranks), merges its own
locally (also under --no-merge, as in the JAX package) and rank 0 joins
the merged ones. --timing is written by rank 0. --bc and --bf-size apply
at finalize, on each mer's owner shard, when there is more than one
process.

Ingest: host-packed batches when no filter is given and --chunk-len is a
multiple of 32; otherwise ASCII chunks one at a time, as the JAX package
does, so that `--bf-size` decides on exactly the JAX package's chunks.
--bc keeps a chunk's mers whose Bloom-counter check is 2; --bf-size drops
each mer's first occurrence (bloom.load_count_filter). --if builds the
allowed set before counting, and every dump, --disk partials included,
holds exactly the allowed mers, each with its count or 0. --packed-store
keeps the store's resting runs bit-packed (ops/packed_run.py). -g runs
the generator commands of a file (-G at once, in shell -S) and counts
their output after the files'. --sam reads SAM and BAM files
(io/parse.py) after the sequence files.

--disk writes a partial database `{output}{i}` whenever the store holds
twice `--size` entries (16 bytes an entry, store.device_bytes), then
merges the partials on the device (merge.py) and unlinks them. The port's
spill points may differ from the JAX package's, whose store is laid out
otherwise; the merged database does not. Unlike the JAX package, a
--no-write run does not spill: it writes nothing, partials included.
"""

from __future__ import annotations

import os
import time

import numpy as np

__all__ = ["add_parser", "run"]


def add_parser(sub):
    from jellyfish_tpu_torch.cli.common import add_common_input_flags, suffix_int

    p = sub.add_parser("count", help="Count k-mers in fasta or fastq files")
    p.add_argument("-m", "--mer-len", type=int, required=True,
                   dest="mer_len", help="Length of mer")
    p.add_argument("-s", "--size", type=suffix_int, required=True,
                   help="Initial hash size (suffixes k/M/G/T ok)")
    p.add_argument("-o", "--output", default="mer_counts.jf",
                   help="Output file (default mer_counts.jf)")
    p.add_argument("-c", "--counter-len", type=int, default=7, dest="counter_len",
                   help="Length in bits of counting field (header val_len)")
    p.add_argument("--out-counter-len", type=int, default=4,
                   help="Length in bytes of counter field in output")
    p.add_argument("-C", "--canonical", action="store_true",
                   help="Count both strands, canonical representation")
    p.add_argument("--bc", metavar="path",
                   help="Bloom counter to filter out singleton mers")
    p.add_argument("--bf-size", type=suffix_int, default=None,
                   help="Use bloom filter to count high-frequency mers")
    p.add_argument("--bf-fp", type=float, default=0.01,
                   help="False positive rate of bloom filter")
    p.add_argument("--if", dest="if_files", action="append", default=[],
                   metavar="path", help="Count only k-mers in these files")
    p.add_argument("-Q", "--min-qual-char", dest="min_qual_char",
                   help="Any base with quality below this character becomes N")
    p.add_argument("--quality-start", type=int, default=64,
                   help="ASCII for quality values")
    p.add_argument("--min-quality", type=int, default=None,
                   help="Minimum quality; a lesser-quality base becomes an N")
    p.add_argument("-p", "--reprobes", type=int, default=126,
                   help="Maximum number of reprobes (header compatibility)")
    p.add_argument("--text", action="store_true", help="Dump in text format")
    p.add_argument("--disk", action="store_true",
                   help="Spill sorted partials to disk instead of growing")
    p.add_argument("--no-merge", action="store_true",
                   help="Do not merge --disk intermediate files")
    p.add_argument("--no-unlink", action="store_true",
                   help="Do not delete intermediate files after merging")
    p.add_argument("--no-write", action="store_true",
                   help="Do not write the database")
    p.add_argument("-L", "--lower-count", type=int, default=None,
                   help="Do not output mers with count < lower-count")
    p.add_argument("-U", "--upper-count", type=int, default=None,
                   help="Do not output mers with count > upper-count")
    p.add_argument("--sam", action="append", default=[], metavar="PATH",
                   help="SAM/BAM/CRAM formatted input file")
    p.add_argument("-d", "--devices", default="1", metavar="N|auto",
                   help="Shard the hash across N devices")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="Multi-host run: coordinator address")
    p.add_argument("--num-processes", type=int, dest="num_processes",
                   help="Multi-host run: total number of processes")
    p.add_argument("--process-id", type=int, dest="process_id",
                   help="Multi-host run: this process's rank [0, N)")
    p.add_argument("--packed-store", action="store_true",
                   dest="packed_store",
                   help="Bit-pack resting store runs")
    p.add_argument("--matrix-seed", type=int, dest="matrix_seed",
                   default=None,
                   help="Seed for the random hash matrix")
    add_common_input_flags(p)
    p.add_argument("file", nargs="*", help="Sequence file(s) (fasta/fastq)")
    p.set_defaults(func=run)
    return p


def _prefetch(iterable, depth: int = 4):
    """Run `iterable` on a producer thread with a bounded queue."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    DONE = object()
    state = {"error": None}

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:
            state["error"] = e
        finally:
            q.put(DONE)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is DONE:
            break
        yield item
    t.join()
    if state["error"] is not None:
        raise state["error"]


def _batched(iterable, n: int):
    """Group chunks into lists of n, padding the tail with chunks that hold
    no window: all-zero (pwords, validbits) tuples (zero validity bits),
    or all-N uint8 chunks."""
    batch = []
    for item in iterable:
        batch.append(item)
        if len(batch) == n:
            yield batch
            batch = []
    if batch:
        pad = batch[-1]
        if isinstance(pad, tuple):
            pad = tuple(np.zeros_like(x) for x in pad)
        else:
            pad = np.full_like(pad, ord("N"))
        batch.extend([pad] * (n - len(batch)))
        yield batch


def _n_devices(args, on_card: bool) -> int:
    """-d's shard count: `auto` is every visible CUDA device on the card
    and 1 on the CPU; N above the visible CUDA devices dies."""
    import torch

    from jellyfish_tpu_torch.cli.common import die

    if args.devices == "auto":
        return torch.cuda.device_count() if on_card else 1
    n = int(args.devices)
    if on_card and n > torch.cuda.device_count():
        die(f"count: --devices {n} exceeds the "
            f"{torch.cuda.device_count()} visible devices")
    return n


def _min_qual(args):
    if args.min_qual_char is not None:
        if len(args.min_qual_char) != 1:
            raise SystemExit("jellyfish count: -Q must be a single character")
        return ord(args.min_qual_char)
    if args.min_quality is not None:
        return args.quality_start + args.min_quality
    return None


def _check_topology(args) -> None:
    """--coordinator's flags, checked before any process group exists."""
    from jellyfish_tpu_torch.cli.common import die

    if args.num_processes is None or args.process_id is None:
        die("count: --coordinator requires --num-processes and "
            "--process-id")
    if args.num_processes < 1:
        die(f"count: --num-processes {args.num_processes} is not positive")
    if not 0 <= args.process_id < args.num_processes:
        die(f"count: --process-id {args.process_id} is not in "
            f"[0, {args.num_processes})")


def _broadcast_seed(device) -> int:
    """Rank 0's fresh matrix seed, the same on every rank."""
    import torch
    import torch.distributed as dist

    from jellyfish_tpu_torch.device import resolve_device

    seed = (int(np.random.default_rng().integers(0, 1 << 62))
            if dist.get_rank() == 0 else 0)
    t = torch.tensor([seed], dtype=torch.int64, device=resolve_device(device))
    dist.broadcast(t, src=0)
    return int(t.item())


def run(args, argv, device=None):
    import sys

    from jellyfish_tpu_torch.cli.common import die

    t_start = time.perf_counter()
    if not args.file and not args.generator and not args.sam:
        die("count: no input files given")
    if not args.coordinator:
        return _count(args, argv, device, t_start)
    _check_topology(args)
    from jellyfish_tpu_torch.parallel.multihost import (
        init_multihost,
        shutdown_multihost,
    )

    backend = init_multihost(args.coordinator, args.num_processes,
                             args.process_id, device)
    try:
        print(f"jellyfish: count: process {args.process_id} of "
              f"{args.num_processes}, {backend} backend", file=sys.stderr)
        return _count(args, argv, device, t_start)
    finally:
        shutdown_multihost()


def _count(args, argv, device, t_start):
    import signal

    from jellyfish_tpu_torch.cli.common import load_generator_cmds
    from jellyfish_tpu_torch.counter import MerCounter
    from jellyfish_tpu_torch.device import resolve_device
    from jellyfish_tpu_torch.io.parse import SequenceChunker

    k = args.mer_len
    gen_cmds = load_generator_cmds(args.generator) if args.generator else None
    filt = None
    if args.bc or args.bf_size is not None:
        from jellyfish_tpu_torch.bloom import load_count_filter

        filt = load_count_filter(
            bc_path=args.bc, bf_size=args.bf_size, bf_fp=args.bf_fp, k=k,
            canonical=args.canonical, device=device,
        )
    seed = args.matrix_seed
    if args.coordinator and seed is None:
        seed = _broadcast_seed(device)
    rng = np.random.default_rng(seed)
    on_card = resolve_device(device).type == "cuda"
    if args.coordinator:
        import torch.distributed as dist

        from jellyfish_tpu_torch.parallel import ShardedMerCounter, make_mesh

        # the local shards: every visible card, or one shard on the CPU
        counter = ShardedMerCounter(
            k, size=args.size,
            mesh=make_mesh() if on_card else make_mesh(1, "cpu"),
            canonical=args.canonical, rng=rng, mer_filter=filt,
            pack_resting=args.packed_store, group=dist.group.WORLD,
        )
    elif (n_devices := _n_devices(args, on_card)) > 1:
        from jellyfish_tpu_torch.parallel import ShardedMerCounter, make_mesh

        counter = ShardedMerCounter(
            k, size=args.size,
            mesh=make_mesh(n_devices, None if on_card else "cpu"),
            canonical=args.canonical, rng=rng, mer_filter=filt,
            pack_resting=args.packed_store,
        )
    else:
        counter = MerCounter(
            k, size=args.size, canonical=args.canonical, rng=rng,
            device=device, mer_filter=filt, pack_resting=args.packed_store,
        )
    chunker = SequenceChunker(
        list(args.file), k, chunk_len=args.chunk_len, min_qual=_min_qual(args),
        generator_cmds=gen_cmds, shell=args.shell, sam_paths=list(args.sam),
        nb_files=args.nb_files, nb_generators=args.nb_generators,
    )

    # a SIGTERM ends the run through the finally below, which terminates
    # the generator children (count_main.cc:209-216)
    def _on_term(signum, frame):
        raise SystemExit(143)

    old_term = None
    try:
        old_term = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass  # not the main thread (library use)
    try:
        if args.coordinator:
            return _run_counting_multihost(args, argv, k, counter, chunker,
                                           t_start)
        return _run_counting(args, argv, k, counter, chunker, t_start)
    finally:
        chunker.close()
        if old_term is not None:
            signal.signal(signal.SIGTERM, old_term)


def _run_counting(args, argv, k, counter, chunker, t_start):
    from jellyfish_tpu_torch.io.dumpers import dump_counter
    from jellyfish_tpu_torch.io.parse import SequenceChunker
    from jellyfish_tpu_torch.merge import merge_files

    filt = counter.mer_filter
    if args.if_files:
        # the allowed set first (the reference PRIMEs its table before
        # counting, count_main.cc:288-295), so every dump is restricted
        with SequenceChunker(list(args.if_files), k,
                             chunk_len=args.chunk_len) as allowed:
            counter.restrict_to(allowed.chunks())
    t_init = time.perf_counter()

    def dump(path, **filters):
        dump_counter(
            counter, path, text=args.text,
            counter_len_bytes=args.out_counter_len,
            val_len_bits=args.counter_len, max_reprobe=args.reprobes,
            cmdline=argv, **filters,
        )

    intermediates = []
    spill_entries = args.size if args.disk and not args.no_write else None

    def maybe_spill():
        # entries the store holds, 16 bytes each (jellyfish_tpu count)
        if (spill_entries is not None
                and counter.store.device_bytes() // 16 >= 2 * spill_entries):
            path = f"{args.output}{len(intermediates)}"
            dump(path)
            counter.reset()
            intermediates.append(path)

    # parsing (and packing) runs on a producer thread so host work
    # overlaps the device's
    n_shards = getattr(counter, "n_shards", 1)
    if filt is None and args.chunk_len % 32 == 0:
        # B chunks per batch, or one a shard
        if n_shards > 1:
            B, add = n_shards, counter.add_chunks_packed
        else:
            B = int(os.environ.get("JF_INGEST_BATCH", 8))
            add = counter.add_chunks_packed_batch
        for batch in _prefetch(_batched(chunker.chunks_packed(), B)):
            add(np.stack([b[0] for b in batch]),
                np.stack([b[1] for b in batch]))
            maybe_spill()
    elif n_shards > 1:
        for batch in _prefetch(_batched(chunker.chunks(), n_shards)):
            counter.add_chunks(np.stack(batch))
            maybe_spill()
    else:
        for chunk in _prefetch(chunker.chunks()):
            counter.add_chunk(chunk)
            maybe_spill()
    t_count = time.perf_counter()

    if not args.no_write:
        if not intermediates:
            dump(args.output, lower_count=args.lower_count or 0,
                 upper_count=args.upper_count)
        else:
            path = f"{args.output}{len(intermediates)}"
            dump(path)
            intermediates.append(path)
            if not args.no_merge:
                merge_files(
                    intermediates, args.output,
                    min_count=args.lower_count or 0,
                    max_count=args.upper_count,
                    out_header_extra={"cmdline": list(argv)},
                    device=counter.device,
                )
                if not args.no_unlink:
                    for f in intermediates:
                        os.unlink(f)
    t_write = time.perf_counter()
    if args.timing:
        with open(args.timing, "w") as f:
            f.write(f"Init     {t_init - t_start:.4f}\n")
            f.write(f"Counting {t_count - t_init:.4f}\n")
            f.write(f"Writing  {t_write - t_count:.4f}\n")
    return 0


def _run_counting_multihost(args, argv, k, counter, chunker, t_start):
    """One process's part of a --coordinator count (the module
    docstring): the lockstep counting loop, then this rank's segment (or
    its locally merged spills) and rank 0's assembly."""
    import torch.distributed as dist

    from jellyfish_tpu_torch.io.parse import SequenceChunker
    from jellyfish_tpu_torch.merge import merge_files
    from jellyfish_tpu_torch.parallel.multihost import (
        assemble_db,
        assemble_db_full_parts,
        write_local_segments,
    )

    rank, world = counter.rank, counter.world
    if args.if_files:
        # the prime pass, in lockstep: the union of every rank's --if files
        with SequenceChunker(list(args.if_files), k,
                             chunk_len=args.chunk_len) as allowed:
            counter.restrict_to(allowed.chunks())
    t_init = time.perf_counter()

    prefix = args.output + ".mh"
    spill_entries = args.size if args.disk and not args.no_write else None
    spills = []  # this rank's spills: standalone databases

    def write(path=None, **filters):
        write_local_segments(
            counter, prefix, counter_len_bytes=args.out_counter_len,
            val_len_bits=args.counter_len, max_reprobe=args.reprobes,
            cmdline=argv, text=args.text, part_path=path,
            embed_header=path is not None, **filters)

    def spill():
        path = f"{prefix}.spill{len(spills)}.rank{rank}.jf"
        write(path)
        spills.append(path)

    rows = counter.n_local
    if counter.mer_filter is None and args.chunk_len % 32 == 0:
        def add(batch):
            counter.add_chunks_packed(np.stack([b[0] for b in batch]),
                                      np.stack([b[1] for b in batch]))
        batches = _batched(chunker.chunks_packed(), rows)
    else:
        def add(batch):
            counter.add_chunks(np.stack(batch))
        batches = _batched(chunker.chunks(), rows)
    it = _prefetch(batches)
    while True:
        batch = next(it, None)
        if not counter.any_rank(batch is not None):
            break
        if batch is None:
            counter.empty_step()
        else:
            add(batch)
        # entries the ranks' stores hold, 16 bytes each: the same on
        # every rank, so every rank spills on the same step
        if (spill_entries is not None
                and counter.store.device_bytes() // 16 >= 2 * spill_entries):
            spill()
            counter.reset()
    t_count = time.perf_counter()

    if not args.no_write:
        if spills:
            spill()
            merged = f"{prefix}.rank{rank}.jf"
            merge_files(
                spills, merged, min_count=args.lower_count or 0,
                max_count=args.upper_count,
                out_header_extra={"cmdline": list(argv)},
                device=counter.device,
            )
            if not args.no_unlink:
                for p in spills:
                    os.unlink(p)
            dist.barrier()
            if rank == 0:
                ranks = [f"{prefix}.rank{r}.jf" for r in range(world)]
                assemble_db_full_parts(ranks, args.output)
                if not args.no_unlink:
                    for p in ranks:
                        os.unlink(p)
        else:
            write(lower_count=args.lower_count or 0,
                  upper_count=args.upper_count)
            dist.barrier()
            if rank == 0:
                assemble_db(prefix, world, args.output)
                if not args.no_unlink:
                    os.unlink(f"{prefix}.header")
                    for r in range(world):
                        os.unlink(f"{prefix}.part{r}")
        dist.barrier()
    t_write = time.perf_counter()
    if args.timing and rank == 0:
        with open(args.timing, "w") as f:
            f.write(f"Init     {t_init - t_start:.4f}\n")
            f.write(f"Counting {t_count - t_init:.4f}\n")
            f.write(f"Writing  {t_write - t_count:.4f}\n")
    return 0
