"""jellyfish_tpu_torch — the PyTorch/CUDA port of jellyfish_tpu.

The same k-mer counting design as the JAX package (sorted runs of
hash-order sortkeys, counted by segment length and merged level by level),
written with PyTorch tensors for an NVIDIA Hopper GPU. The merges and
compactions of the store run in hand-written CUDA kernels
(`kernels/merge_path.py`, `kernels/compact.py`); everything else is plain
PyTorch. Databases are byte-compatible with `jellyfish_tpu count`.

The package imports torch and numpy only: never jax, and nothing of
jellyfish_tpu (host-only helpers are copied, e.g. `gf2.py`, `io/`).
Entry points run on the GPU unless the caller passes device="cpu".
The scripting API of the reference's SWIG bindings (MerDNA, HashCounter,
HashSet, QueryMerFile, ReadMerFile, string_mers, string_canonicals) is
exported here, as in the JAX package.
"""

__version__ = "0.1.0"

from jellyfish_tpu_torch.gf2 import GF2Matrix
from jellyfish_tpu_torch.mer import MerDNA, string_canonicals, string_mers


def __getattr__(name):
    # lazily exported, keeping `import jellyfish_tpu_torch` light
    if name in ("HashCounter", "HashSet", "QueryMerFile", "ReadMerFile"):
        from jellyfish_tpu_torch import api

        return getattr(api, name)
    if name == "MerCounter":
        from jellyfish_tpu_torch.counter import MerCounter

        return MerCounter
    if name == "ShardedMerCounter":
        from jellyfish_tpu_torch.parallel import ShardedMerCounter

        return ShardedMerCounter
    if name == "SequenceChunker":
        from jellyfish_tpu_torch.io.parse import SequenceChunker

        return SequenceChunker
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
