"""Counting over several devices of one process (`count -d N`)."""

from jellyfish_tpu_torch.parallel.sharded import ShardedMerCounter, make_mesh

__all__ = ["ShardedMerCounter", "make_mesh"]
