"""Distribution layer on torch.distributed (port of loc_lib_tpu/parallel):
device meshes and the collectives, the multi-process entry, the
distributed matchers, the slab-sharded maps and the edge-sharded pose
graph.

One process per rank. Every rank runs the same host program on the same
replicated inputs; a rank takes its own block of source rows ("dp") and
builds only its own map slab ("mp"). The collectives are `all_reduce`
SUM and MIN (NCCL between cards, gloo on the CPU and for several ranks on
one card), so every rank gets the same bits and takes the same host
branches.
"""
