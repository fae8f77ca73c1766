"""Distributed machinery (port of ``repro/distributed``): the in-process
device mesh, its collectives and the training mesh's gradient all-reduce
(:mod:`.collectives`), the straggler monitor and shard health
(:mod:`.fault`).

``compat.py`` and ``sharding.py`` are not ported.  They adapt the JAX
SPMD API: ``compat`` spells ``shard_map`` and ``make_mesh`` for two
jaxlib versions, ``sharding`` maps logical axis names to mesh axes and
annotates tensors for the GSPMD partitioner.  The port has no
partitioner to annotate for: a :class:`.collectives.Mesh` runs a body
once per position and its :class:`.collectives.Position` gives the
named-axis collectives, and :class:`.collectives.Split` places a leading
axis over mesh positions where the reference uses a ``NamedSharding``.
"""
