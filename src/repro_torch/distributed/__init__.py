"""Distributed machinery (port of ``repro/distributed``): the in-process
device mesh and its collectives (:mod:`.collectives`), the straggler
monitor and shard health (:mod:`.fault`).  The training mesh's gradient
all-reduce and elastic resharding come with ROADMAP.md A4b."""
