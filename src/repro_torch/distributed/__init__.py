"""Distributed machinery (port of ``repro/distributed``: the training
loop's straggler monitor; the sharding, collectives, shard health and
elastic resharding come with the multi-device path)."""
