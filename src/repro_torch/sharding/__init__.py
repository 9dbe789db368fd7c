"""Sharding rules: which mesh axis each dim of a parameter, cache or batch
goes over (counterpart of ``repro.sharding``)."""
