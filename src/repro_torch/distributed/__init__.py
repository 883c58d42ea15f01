"""Sharding of the port's params and caches over a device mesh."""
