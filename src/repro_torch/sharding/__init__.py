"""Sharding rules of the port: logical axis names to mesh axes, as
data (`rules`)."""
