"""Mesh serving: the (replicas × shards) block layout on one card, its host routing, and the converge."""
