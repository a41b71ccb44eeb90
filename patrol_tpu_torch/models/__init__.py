"""Limiter state models: dense device-resident CRDT state and configs."""
