"""Network layer: the HTTP API front (UDP replication is not part of this package yet)."""
