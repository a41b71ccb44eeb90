"""Host runtime: bucket directory, device engine, repos (host and device)."""
