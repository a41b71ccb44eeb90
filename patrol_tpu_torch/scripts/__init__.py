"""Probes of the port on the card: the counterparts of the repository's
``scripts/`` probes that reach a TPU kernel."""
