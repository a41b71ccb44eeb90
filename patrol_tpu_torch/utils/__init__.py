"""Utilities: structured logging, profiling endpoints, histograms, flight recorder."""
