"""Shared utilities: logging, timers, npy writing."""
