"""Launchers (counterpart of ``repro/launch``; training only so far)."""
