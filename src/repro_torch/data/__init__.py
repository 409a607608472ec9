"""Trace token realisation."""
