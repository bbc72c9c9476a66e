"""Fault-tolerance primitives (the port of ``repro.ft``)."""
