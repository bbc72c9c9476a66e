"""Experiment configurations of the port (``bohm_workloads``)."""
