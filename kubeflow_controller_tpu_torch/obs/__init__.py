"""Observability vocabulary the port's workloads report with."""
