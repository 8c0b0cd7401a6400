"""Observability of the port (counterpart of ``tpu9/observability``): the
engine's latency summaries and the cold-start span names. Import the
modules themselves."""
