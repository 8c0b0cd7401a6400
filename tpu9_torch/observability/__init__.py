"""Observability of the port (counterpart of ``tpu9/observability``): the
engine's latency summaries. Import the modules themselves."""
