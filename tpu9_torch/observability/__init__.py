"""Observability of the port (counterpart of ``tpu9/observability``): the
engine's latency summaries, the cold-start span names, and the span
recorder with which the serve loop and the train steps time themselves.
Import the modules themselves."""
