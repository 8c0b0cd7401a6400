"""LLM serving of the port: the paged continuous-batching engine and its
presets (counterpart of ``tpu9/serving``). Import the modules themselves,
e.g. ``tpu9_torch.serving.presets.load_engine``."""
