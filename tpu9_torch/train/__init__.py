"""Training for the port (counterpart of ``tpu9/train``)."""

from .trainer import (TrainState, build_lora_train_step, build_train_step,
                      causal_lm_loss)

__all__ = ["TrainState", "build_train_step", "causal_lm_loss",
           "build_lora_train_step"]
