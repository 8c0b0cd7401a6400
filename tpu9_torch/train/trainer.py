"""Training-step builders (counterpart of ``tpu9/train/trainer.py``;
baseline config #5, a LoRA fine-tune).

``build_train_step`` returns a full-parameter step and
``build_lora_train_step`` one that freezes the base model and trains the
adapters only (the optimizer's state is the size of the adapters). Both
run the decoder's no-cache forward under grad (``decoder_core``) with
each layer checkpointed when ``remat`` is on, the reference's remat on
the layer boundary: the reference checkpoints the whole forward under
``jax.checkpoint``, which computes the same values, and on torch a
checkpoint around the whole forward would keep nothing less. At
block-aligned shapes each layer's attention is the flash kernel with its
gradient (``ops.attention.FlashAttention``), so a checkpointed step runs
the kernel twice a layer: the forward and the backward's recompute.

One device: the reference's ``constrain(tokens, batch_spec)`` is the
identity there, and its ``mesh``/``param_specs`` arguments wait for the
sharded train step (ROADMAP queue A14; the serving side's rank shards,
``parallel/sharding.py``, serve only). Steps are
functional, as the reference's jitted ones are: they return new trees
and leave their inputs as they were.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..models import lora as lora_lib
from ..models.transformer import DecoderConfig, decoder_core
from ..utils.platform import default_device
from .optim import (GradientTransformation, apply_updates, global_norm,
                    tree_leaves, tree_map)

Params = dict[str, Any]


@dataclass
class TrainState:
    params: Params
    opt_state: Any
    step: torch.Tensor


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy in f32. logits [B,T,V], tokens [B,T]; a
    ``mask`` [B,T] weighs each target by its own entry, over at least
    one."""
    targets = tokens[:, 1:].long()
    logits = logits[:, :-1].float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if mask is not None:
        m = mask[:, 1:].float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()


def _on(device: torch.device, tree: Params, what: str) -> None:
    """Every leaf of ``tree`` on ``device`` (of its type, and at its index
    where it names one, as the engine checks its params), or raise: a step
    moves no weights."""
    for leaf in tree_leaves(tree):
        if leaf.device.type != device.type or (
                device.index is not None and leaf.device.index != device.index):
            raise ValueError(f"{what} has a tensor on {leaf.device}, the "
                             f"step runs on {device}")


def _value_and_grad(loss_fn: Callable, trainable: Params, *args):
    """(loss, grads of ``trainable``): ``loss_fn(trainable, *args)`` under
    grad over leaves that share ``trainable``'s storage."""
    with torch.enable_grad():
        live = tree_map(lambda x: x.detach().requires_grad_(True), trainable)
        loss = loss_fn(live, *args)
        leaves = tree_leaves(live)
        by_id = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda x: by_id[id(x)], live)


def build_train_step(cfg: DecoderConfig, optimizer: GradientTransformation,
                     remat: bool = True, device=None) -> Callable:
    """Full-parameter step: ``step(state, tokens) -> (state, {"loss",
    "grad_norm"})``. Runs on ``device`` (default: the current CUDA device,
    raising without one; ``"cpu"`` on the CPU), where ``state`` must lie;
    ``tokens`` move there."""
    device = default_device(device)

    def loss_fn(params, tokens):
        logits = decoder_core(params, tokens, cfg, remat=remat)
        return causal_lm_loss(logits, tokens)

    def step(state: TrainState, tokens):
        _on(device, state.params, "state.params")
        tokens = torch.as_tensor(tokens, device=device)
        loss, grads = _value_and_grad(loss_fn, state.params, tokens)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = apply_updates(state.params, updates)
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1),
                {"loss": loss, "grad_norm": global_norm(grads)})

    return step


def init_train_state(params: Params,
                     optimizer: GradientTransformation) -> TrainState:
    """The optimizer's state over ``params`` and step 0, on the params'
    device."""
    device = tree_leaves(params)[0].device
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def lora_value_and_grad(cfg: DecoderConfig, scale: float = 2.0,
                        remat: bool = True) -> Callable:
    """``fn(adapters, base_params, tokens) -> (loss, grads)``: the LoRA
    step's loss over ``merge(base_params, adapters, scale)`` and its
    gradient with respect to the adapters alone."""

    def loss_fn(adapters, base_params, tokens):
        merged = lora_lib.merge(base_params, adapters, scale)
        logits = decoder_core(merged, tokens, cfg, remat=remat)
        return causal_lm_loss(logits, tokens)

    def value_and_grad(adapters, base_params, tokens):
        return _value_and_grad(loss_fn, adapters, base_params, tokens)

    return value_and_grad


def build_lora_train_step(cfg: DecoderConfig,
                          optimizer: GradientTransformation,
                          scale: float = 2.0, remat: bool = True,
                          device=None) -> Callable:
    """LoRA step: ``step(adapters, opt_state, base_params, tokens) ->
    (adapters, opt_state, {"loss"})``. Gradients reach only the adapters,
    through ``merge``; the base stays frozen. Runs on ``device`` (default:
    the current CUDA device, raising without one; ``"cpu"`` on the CPU),
    where the adapters and the base must lie; ``tokens`` move there."""
    device = default_device(device)
    value_and_grad = lora_value_and_grad(cfg, scale, remat)

    def step(adapters, opt_state, base_params, tokens):
        _on(device, adapters, "adapters")
        _on(device, base_params, "base_params")
        tokens = torch.as_tensor(tokens, device=device)
        loss, grads = value_and_grad(adapters, base_params, tokens)
        updates, opt_state = optimizer.update(grads, opt_state, adapters)
        adapters = apply_updates(adapters, updates)
        return adapters, opt_state, {"loss": loss}

    return step
