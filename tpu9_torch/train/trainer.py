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
block-aligned shapes each layer's attention is
``ops.attention.FlashAttention``: the flash kernel forward, which saves
each row's log-sum-exp, and the hand-written backward kernel
(``csrc/flash_attention_backward.cu``), so a checkpointed step runs the
forward kernel twice a layer (the forward and the backward's recompute)
and the backward kernel once.

Sharding comes from the inputs, as in the reference: ``init_train_state
(params, opt, mesh, param_specs)`` (or ``parallel.shard_params``) places
the params on a mesh, and the steps take state so placed. One process
drives the mesh (single-controller): a decoder's rank shards run rank by
rank (``models/transformer.py``), each layer's fsdp pieces gathered inside
its checkpoint; the gradient reaches every piece through the copies, and
the optimizer's state is sharded as the params are. The batch stays whole
on rank 0's device: the reference's ``constrain(tokens, P(("dp",
"fsdp"), None))`` is a layout hint here (it checks the axes under a mesh
context), and dp adds no rows of its own, so the loss is the whole
batch's mean and a MoE layer's router sees the whole batch's tokens, as
the reference's capacity does (ROADMAP C10). Steps are functional, as
the reference's jitted ones are: they return new trees and leave their
inputs as they were.

Each built step times itself (``observability/spans.py``, ``step.spans``):
``train.forward`` (the merge, the forward, the loss), ``train.backward``
(the gradient and ``sum_replicas``) and ``train.update`` (the optimizer and
``apply_updates``) are each a host phase and a device unit between two
timing events, and each step leaves one row with both, closed by the
update. A step resolves the units of earlier steps that the device has
passed as it begins, never waiting; ``spans.last("train")`` reaches the
newest step's recorder once the step is gone.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..models import lora as lora_lib
from ..models.transformer import DecoderConfig, decoder_core
from ..observability.spans import SpanRecorder
from ..parallel.sharding import P, constrain, placed, same_device, shard_params
from ..utils.platform import default_device
from .optim import (GradientTransformation, apply_updates, global_norm,
                    sum_replicas, tree_leaves, tree_map)

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


BATCH_SPEC = P(("dp", "fsdp"), None)


def _on(device: torch.device, tree: Params, what: str) -> None:
    """Every leaf of ``tree`` on the device it belongs on (a rank shard's
    or a piece's mesh device, any other leaf ``device``; of its type, and
    at its index where both name one, as the engine checks its params), or
    raise: a step moves no weights."""
    for path, leaf, want in placed(tree, device):
        if not same_device(leaf.device, want):
            raise ValueError(f"{what} has a tensor on {leaf.device} at "
                             f"{path!r}, the step runs it on {want}")


def _value_and_grad(loss_fn: Callable, trainable: Params, *args,
                    spans: Optional[SpanRecorder] = None):
    """(loss, grads of ``trainable``): ``loss_fn(trainable, *args)`` under
    grad over leaves that share ``trainable``'s storage (a tensor shared by
    several places is one leaf, whose gradient sums theirs). A leaf the
    loss does not read gets zeros; replicas of one value on distinct
    devices get their sum (``optim.sum_replicas``). With ``spans`` the
    forward and the backward are its ``train.forward`` and
    ``train.backward`` spans."""
    with torch.enable_grad():
        with _timed(spans, "train.forward"):
            live = tree_map(lambda x: x.detach().requires_grad_(True),
                            trainable)
            loss = loss_fn(live, *args)
        with _timed(spans, "train.backward"):
            leaves = _unique(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            by_id = {id(x): torch.zeros_like(x) if g is None else g
                     for x, g in zip(leaves, grads)}
            grads = sum_replicas(tree_map(lambda x: by_id[id(x)], live))
    return loss.detach(), grads


def _timed(spans: Optional[SpanRecorder], name: str):
    """``spans.span(name)``: a host phase and a device unit of the step
    (``observability/spans.py``), or nothing without a recorder."""
    return nullcontext() if spans is None else spans.span(name)


def _unique(tree: Params) -> list:
    seen: set = set()
    return [x for x in tree_leaves(tree)
            if id(x) not in seen and not seen.add(id(x))]


def build_train_step(cfg: DecoderConfig, optimizer: GradientTransformation,
                     remat: bool = True, device=None) -> Callable:
    """Full-parameter step: ``step(state, tokens) -> (state, {"loss",
    "grad_norm"})``. Runs on ``device`` (default: the current CUDA device,
    raising without one; ``"cpu"`` on the CPU), where ``state`` must lie
    (sharded state: each leaf on its mesh device); ``tokens`` move there.
    ``grad_norm`` counts each logical parameter once. The step times
    itself (``step.spans``, module docstring)."""
    device = default_device(device)
    spans = SpanRecorder("train", device)

    def loss_fn(params, tokens):
        logits = decoder_core(params, tokens, cfg, remat=remat)
        return causal_lm_loss(logits, tokens)

    def step(state: TrainState, tokens):
        spans.resolve()
        _on(device, state.params, "state.params")
        tokens = constrain(torch.as_tensor(tokens, device=device),
                           BATCH_SPEC)
        loss, grads = _value_and_grad(loss_fn, state.params, tokens,
                                      spans=spans)
        with spans.span("train.update", row=(1, "full")):
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            params = apply_updates(state.params, updates)
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1),
                {"loss": loss, "grad_norm": global_norm(grads)})

    step.spans = spans
    return step


def init_train_state(params: Params, optimizer: GradientTransformation,
                     mesh=None, param_specs: Optional[Params] = None
                     ) -> TrainState:
    """The optimizer's state over ``params`` and step 0, on the params'
    (first) device; with ``mesh`` and ``param_specs`` the params are first
    placed on the mesh (``parallel.shard_params``), and the state is
    sharded as they are."""
    if mesh is not None and param_specs is not None:
        params = shard_params(params, mesh, param_specs)
    device = tree_leaves(params)[0].device
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def lora_value_and_grad(cfg: DecoderConfig, scale: float = 2.0,
                        remat: bool = True) -> Callable:
    """``fn(adapters, base_params, tokens, spans=None) -> (loss, grads)``:
    the LoRA step's loss over ``merge(base_params, adapters, scale)`` and
    its gradient with respect to the adapters alone (``spans``: a step's
    recorder, which times the forward and the backward)."""

    def loss_fn(adapters, base_params, tokens):
        merged = lora_lib.merge(base_params, adapters, scale)
        logits = decoder_core(merged, tokens, cfg, remat=remat)
        return causal_lm_loss(logits, tokens)

    def value_and_grad(adapters, base_params, tokens, spans=None):
        return _value_and_grad(loss_fn, adapters, base_params, tokens,
                               spans=spans)

    return value_and_grad


def build_lora_train_step(cfg: DecoderConfig,
                          optimizer: GradientTransformation,
                          scale: float = 2.0, remat: bool = True,
                          device=None) -> Callable:
    """LoRA step: ``step(adapters, opt_state, base_params, tokens) ->
    (adapters, opt_state, {"loss"})``. Gradients reach only the adapters,
    through ``merge``; the base stays frozen. Runs on ``device`` (default:
    the current CUDA device, raising without one; ``"cpu"`` on the CPU),
    where the adapters and the base must lie (sharded ones: each leaf on
    its mesh device); ``tokens`` move there. The step times itself
    (``step.spans``, module docstring)."""
    device = default_device(device)
    value_and_grad = lora_value_and_grad(cfg, scale, remat)
    spans = SpanRecorder("train", device)

    def step(adapters, opt_state, base_params, tokens):
        spans.resolve()
        _on(device, adapters, "adapters")
        _on(device, base_params, "base_params")
        tokens = constrain(torch.as_tensor(tokens, device=device),
                           BATCH_SPEC)
        loss, grads = value_and_grad(adapters, base_params, tokens, spans)
        with spans.span("train.update", row=(1, "lora")):
            updates, opt_state = optimizer.update(grads, opt_state, adapters)
            adapters = apply_updates(adapters, updates)
        return adapters, opt_state, {"loss": loss}

    step.spans = spans
    return step
