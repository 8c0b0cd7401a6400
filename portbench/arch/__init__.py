"""One module per architecture: everything of the benchmark that depends on
the model. A configuration file names its module under ``"architecture"``
(``portbench/arch/<name>.py``) and the module's plain reference under
``"reference"`` (the module's ``REFERENCE``). The harness reaches the
model, its weights, the port's ``DecoderConfig``, the reference and the
counts the readers need only through that module, so a new architecture
is a new module, a new reference and a new configuration file.

A module gives, for serving (``SERVING``):

- ``REFERENCE``: the path of its plain float32 reference, from the root;
- ``model_from_config(conf)``: the model's sizes, an object with ``name``
  and ``vocab_size``; it refuses a configuration it cannot run;
- ``draw_weights(model, seed, device, dtype=torch.bfloat16)``: every
  weight, drawn from ``seed`` on ``device`` in the port's tree;
- ``decoder_config(conf, model)``: the port's ``DecoderConfig``;
- ``forward_logits(model, weights, tokens, weight=as_f32,
  positions=None)``: the reference's float32 logits [T, V] (of the rows
  ``positions`` selects), each stored matrix mapped by ``weight``;
- ``window_flops(model, k, lens)``: the model FLOPs of a decode window
  of ``k`` steps over live lanes of lengths ``lens`` at its dispatch;
- ``admission_flops(model, tokens, cached)``: those of an admission of a
  ``tokens``-token prompt of which ``cached`` were cached, with its first
  token's head row;
- ``decode_attention_calls(model, steps)``: kernel B1's calls in
  ``steps`` decode steps;
- ``decode_attention_bytes(model, lengths)``: the least bytes those calls
  of one step move, its live lanes attending ``lengths`` positions;

and, for a configuration that a training cell names (``TRAINING``):

- ``draw_adapters(model, targets, rank, seed, device)``: the LoRA
  adapters of the ``targets`` projections;
- ``lora_steps(model, weights, adapters, batches, scale, lr,
  weight_decay, weight=as_f32)``: the LoRA reference's AdamW steps (each
  step's loss, each leaf's first gradient and change, by
  ``reference.shared.leaves`` path);
- ``lora_step_flops(model, batch, t)``: the model FLOPs of one LoRA step;
- ``train_attention_calls(model, steps)``: kernel B3's forward launches in
  ``steps`` steps;
- ``train_attention_bound_s(model, batch, t, steps)``: the least time of
  B3's forward and backward calls in ``steps`` steps."""

from __future__ import annotations

import importlib
import re
from types import ModuleType

SERVING = ("REFERENCE", "model_from_config", "draw_weights",
           "decoder_config", "forward_logits", "window_flops",
           "admission_flops", "decode_attention_calls",
           "decode_attention_bytes")
TRAINING = ("draw_adapters", "lora_steps", "lora_step_flops",
            "train_attention_calls", "train_attention_bound_s")
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def of(conf: dict) -> ModuleType:
    """The module that a configuration names under ``"architecture"``;
    a configuration that names none, or a module that does not exist, is
    an error."""
    name = conf.get("architecture")
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"{conf.get('name')}: the configuration names no "
                         f"architecture module (\"architecture\": {name!r})")
    module = f"{__name__}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as exc:
        if exc.name != module:
            raise
        raise ValueError(f"{conf.get('name')}: no architecture module "
                         f"{name!r} (portbench/arch/{name}.py)") from None
