"""Parallelism of the port (counterpart of ``tpu9/parallel``): device
meshes (``mesh.py``), sharding rules and the rank shards of the decoder
(``sharding.py``), ring attention (``ring.py``), the GPipe pipeline
(``pipeline.py``) and multi-host wiring (``distributed.py``). One process
drives a mesh's devices (single-controller): a collective is a copy
between them, and autograd runs through the copies."""

from .distributed import MultihostEnv, initialize_multihost, multihost_env
from .mesh import Mesh, MeshAxes, make_mesh, make_named_mesh, mesh_for_spec
from .pipeline import pipeline_forward, stack_layers, stage_specs
from .ring import ring_attention
from .sharding import (P, Pieces, RankLayout, RankParams, Ranked, constrain,
                       decoder_param_specs, fit_spec, fsdp_specs, gather_leaf,
                       per_rank, rank_layout, ranks, reduce_partials,
                       replicate_specs, shard_decoder, shard_params,
                       shard_part, tree_parts)

__all__ = ["make_mesh", "make_named_mesh", "mesh_for_spec", "MeshAxes",
           "pipeline_forward", "stack_layers", "stage_specs",
           "decoder_param_specs",
           "fsdp_specs", "shard_params", "constrain", "replicate_specs",
           "fit_spec",
           "ring_attention", "multihost_env", "initialize_multihost",
           "Mesh", "MultihostEnv",
           "P", "Pieces", "RankLayout", "RankParams", "Ranked",
           "gather_leaf", "per_rank", "rank_layout", "ranks",
           "reduce_partials", "shard_decoder", "shard_part", "tree_parts"]
