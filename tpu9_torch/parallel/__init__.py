"""Model parallelism of the port (counterpart of ``tpu9/parallel``): the
decoder's layout table and its slicing into tp × fsdp rank shards
(``sharding.py``)."""

from .sharding import (P, Pieces, RankLayout, RankParams, Ranked,
                       decoder_param_specs, fit_spec, gather_leaf,
                       per_rank, rank_layout, ranks, reduce_partials,
                       shard_params, shard_part, tree_parts)

__all__ = ["P", "Pieces", "RankLayout", "RankParams", "Ranked",
           "decoder_param_specs", "fit_spec", "gather_leaf", "per_rank",
           "rank_layout", "ranks", "reduce_partials", "shard_params",
           "shard_part", "tree_parts"]
