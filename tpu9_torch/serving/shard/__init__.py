"""Multi-GPU serving (counterpart of ``tpu9/serving/shard``): the topology
planner and the sharding policy objects the engine places its device
state through.

``plan`` is host arithmetic (the feasibility-priced submesh choice);
``policy`` places weights and KV state over a tp × fsdp grid of ranks.
The engine imports policies, never a layout: sharding is a policy object,
not a fork of the engine.
"""

from .plan import (Topology, TopologyPlan, candidate_topologies,
                   parse_topology, plan_topology, resolve_topology,
                   topology_from_env)
from .policy import MeshPolicy, SingleDevicePolicy, make_policy

__all__ = ["Topology", "TopologyPlan", "candidate_topologies",
           "parse_topology", "plan_topology", "resolve_topology",
           "topology_from_env", "MeshPolicy", "SingleDevicePolicy",
           "make_policy"]
