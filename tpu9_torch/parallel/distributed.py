"""Multi-host wiring of the port (counterpart of
``tpu9/parallel/distributed.py``).

The tpu9 worker injects gang env as the reference injects GPU env:
``TPU9_GANG_RANK``, ``TPU9_GANG_SIZE`` and ``TPU9_COORDINATOR_ADDR`` (rank
0's ``host:port``). A multi-host workload calls :func:`initialize_multihost`
first thing, and every host joins one ``torch.distributed`` process group
spanning the gang: NCCL on the card, gloo where the caller asks for the
CPU. The env parsing is the reference's, copied (the port imports nothing
of ``tpu9``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

from ..utils.platform import default_device

log = logging.getLogger("tpu9_torch.parallel")


@dataclass(frozen=True)
class MultihostEnv:
    rank: int
    size: int
    coordinator: str

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0


def multihost_env(environ: Optional[dict] = None) -> Optional[MultihostEnv]:
    env = environ if environ is not None else os.environ
    size = int(env.get("TPU9_GANG_SIZE", "1"))
    if size <= 1:
        return None
    return MultihostEnv(rank=int(env.get("TPU9_GANG_RANK", "0")), size=size,
                        coordinator=env.get("TPU9_COORDINATOR_ADDR", ""))


def initialize_multihost(environ: Optional[dict] = None,
                         device=None) -> Optional[MultihostEnv]:
    """Join the gang's process group if gang env is present: rendezvous
    at ``tcp://<coordinator>``, world size and rank from the env. The
    backend follows ``device`` (default: the current CUDA device, raising
    without one): NCCL for CUDA, gloo for ``"cpu"``."""
    info = multihost_env(environ)
    if info is None:
        return None
    import torch.distributed as dist
    backend = "nccl" if default_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{info.coordinator}",
                            world_size=info.size, rank=info.rank)
    log.info("joined multihost job rank=%d/%d coordinator=%s backend=%s",
             info.rank, info.size, info.coordinator, backend)
    return info
