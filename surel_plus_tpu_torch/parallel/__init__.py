"""Multi-device training, scoring and sampling over torch.distributed
(port of surel_plus_tpu/parallel/): the (data, graph) mesh (`mesh`), the
row-sharded stores and the distributed steps (`dist`), the partitioned
samplers (`partition`), the rank launcher (`launch`) and the dry run
(`dryrun`)."""

from surel_plus_tpu_torch.parallel.dist import (
    DistributedTrainStep,
    shard_spg,
)
from surel_plus_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh", "shard_spg", "DistributedTrainStep"]
