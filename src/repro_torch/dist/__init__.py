"""repro_torch.dist — logical-axis sharding on a torch ``DeviceMesh``
(``sharding``) and the process groups and row split of a meshed run
(``group``)."""
from .group import (batch_share, destroy, dp_size, gather_rows, gather_seq,
                    global_max, global_sum, init_local, seq_share,
                    split_rows)
from .sharding import (AbstractMesh, P, PartitionSpec, active_mesh, full,
                       gather_hooks, gathered, logical, param_pspecs,
                       placements, shard, use_mesh, zero1_upgrade)
