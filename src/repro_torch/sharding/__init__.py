from repro_torch.sharding.policies import (P, MeshSharding, named_sharding_tree,
                                           promote_fsdp, replicated, to_shardings)

__all__ = ["P", "MeshSharding", "promote_fsdp", "named_sharding_tree", "to_shardings",
           "replicated"]
