"""Sharding of the port: the logical-axis rules (a copy of
``repro/sharding``) and the collectives its multi-device paths call."""

from repro_torch.sharding.rules import (DEFAULT_RULES, RULES_SEQ_PARALLEL,
                                        NamedSharding, local_slice,
                                        logical_sharding,
                                        logical_to_mesh_axes,
                                        param_shardings, set_rules_for_mesh,
                                        shard_shape)

__all__ = ["DEFAULT_RULES", "RULES_SEQ_PARALLEL", "NamedSharding",
           "local_slice", "logical_sharding", "logical_to_mesh_axes",
           "param_shardings", "set_rules_for_mesh", "shard_shape"]
