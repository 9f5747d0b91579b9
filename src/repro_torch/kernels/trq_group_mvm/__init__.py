from .ops import pack_scalars, trq_group_mvm, trq_group_mvm_2d
