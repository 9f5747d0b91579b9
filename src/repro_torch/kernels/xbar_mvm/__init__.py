from .ops import (pack_planes, pack_scalars, pack_weight_planes, xbar_mvm,
                  xbar_mvm_2d, xbar_mvm_packed)
